"""End-to-end soft-argmax training on one GPU (port of
dsac_tpu/cli/train_ransac_softam.py): train_ransac with ``--softam``.  The
softmax averages the hypothesis pool, only the average is refined, and
the loss is maxLoss of the refined average (cnn_softam.h:1163).

    python -m dsac_tpu_torch.cli.train_ransac_softam --rounds 100
"""

from dsac_tpu_torch.cli.train_ransac import main as _main


def main(argv=None) -> dict:
    return _main(argv, softam=True)


if __name__ == "__main__":
    main()
