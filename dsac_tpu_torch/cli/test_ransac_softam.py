"""Soft-argmax evaluation over the fixture frames (port of
dsac_tpu/cli/test_ransac_softam.py): test_ransac with ``--softam``.

    python -m dsac_tpu_torch.cli.test_ransac_softam --fused-refine
"""

from dsac_tpu_torch.cli.test_ransac import main as _main


def main(argv=None) -> dict:
    return _main(argv, softam=True)


if __name__ == "__main__":
    main()
