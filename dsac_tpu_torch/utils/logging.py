"""Training and evaluation logs in the reference's text layout (port of
dsac_tpu/utils/logging.py: TrainingLog, TestLog and the console
colours)."""

from __future__ import annotations

from pathlib import Path


def blue(s: str) -> str:
    return f"\033[34m{s}\033[0m"


def green(s: str) -> str:
    return f"\033[32m{s}\033[0m"


def red(s: str) -> str:
    return f"\033[31m{s}\033[0m"


def yellow(s: str) -> str:
    return f"\033[33m{s}\033[0m"


class TrainingLog:
    """Per-round training loss file: ``<round> <loss> [extra ...]`` per
    line (train_ransac.cpp:403-407 layout), appended and flushed."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def append(self, round_idx: int, loss: float,
               extra: dict | None = None) -> None:
        cols = [str(round_idx), f"{loss:.6f}"]
        if extra:
            cols += [f"{v:.6f}" for v in extra.values()]
        self._f.write(" ".join(cols) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TestLog:
    """Per-frame evaluation file and summary of test_ransac
    (logging.py:52-101; test_ransac.cpp:91-102, 221-233, 265-273).

    ``ransac_pose_errors_{tag}.txt`` has one line per frame of 11
    columns: expected loss over the pool, entropy of the scores, loss of
    the selected hypothesis, translation error (mm), rotation error (deg),
    and the estimated pose as ``pose_to_7scenes_vec6`` gives it (Rodrigues
    vector, translation in metres).  ``ransac_summary_{tag}.txt`` has one
    line: accuracy, mean and std of the expected loss, mean and std of the
    entropy, median rotation error (deg), median translation error (cm).
    """

    __test__ = False  # not a pytest class

    def __init__(self, out_dir: str | Path, tag: str):
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.err_path = out / f"ransac_pose_errors_{tag}.txt"
        self.summary_path = out / f"ransac_summary_{tag}.txt"
        self._f = open(self.err_path, "w")

    def frame(self, expected_loss: float, entropy: float, loss: float,
              trans_err_mm: float, rot_err_deg: float,
              pose_vec6=None) -> None:
        cols = [expected_loss, entropy, loss, trans_err_mm, rot_err_deg]
        if pose_vec6 is not None:
            cols += [float(v) for v in pose_vec6]
        self._f.write(" ".join(f"{c:.6f}" for c in cols) + "\n")
        self._f.flush()

    def summary(self, stats: dict) -> None:
        with open(self.summary_path, "w") as f:
            f.write(f"{stats['accuracy_5cm5deg']:.6f} "
                    f"{stats.get('mean_expected_loss', 0.0):.6f} "
                    f"{stats.get('std_expected_loss', 0.0):.6f} "
                    f"{stats.get('mean_entropy_bits', 0.0):.6f} "
                    f"{stats.get('std_entropy_bits', 0.0):.6f} "
                    f"{stats['median_rot_err_deg']:.6f} "
                    f"{stats['median_trans_err_cm']:.6f}\n")

    def close(self) -> None:
        self._f.close()
