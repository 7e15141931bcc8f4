"""Training logs in the reference's text layout (port of
dsac_tpu/utils/logging.py: TrainingLog and the console colours)."""

from __future__ import annotations

from pathlib import Path


def blue(s: str) -> str:
    return f"\033[34m{s}\033[0m"


def green(s: str) -> str:
    return f"\033[32m{s}\033[0m"


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
