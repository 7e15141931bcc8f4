"""Training-state snapshots on ``torch.save`` (port of
dsac_tpu/utils/checkpoint.py).

A snapshot is any picklable state (parameters, optimizer states, the
round count) under ``directory/name/<step>.pt``; the newest ``keep``
steps are kept.  Writes are atomic: a snapshot is written to a temporary
file and renamed, so that a run killed mid-write leaves the previous
snapshot whole.  The reference's fixed model names (properties.cpp:69-70)
name the snapshots.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch

OBJ_INIT = "obj_model_init"
SCORE_INIT = "score_model_init"
OBJ_E2E = "obj_model_endtoend"
SCORE_E2E = "score_model_endtoend"
OBJ_SOFTAM = "obj_model_softam_endtoend"
SCORE_SOFTAM = "score_model_softam_endtoend"


def _steps(path: Path) -> list[int]:
    if not path.is_dir():
        return []
    return sorted(int(f.stem) for f in path.glob("*.pt") if f.stem.isdigit())


def save(directory: str | Path, name: str, state: Any,
         step: int | None = None, keep: int = 3) -> Path:
    """Snapshot ``state`` as step ``step`` (0 when None) of ``name``;
    returns the file written."""
    path = Path(directory) / name
    path.mkdir(parents=True, exist_ok=True)
    out = path / f"{0 if step is None else int(step)}.pt"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, out)
    for old in _steps(path)[:-keep]:
        (path / f"{old}.pt").unlink()
    return out


def latest_step(directory: str | Path, name: str) -> int | None:
    steps = _steps(Path(directory) / name)
    return steps[-1] if steps else None


def restore(directory: str | Path, name: str, step: int | None = None,
            map_location: str | torch.device = "cpu") -> Any:
    """The newest (or the given) snapshot of ``name``; raises
    FileNotFoundError when there is none.  Snapshots are this program's
    own files, so they are unpickled in full."""
    step = latest_step(directory, name) if step is None else step
    path = Path(directory) / name / f"{step}.pt"
    if step is None or not path.exists():
        raise FileNotFoundError(
            f"no checkpoint under {Path(directory) / name}")
    return torch.load(path, map_location=map_location, weights_only=False)
