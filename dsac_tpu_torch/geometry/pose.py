"""Rigid 6-DoF poses (port of dsac_tpu/geometry/pose.py).

``eye = R @ x + t`` maps scene coordinates (mm) into the camera frame of
the reference's internal convention (x right, y up, z = -depth).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pose(NamedTuple):
    """R: (..., 3, 3) rotation, t: (..., 3) translation (mm)."""

    R: torch.Tensor
    t: torch.Tensor


def invert(p: Pose) -> Pose:
    """Inverse transform (scene pose <-> camera pose)."""
    Rt = p.R.transpose(-1, -2)
    return Pose(Rt, -(Rt @ p.t[..., None])[..., 0])


def transform(p: Pose, x: torch.Tensor) -> torch.Tensor:
    """Apply a pose to points: x (..., N, 3) or (..., 3)."""
    if x.dim() >= 2 and x.shape[-2] != 3:
        return x @ p.R.transpose(-1, -2) + p.t[..., None, :]
    return (p.R @ x[..., None])[..., 0] + p.t
