"""Rigid 6-DoF poses (port of dsac_tpu/geometry/pose.py).

``eye = R @ x + t`` maps scene coordinates (mm) into the camera frame of
the reference's internal convention (x right, y up, z = -depth).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsac_tpu_torch.geometry.rotation import so3_exp, so3_log


class Pose(NamedTuple):
    """R: (..., 3, 3) rotation, t: (..., 3) translation (mm)."""

    R: torch.Tensor
    t: torch.Tensor


def identity_pose(batch_shape: tuple = (), dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cpu") -> Pose:
    """Identity poses of the given batch shape."""
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    return Pose(R, torch.zeros((*batch_shape, 3), dtype=dtype,
                               device=device))


def compose(a: Pose, b: Pose) -> Pose:
    """a after b: (a * b)(x) = a(b(x))."""
    return Pose(a.R @ b.R, (a.R @ b.t[..., None])[..., 0] + a.t)


def invert(p: Pose) -> Pose:
    """Inverse transform (scene pose <-> camera pose)."""
    Rt = p.R.transpose(-1, -2)
    return Pose(Rt, -(Rt @ p.t[..., None])[..., 0])


def transform(p: Pose, x: torch.Tensor) -> torch.Tensor:
    """Apply a pose to points: x (..., N, 3) or (..., 3)."""
    if x.dim() >= 2 and x.shape[-2] != 3:
        return x @ p.R.transpose(-1, -2) + p.t[..., None, :]
    return (p.R @ x[..., None])[..., 0] + p.t


def pose_to_vec6(p: Pose) -> torch.Tensor:
    """Pose -> (Rodrigues vector, t) 6-vector (..., 6)."""
    return torch.cat([so3_log(p.R), p.t], dim=-1)


def pose_from_vec6(v: torch.Tensor) -> Pose:
    """(Rodrigues vector, t) 6-vector (..., 6) -> Pose."""
    return Pose(so3_exp(v[..., :3]), v[..., 3:])
