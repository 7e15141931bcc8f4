"""Pinhole projection in the reference's internal frame (port of
dsac_tpu/geometry/projection.py).

    eye = R @ x + t            (z is NEGATIVE depth)
    u = -f * eye_x / eye_z + cx    (the x-flip, projection.py:42)
    v =  f * eye_y / eye_z + cy
"""

from __future__ import annotations

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose

_EPS = 1e-8


def transform_to_eye(pose: Pose, x: torch.Tensor) -> torch.Tensor:
    """Scene points (..., N, 3) -> eye frame under pose (broadcasting)."""
    return x @ pose.R.transpose(-1, -2) + pose.t[..., None, :]


def project(pose: Pose, x: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Project scene points to pixels: (..., N, 3) -> (..., N, 2)."""
    eye = transform_to_eye(pose, x)
    z = eye[..., 2]
    z_safe = torch.where(torch.abs(z) < _EPS, _EPS, z)
    u = -cam.focal * eye[..., 0] / z_safe + cam.cx
    v = cam.focal * eye[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1)


def reprojection_errors(pose: Pose, x: torch.Tensor, pix: torch.Tensor,
                        cam: Camera, max_error: float = 100.0
                        ) -> torch.Tensor:
    """Clamped reprojection error per point: (..., N)."""
    d = pix - project(pose, x, cam)
    err = torch.sqrt(torch.sum(d * d, dim=-1) + _EPS)
    return torch.clamp(err, max=max_error)
