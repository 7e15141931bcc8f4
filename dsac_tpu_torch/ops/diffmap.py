"""Dense reprojection-error surface and the soft-inlier scoring head
(port of dsac_tpu/ops/diffmap.py); together the plain version of the
score kernel (ops/diffmap_cuda.py)."""

from __future__ import annotations

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose

_EPS = 1e-8


def diffmaps(hyps: Pose, coords: torch.Tensor, pix: torch.Tensor,
             cam: Camera, max_error: float = 100.0) -> torch.Tensor:
    """Clamped reprojection errors of every (hypothesis, pixel) pair.

    hyps: batch (..., H); coords (..., N, 3) mm; pix (..., N, 2).
    Returns (..., H, N).
    """
    eye = (hyps.R @ coords[..., None, :, :].transpose(-1, -2)
           + hyps.t[..., :, None])  # (..., H, 3, N)
    z = eye[..., 2, :]
    z_safe = torch.where(torch.abs(z) < _EPS, -_EPS, z)
    u = -cam.focal * eye[..., 0, :] / z_safe + cam.cx
    v = cam.focal * eye[..., 1, :] / z_safe + cam.cy
    du = pix[..., None, :, 0] - u
    dv = pix[..., None, :, 1] - v
    err = torch.sqrt(du * du + dv * dv + _EPS)
    return torch.clamp(err, max=max_error)


def soft_inlier_scores(dmaps: torch.Tensor, threshold: float,
                       beta: float) -> torch.Tensor:
    """Soft inlier count per hypothesis: (..., H, N) -> (..., H)."""
    return torch.sum(torch.sigmoid((threshold - dmaps) / beta), dim=-1)
