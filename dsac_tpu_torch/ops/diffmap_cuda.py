"""Fused soft-inlier scoring: the CUDA kernel (csrc/score.cu) and its
plain PyTorch version.

Port of dsac_tpu/ops/diffmap_pallas.py:soft_inlier_scores_pallas, with a
leading frame axis: each frame has its own pixels and coordinates, and one
launch scores every hypothesis of every frame.  ``soft_inlier_scores``
counts its kernel launches in ``soft_inlier_scores.launches``.
"""

from __future__ import annotations

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.ops import _build
from dsac_tpu_torch.ops.diffmap import diffmaps
from dsac_tpu_torch.ops.diffmap import soft_inlier_scores as _from_diffmaps


def soft_inlier_scores_ref(R: torch.Tensor, t: torch.Tensor,
                           coords: torch.Tensor, pix: torch.Tensor,
                           cam: Camera, threshold: float = 10.0,
                           beta: float = 10.0, max_error: float = 100.0
                           ) -> torch.Tensor:
    """Plain version: the (B, H, N) error surface, then the soft count."""
    dm = diffmaps(Pose(R, t), coords, pix, cam, max_error)
    return _from_diffmaps(dm, threshold, beta)


def soft_inlier_scores(R: torch.Tensor, t: torch.Tensor,
                       coords: torch.Tensor, pix: torch.Tensor, cam: Camera,
                       threshold: float = 10.0, beta: float = 10.0,
                       max_error: float = 100.0) -> torch.Tensor:
    """(B, H) soft inlier counts of hypotheses R (B, H, 3, 3), t (B, H, 3)
    against coords (B, N, 3) mm at pixels pix (B, N, 2)."""
    B, H = t.shape[:2]
    N = coords.shape[1]
    dev = t.device
    _build.check("R", R, (B, H, 3, 3), dev)
    _build.check("t", t, (B, H, 3), dev)
    _build.check("coords", coords, (B, N, 3), dev)
    _build.check("pix", pix, (B, N, 2), dev)
    if dev.type == "cpu":
        return soft_inlier_scores_ref(R, t, coords, pix, cam, threshold,
                                      beta, max_error)
    if dev.type != "cuda":
        raise ValueError(f"soft_inlier_scores runs on cuda or cpu, not {dev}")
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    _build.launch("dsac_soft_inlier_scores", R.data_ptr(), t.data_ptr(),
                  coords.data_ptr(), pix.data_ptr(), B, H, N, cam.focal,
                  cam.cx, cam.cy, threshold, 1.0 / beta, max_error,
                  out.data_ptr(), _build.stream_of(t))
    soft_inlier_scores.launches += 1
    return out


soft_inlier_scores.launches = 0
