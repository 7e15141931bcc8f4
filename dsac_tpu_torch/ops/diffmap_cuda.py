"""The reprojection-error surface and fused soft-inlier scoring: the CUDA
kernels (csrc/diffmap.cu, csrc/score.cu) and their plain PyTorch versions.

Ports of dsac_tpu/ops/diffmap_pallas.py:diffmaps_pallas and
soft_inlier_scores_pallas, with a leading frame axis: each frame has its
own pixels and coordinates, and one launch serves every hypothesis of
every frame.  Each wrapper counts its kernel launches in its
``launches`` attribute.
"""

from __future__ import annotations

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.ops import _build
from dsac_tpu_torch.ops.diffmap import diffmaps as diffmaps_plain
from dsac_tpu_torch.ops.diffmap import soft_inlier_scores as _from_diffmaps


def diffmaps_ref(R: torch.Tensor, t: torch.Tensor, coords: torch.Tensor,
                 pix: torch.Tensor, cam: Camera, max_error: float = 100.0
                 ) -> torch.Tensor:
    """Plain version: ops/diffmap.py:diffmaps."""
    return diffmaps_plain(Pose(R, t), coords, pix, cam, max_error)


def diffmaps(R: torch.Tensor, t: torch.Tensor, coords: torch.Tensor,
             pix: torch.Tensor, cam: Camera, max_error: float = 100.0
             ) -> torch.Tensor:
    """(B, H, N) clamped reprojection errors of hypotheses R (B, H, 3, 3),
    t (B, H, 3) against coords (B, N, 3) mm at pixels pix (B, N, 2)."""
    B, H, N, dev = _build.check_poses(R, t, coords, pix)
    if dev.type == "cpu":
        return diffmaps_ref(R, t, coords, pix, cam, max_error)
    out = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    _build.launch("dsac_diffmaps", dev, R.data_ptr(), t.data_ptr(),
                  coords.data_ptr(), pix.data_ptr(), B, H, N, cam.focal,
                  cam.cx, cam.cy, max_error, out.data_ptr())
    diffmaps.launches += 1
    return out


diffmaps.launches = 0


def soft_inlier_scores_ref(R: torch.Tensor, t: torch.Tensor,
                           coords: torch.Tensor, pix: torch.Tensor,
                           cam: Camera, threshold: float = 10.0,
                           beta: float = 10.0, max_error: float = 100.0
                           ) -> torch.Tensor:
    """Plain version: the (B, H, N) error surface, then the soft count."""
    return _from_diffmaps(diffmaps_ref(R, t, coords, pix, cam, max_error),
                          threshold, beta)


def soft_inlier_scores(R: torch.Tensor, t: torch.Tensor,
                       coords: torch.Tensor, pix: torch.Tensor, cam: Camera,
                       threshold: float = 10.0, beta: float = 10.0,
                       max_error: float = 100.0) -> torch.Tensor:
    """(B, H) soft inlier counts of hypotheses R (B, H, 3, 3), t (B, H, 3)
    against coords (B, N, 3) mm at pixels pix (B, N, 2)."""
    B, H, N, dev = _build.check_poses(R, t, coords, pix)
    if dev.type == "cpu":
        return soft_inlier_scores_ref(R, t, coords, pix, cam, threshold,
                                      beta, max_error)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    _build.launch("dsac_soft_inlier_scores", dev, R.data_ptr(),
                  t.data_ptr(), coords.data_ptr(), pix.data_ptr(), B, H, N,
                  cam.focal, cam.cx, cam.cy, threshold, 1.0 / beta,
                  max_error, out.data_ptr())
    soft_inlier_scores.launches += 1
    return out


soft_inlier_scores.launches = 0
