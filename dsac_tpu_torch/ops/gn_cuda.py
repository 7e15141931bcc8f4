"""Fused IRLS pose refinement: the CUDA kernel (csrc/refine.cu) and its
plain PyTorch version.

Port of dsac_tpu/ops/gn_pallas.py:refine_pose_fused, with a leading frame
axis: poses (B, P) refine against their own frame's coordinates, all in
one launch.  The kernel runs ``outer_steps * inner_iters`` single-GN IRLS
steps (as dsac_tpu/pipeline/forward.py:158 sets it); the plain version is
geometry/gn.py:refine_pose with ``outer_steps`` reweightings of
``inner_iters`` GN steps, which reaches the same fixed point.
``refine_pose_fused`` counts its kernel launches in
``refine_pose_fused.launches``.
"""

from __future__ import annotations

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.gn import refine_pose
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.ops import _build


def refine_pose_ref(poses: Pose, coords: torch.Tensor, pix: torch.Tensor,
                    cam: Camera, outer_steps: int = 8, inner_iters: int = 2,
                    threshold: float = 10.0, beta: float = 1.0,
                    min_inliers: float = 50.0, damping: float = 1e-4,
                    max_error: float = 100.0
                    ) -> tuple[Pose, torch.Tensor]:
    """Plain version: geometry/gn.py:refine_pose over the (B, P) pool."""
    return refine_pose(poses, coords[:, None], pix[:, None], cam,
                       steps=outer_steps, inner_iters=inner_iters,
                       threshold=threshold, beta=beta,
                       min_inliers=min_inliers, damping=damping,
                       max_error=max_error)


def refine_pose_fused(poses: Pose, coords: torch.Tensor, pix: torch.Tensor,
                      cam: Camera, outer_steps: int = 8,
                      inner_iters: int = 2, threshold: float = 10.0,
                      beta: float = 1.0, min_inliers: float = 50.0,
                      damping: float = 1e-4, max_error: float = 100.0
                      ) -> tuple[Pose, torch.Tensor]:
    """Refine poses R (B, P, 3, 3), t (B, P, 3) against coords (B, N, 3)
    at pixels (B, N, 2).  Returns (refined poses, soft inlier counts (B, P)
    at the pose that entered the last step)."""
    R0, t0 = poses
    B, P = t0.shape[:2]
    N = coords.shape[1]
    dev = t0.device
    _build.check("R", R0, (B, P, 3, 3), dev)
    _build.check("t", t0, (B, P, 3), dev)
    _build.check("coords", coords, (B, N, 3), dev)
    _build.check("pix", pix, (B, N, 2), dev)
    if dev.type == "cpu":
        return refine_pose_ref(poses, coords, pix, cam, outer_steps,
                               inner_iters, threshold, beta, min_inliers,
                               damping, max_error)
    if dev.type != "cuda":
        raise ValueError(f"refine_pose_fused runs on cuda or cpu, not {dev}")
    R = torch.empty_like(R0)
    t = torch.empty_like(t0)
    n_in = torch.empty((B, P), dtype=torch.float32, device=dev)
    _build.launch("dsac_refine_pose", R0.data_ptr(), t0.data_ptr(),
                  coords.data_ptr(), pix.data_ptr(), B, P, N,
                  outer_steps * inner_iters, cam.focal, cam.cx, cam.cy,
                  max_error, threshold, 1.0 / beta, min_inliers, damping,
                  R.data_ptr(), t.data_ptr(), n_in.data_ptr(),
                  _build.stream_of(t0))
    refine_pose_fused.launches += 1
    return Pose(R, t), n_in


refine_pose_fused.launches = 0
