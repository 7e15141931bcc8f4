"""IRLS pose refinement on the card: the fused refine kernel
(csrc/refine.cu), the per-step statistics kernel (csrc/irls_stats.cu), and
their plain PyTorch versions.

Ports of dsac_tpu/ops/gn_pallas.py, with a leading frame axis: poses
(B, P) refine against their own frame's coordinates.

* ``refine_pose_fused`` (<- refine_pose_fused): the whole refinement in
  one launch.  The kernel runs ``outer_steps * inner_iters`` single-GN
  IRLS steps (as dsac_tpu/pipeline/forward.py:158 sets it); the plain
  version is geometry/gn.py:refine_pose with ``outer_steps`` reweightings
  of ``inner_iters`` GN steps, which reaches the same fixed point.
* ``irls_stats`` (<- irls_stats): one pass of the 28 IRLS statistics per
  pose; ``refine_pose_fused_steps`` (<- refine_pose_fused_steps) runs one
  such launch per step and the 6x6 solve and pose update in PyTorch.  It
  is the independent check of the refine kernel: the two kernels share
  their per-pixel body (csrc/irls_stats.cuh), not their solve.

Each wrapper counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.gn import (_residuals_and_jac, refine_pose,
                                        soft_inlier_weights, solve6_cholesky)
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.rotation import so3_exp
from dsac_tpu_torch.ops import _build

_EPS = 1e-8
# rows and columns of the 21 upper-triangle JtJ entries, in the kernels'
# order (row-major)
_ROWS = [i for i in range(6) for _ in range(i, 6)]
_COLS = [j for i in range(6) for j in range(i, 6)]


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
    B, P, N, dev = _build.check_poses(R0, t0, coords, pix)
    if dev.type == "cpu":
        return refine_pose_ref(poses, coords, pix, cam, outer_steps,
                               inner_iters, threshold, beta, min_inliers,
                               damping, max_error)
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


def irls_stats_ref(R: torch.Tensor, t: torch.Tensor, coords: torch.Tensor,
                   pix: torch.Tensor, cam: Camera, threshold: float = 10.0,
                   beta: float = 1.0, max_error: float = 100.0
                   ) -> torch.Tensor:
    """Plain version: the weighted Jacobian contraction of
    geometry/gn.py:_residuals_and_jac (tests/test_gn_pallas.py:30-37)."""
    r, J = _residuals_and_jac(Pose(R, t), coords[:, None], pix[:, None], cam)
    err = torch.clamp(torch.sqrt(torch.sum(r * r, dim=-1) + _EPS),
                      max=max_error)
    w = soft_inlier_weights(err, threshold, beta)  # (B, P, N)
    JtJ = torch.einsum("...n,...nki,...nkj->...ij", w, J, J)
    Jtr = torch.einsum("...n,...nki,...nk->...i", w, J, r)
    return torch.cat([JtJ[..., _ROWS, _COLS], Jtr, w.sum(-1, keepdim=True)],
                     dim=-1)


def irls_stats(R: torch.Tensor, t: torch.Tensor, coords: torch.Tensor,
               pix: torch.Tensor, cam: Camera, threshold: float = 10.0,
               beta: float = 1.0, max_error: float = 100.0) -> torch.Tensor:
    """(B, P, 28) IRLS statistics of poses R (B, P, 3, 3), t (B, P, 3)
    against coords (B, N, 3) mm at pixels pix (B, N, 2): the 21
    upper-triangle entries of JtJ (row-major), the 6 of Jtr, and the soft
    inlier count, with soft-inlier weights and the 1 mm z-floor."""
    B, P, N, dev = _build.check_poses(R, t, coords, pix)
    if dev.type == "cpu":
        return irls_stats_ref(R, t, coords, pix, cam, threshold, beta,
                              max_error)
    out = torch.empty((B, P, 28), dtype=torch.float32, device=dev)
    _build.launch("dsac_irls_stats", R.data_ptr(), t.data_ptr(),
                  coords.data_ptr(), pix.data_ptr(), B, P, N, cam.focal,
                  cam.cx, cam.cy, max_error, threshold, 1.0 / beta,
                  out.data_ptr(), _build.stream_of(t))
    irls_stats.launches += 1
    return out


irls_stats.launches = 0


def unpack_stats(stats: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., 28) -> (JtJ (..., 6, 6), Jtr (..., 6), n_in (...))."""
    JtJ = stats.new_zeros((*stats.shape[:-1], 6, 6))
    JtJ[..., _ROWS, _COLS] = stats[..., :21]
    JtJ[..., _COLS, _ROWS] = stats[..., :21]
    return JtJ, stats[..., 21:27], stats[..., 27]


def refine_pose_fused_steps(poses: Pose, coords: torch.Tensor,
                            pix: torch.Tensor, cam: Camera, steps: int = 16,
                            threshold: float = 10.0, beta: float = 1.0,
                            min_inliers: float = 50.0, damping: float = 1e-4,
                            max_error: float = 100.0
                            ) -> tuple[Pose, torch.Tensor]:
    """IRLS refinement as ``steps`` launches of ``irls_stats``, each
    followed by the Jacobi-normalised, damped 6x6 Cholesky solve, the
    +-1e4 clip, the freeze guards and R <- exp(omega) R, t <- t + dt in
    PyTorch (gn_pallas.py:196-212).  The same steps as the refine kernel;
    returns (refined poses, soft inlier counts at the pose that entered
    the last step)."""
    p = Pose(poses.R.contiguous(), poses.t.contiguous())
    alive = torch.ones(p.t.shape[:-1], dtype=torch.bool, device=p.t.device)
    eye6 = torch.eye(6, dtype=p.t.dtype, device=p.t.device)
    n_in = None
    for _ in range(steps):
        JtJ, Jtr, n_in = unpack_stats(irls_stats(
            p.R, p.t, coords, pix, cam, threshold, beta, max_error))
        alive = alive & (n_in >= min_inliers)
        dn = torch.rsqrt(torch.diagonal(JtJ, dim1=-2, dim2=-1) + 1e-12)
        A = dn[..., :, None] * JtJ * dn[..., None, :] + (damping + 1e-6) * eye6
        delta = torch.clamp(dn * solve6_cholesky(A, dn * Jtr), -1e4, 1e4)
        keep = alive & torch.isfinite(delta).all(dim=-1)
        delta = torch.where(keep[..., None], delta, 0.0)
        p = Pose((so3_exp(delta[..., :3]) @ p.R).contiguous(),
                 (p.t + delta[..., 3:]).contiguous())
    return p, n_in
