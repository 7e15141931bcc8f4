"""Gauss-Newton PnP and soft-inlier IRLS refinement (port of
dsac_tpu/geometry/gn.py).

``refine_pose`` is the plain version of the fused refine kernel
(ops/gn_cuda.py): the same fixed point, reached by ``steps`` reweightings
of ``inner_iters`` Gauss-Newton steps each.
"""

from __future__ import annotations

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.rotation import hat, so3_exp

_EPS = 1e-8


def solve6_cholesky(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 SPD solve by a fully unrolled Cholesky, pivots floored
    at 1e-12.  A: (..., 6, 6), b: (..., 6) -> (..., 6)."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _residuals_and_jac(pose: Pose, obj: torch.Tensor, pix: torch.Tensor,
                       cam: Camera):
    """Residual r = observed - projected (..., N, 2) and Jacobian
    d(projected)/d(omega, dt) (..., N, 2, 6) for R' = exp(omega) R,
    t' = t + dt.  Eye depths are floored at 1 mm (gn.py:78-81)."""
    rx = obj @ pose.R.transpose(-1, -2)  # R @ x
    eye = rx + pose.t[..., None, :]
    z = eye[..., 2]
    sign = torch.where(z > 0, 1.0, -1.0)
    z_safe = torch.where(torch.abs(z) < 1.0, sign, z)
    inv_z = 1.0 / z_safe
    f = cam.focal

    u = -f * eye[..., 0] * inv_z + cam.cx
    v = f * eye[..., 1] * inv_z + cam.cy
    r = pix - torch.stack([u, v], dim=-1)

    zeros = torch.zeros_like(z)
    du_de = torch.stack([-f * inv_z, zeros, f * eye[..., 0] * inv_z * inv_z],
                        dim=-1)
    dv_de = torch.stack([zeros, f * inv_z, -f * eye[..., 1] * inv_z * inv_z],
                        dim=-1)
    duv_de = torch.stack([du_de, dv_de], dim=-2)  # (..., N, 2, 3)

    de_dw = -hat(rx)  # (..., N, 3, 3)
    de_dt = torch.eye(3, dtype=obj.dtype, device=obj.device).expand(
        de_dw.shape)
    de_dp = torch.cat([de_dw, de_dt], dim=-1)  # (..., N, 3, 6)
    return r, duv_de @ de_dp


def gn_pnp(pose: Pose, obj: torch.Tensor, pix: torch.Tensor,
           weights: torch.Tensor, cam: Camera, iters: int = 4,
           damping: float = 1e-4) -> Pose:
    """Weighted, Jacobi-normalised, damped Gauss-Newton PnP; non-finite
    steps are rejected (the pose stays)."""
    p = pose
    eye6 = torch.eye(6, dtype=obj.dtype, device=obj.device)
    for _ in range(iters):
        r, J = _residuals_and_jac(p, obj, pix, cam)
        wJ = weights[..., None, None] * J
        JtJ = torch.einsum("...nki,...nkj->...ij", wJ, J)
        Jtr = torch.einsum("...nki,...nk->...i", wJ, r)
        diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
        dn = torch.rsqrt(diag + 1e-12)
        A = dn[..., :, None] * JtJ * dn[..., None, :]
        A = A + (damping + 1e-6) * eye6
        y = solve6_cholesky(A, dn * Jtr)
        delta = torch.clamp(dn * y, -1e4, 1e4)
        ok = torch.all(torch.isfinite(delta), dim=-1, keepdim=True)
        delta = torch.where(ok, delta, 0.0)
        p = Pose(so3_exp(delta[..., :3]) @ p.R, p.t + delta[..., 3:])
    return p


def soft_inlier_weights(errors: torch.Tensor, threshold: float,
                        beta: float) -> torch.Tensor:
    """sigmoid((tau - r) / beta), the soft inlier test."""
    return torch.sigmoid((threshold - errors) / beta)


def refine_pose(pose: Pose, obj: torch.Tensor, pix: torch.Tensor,
                cam: Camera, steps: int = 8, inner_iters: int = 2,
                threshold: float = 10.0, beta: float = 1.0,
                min_inliers: float = 50.0, damping: float = 1e-4,
                max_error: float = 100.0) -> tuple[Pose, torch.Tensor]:
    """Iteratively reweighted refinement of a batch of poses.

    Per outer step: errors -> soft inlier weights -> ``inner_iters`` GN
    steps.  A pose freezes for good once its soft inlier mass falls below
    ``min_inliers``.  Returns (refined pose, soft inlier count at the pose
    that entered the last step).
    """
    p = pose
    alive = torch.ones(pose.t.shape[:-1], dtype=torch.bool,
                       device=pose.t.device)
    n_in = None
    for _ in range(steps):
        r, _J = _residuals_and_jac(p, obj, pix, cam)
        err = torch.clamp(torch.sqrt(torch.sum(r * r, dim=-1) + _EPS),
                          max=max_error)
        w = soft_inlier_weights(err, threshold, beta)
        n_in = torch.sum(w, dim=-1)
        alive = alive & (n_in >= min_inliers)
        new_p = gn_pnp(p, obj, pix, w, cam, iters=inner_iters,
                       damping=damping)
        ok = (torch.isfinite(new_p.R).all(dim=(-2, -1))
              & torch.isfinite(new_p.t).all(dim=-1))
        keep = alive & ok
        p = Pose(torch.where(keep[..., None, None], new_p.R, p.R),
                 torch.where(keep[..., None], new_p.t, p.t))
    return p, n_in
