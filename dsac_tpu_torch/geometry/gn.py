"""Gauss-Newton PnP and soft-inlier IRLS refinement (port of
dsac_tpu/geometry/gn.py).

``refine_pose`` runs ``steps`` reweightings of ``inner_iters``
Gauss-Newton steps each.  With ``inner_iters=1`` and ``steps`` the
kernel's step count it is the plain version of the fused refine kernel
(ops/gn_cuda.py), step for step; the reference's 8 x 2 nest reaches the
same fixed point by another path.  ``refine_pose_hard`` is the
reference's hard-threshold ablation (evaluation only).
``implicit_refine_step`` is the differentiable step that training takes
from a fixed point.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.rotation import hat, so3_exp

_EPS = 1e-8

# The reference caps each hard re-solve at the first inliers in the order of
# jax.random.permutation(PRNGKey(0), N), which PyTorch cannot draw: the
# order of N = 1600 (a 40 x 40 grid) is committed as data, written from the
# reference by tests/test_torch_synthetic.py.
PERM_FIXTURE = (Path(__file__).resolve().parents[1] / "data"
                / "hard_refine_perm.json")


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


@functools.lru_cache(maxsize=None)
def _committed_permutation(n: int) -> torch.Tensor:
    fx = json.loads(PERM_FIXTURE.read_text())
    if len(fx["perm"]) != n:
        raise ValueError(f"the committed permutation is of "
                         f"{len(fx['perm'])} points, not {n}: pass perm")
    return torch.tensor(fx["perm"], dtype=torch.int64)


def hard_permutation(n: int, device: torch.device | str = "cpu"
                     ) -> torch.Tensor:
    """The reference's point order of the hard refinement's cap,
    jax.random.permutation(PRNGKey(0), n), for the committed n."""
    return _committed_permutation(n).to(device)


def refine_pose_hard(pose: Pose, obj: torch.Tensor, pix: torch.Tensor,
                     cam: Camera, steps: int = 8, inner_iters: int = 2,
                     threshold: float = 10.0, inlier_cap: int = 100,
                     min_inliers: float = 50.0, damping: float = 1e-4,
                     max_error: float = 100.0,
                     perm: torch.Tensor | None = None
                     ) -> tuple[Pose, torch.Tensor]:
    """Hard-threshold refinement with capped re-solves (gn.py:193-247,
    the reference's inlier policy, core/cnn.h:1186-1204).

    A point is an inlier iff its clamped reprojection error is below
    ``threshold``; each of the ``inner_iters`` GN steps of an outer step
    sees only the first ``inlier_cap`` inliers in the order ``perm`` (N,)
    (default: ``hard_permutation``), at weight 1; a pose freezes for good
    once fewer than ``min_inliers`` points are inliers.  No gradient is
    meant to pass: the gates are hard.  Returns (refined pose, hard inlier
    count at the pose that entered the last step, f32).
    """
    if perm is None:
        perm = hard_permutation(obj.shape[-2], obj.device)
    inv = torch.argsort(perm)
    p = pose
    alive = torch.ones(pose.t.shape[:-1], dtype=torch.bool,
                       device=pose.t.device)
    n_in = None
    for _ in range(steps):
        r, _J = _residuals_and_jac(p, obj, pix, cam)
        err = torch.clamp(torch.sqrt(torch.sum(r * r, dim=-1) + _EPS),
                          max=max_error)
        inl = err < threshold
        n_in = torch.sum(inl, dim=-1)
        alive = alive & (n_in >= min_inliers)
        inl_p = inl[..., perm]
        csum = torch.cumsum(inl_p.to(torch.int32), dim=-1)
        w = (inl_p & (csum <= inlier_cap))[..., inv].to(obj.dtype)
        new_p = gn_pnp(p, obj, pix, w, cam, iters=inner_iters,
                       damping=damping)
        ok = (torch.isfinite(new_p.R).all(dim=(-2, -1))
              & torch.isfinite(new_p.t).all(dim=-1))
        keep = alive & ok
        p = Pose(torch.where(keep[..., None, None], new_p.R, p.R),
                 torch.where(keep[..., None], new_p.t, p.t))
    return p, n_in.to(torch.float32)


def implicit_refine_step(pose_star: Pose, obj: torch.Tensor,
                         pix: torch.Tensor, cam: Camera,
                         threshold: float = 10.0, beta: float = 1.0,
                         damping: float = 1e-4,
                         max_error: float = 100.0) -> Pose:
    """One differentiable IRLS step from a fixed point (gn.py:250-271).

    The pose is detached: the fixed point is found without gradient (by
    the refine kernel in training), and the derivative of this one step
    with respect to the coordinates is the implicit-function derivative
    of the fixed point.  At a fixed point the step leaves the value
    unchanged."""
    pose_star = Pose(pose_star.R.detach(), pose_star.t.detach())
    r, _ = _residuals_and_jac(pose_star, obj, pix, cam)
    err = torch.clamp(torch.sqrt(torch.sum(r * r, dim=-1) + _EPS),
                      max=max_error)
    w = soft_inlier_weights(err, threshold, beta)
    return gn_pnp(pose_star, obj, pix, w, cam, iters=1, damping=damping)
