"""IRLS pose refinement on the card: the fused refine kernel
(csrc/refine.cu), its init-pose backward, the per-step statistics kernel
(csrc/irls_stats.cu), and their plain PyTorch versions.

Ports of dsac_tpu/ops/gn_pallas.py, with a leading frame axis: poses
(B, P) refine against their own frame's coordinates.

* ``refine_pose_fused`` (<- refine_pose_fused): the whole refinement in
  one launch.  The kernel runs ``outer_steps * inner_iters`` single-GN
  IRLS steps (as dsac_tpu/pipeline/forward.py:158 sets it); its plain
  version ``refine_pose_fused_ref`` runs the same steps in PyTorch
  (geometry/gn.py:refine_pose with ``inner_iters=1``).  ``refine_layout``
  picks the kernel's layout from the number of poses: a thread-block
  cluster per pose on small grids, several poses of one frame per CTA on
  large ones.  ``refine_pose_ref`` is the reference's jnp refiner,
  ``outer_steps`` reweightings of ``inner_iters`` GN steps: the same fixed
  point by another iteration, which ``fused_refine=False`` selects.
* ``refine_init_sensitive`` (<- make_init_sensitivity_refiner,
  gn_pallas.py:469-544): the refine kernel as a ``torch.autograd.Function``
  whose backward is the reference's dRefineHyp, J_init^T g by central
  differences over the initial pose's 6 tangent dimensions, with all 12
  probes of every pose refined in one more launch of the same kernel.
* ``irls_stats`` (<- irls_stats): one pass of the 28 IRLS statistics per
  pose, in the refine kernel's layouts (csrc/pose_layout.cuh;
  ``irls_stats_layout`` picks one per launch); ``refine_pose_fused_steps``
  (<- refine_pose_fused_steps) runs one such launch per step and the 6x6
  solve and pose update in PyTorch.  It is the independent check of the
  refine kernel: the two kernels share their per-pixel body
  (csrc/irls_stats.cuh) and the order of their sums, not their solve.

Each wrapper counts its kernel launches in its ``launches`` attribute;
the backward counts its own in ``InitSensitiveRefine.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.gn import (_residuals_and_jac, refine_pose,
                                        soft_inlier_weights, solve6_cholesky)
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.rotation import hat, so3_exp
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
    """The reference's jnp refiner over the (B, P) pool:
    geometry/gn.py:refine_pose, ``outer_steps`` reweightings of
    ``inner_iters`` GN steps (``fused_refine=False``)."""
    return refine_pose(poses, coords[:, None], pix[:, None], cam,
                       steps=outer_steps, inner_iters=inner_iters,
                       threshold=threshold, beta=beta,
                       min_inliers=min_inliers, damping=damping,
                       max_error=max_error)


def refine_pose_fused_ref(poses: Pose, coords: torch.Tensor,
                          pix: torch.Tensor, cam: Camera,
                          outer_steps: int = 8, inner_iters: int = 2,
                          threshold: float = 10.0, beta: float = 1.0,
                          min_inliers: float = 50.0, damping: float = 1e-4,
                          max_error: float = 100.0
                          ) -> tuple[Pose, torch.Tensor]:
    """Plain version of the refine kernel: its ``outer_steps *
    inner_iters`` single-GN IRLS steps, each reweighting first, in
    PyTorch.  Before convergence this differs from the 8 x 2 nest of
    ``refine_pose_ref``, and the finite-difference backward
    differentiates the truncated iteration itself."""
    return refine_pose(poses, coords[:, None], pix[:, None], cam,
                       steps=outer_steps * inner_iters, inner_iters=1,
                       threshold=threshold, beta=beta,
                       min_inliers=min_inliers, damping=damping,
                       max_error=max_error)


class RefineLayout(NamedTuple):
    """How csrc/refine.cu and csrc/irls_stats.cu lay the poses out
    (csrc/pose_layout.cuh): ``cluster`` CTAs (a thread-block cluster)
    share one pose's pixels, or, with ``cluster`` 1, a CTA holds
    ``poses_per_cta`` poses of one frame; each pose gets
    ``warps_per_pose`` warps in each of its CTAs."""

    cluster: int
    poses_per_cta: int
    warps_per_pose: int

    @property
    def threads(self) -> int:
        return self.poses_per_cta * self.warps_per_pose * 32


# limits of csrc/refine.cu and csrc/irls_stats.cu on Hopper: their
# __launch_bounds__, the portable cluster size, and the shared memory a
# block can have; and their static shared memory (pose_layout.cuh:
# PoseSums): the double-buffered warp sums and cluster slots (8 x 32
# floats each), and the slots' two mbarriers
REFINE_MAX_THREADS = 256
MAX_CLUSTER = 8
SMEM_LIMIT_BYTES = 232_448
REFINE_STATIC_SMEM_BYTES = 4 * 2 * 2 * 8 * 32 + 2 * 8
# warps a cluster's CTA gives its pose; the large-grid layout gives each
# pose as many warps (up to 8) as keep about this many warps an SM
CLUSTER_WARPS = 4
WARPS_PER_SM = 16


def refine_smem_bytes(layout: RefineLayout, N: int) -> int:
    """Shared memory of one CTA: its slice of the frame's N pixels (x, y,
    z, u, v as float32) and the static sums."""
    return 20 * -(-N // layout.cluster) + REFINE_STATIC_SMEM_BYTES


def check_refine_layout(layout: RefineLayout, N: int) -> None:
    """Raise ValueError unless csrc/refine.cu takes ``layout`` at N
    pixels a frame."""
    c, g, w = layout
    problems = []
    if c not in (1, 2, 4, 8):
        problems.append(f"cluster {c} is not 1, 2, 4 or {MAX_CLUSTER}")
    if g < 1 or w < 1 or layout.threads > REFINE_MAX_THREADS:
        problems.append(f"{g} poses x {w} warps a CTA is not 1 to "
                        f"{REFINE_MAX_THREADS} threads")
    if c > 1 and g != 1:
        problems.append("a cluster serves one pose")
    if refine_smem_bytes(layout, N) > SMEM_LIMIT_BYTES:
        problems.append(f"{N} pixels a frame need "
                        f"{refine_smem_bytes(layout, N)} bytes of shared "
                        f"memory a CTA, more than {SMEM_LIMIT_BYTES}")
    if problems:
        raise ValueError(f"refine layout {tuple(layout)}: "
                         + "; ".join(problems))


def refine_layout(num_poses: int, P: int, N: int,
                  sm_count: int) -> RefineLayout:
    """The refine kernel's layout for ``num_poses`` poses, ``P`` of them
    a frame, against ``N`` pixels a frame, on a card of ``sm_count`` SMs.

    Small grids (at most half as many poses as SMs: SoftAM's 1 pose, its
    backward's 12 probes, serving's top 4 of 8 frames) get a cluster of
    MAX_CLUSTER CTAs of CLUSTER_WARPS warps per pose.  Larger grids get one
    CTA per group of poses of one frame, each pose as many warps (a power
    of two, at most 8) as keeps about WARPS_PER_SM warps an SM, and as many
    poses a CTA as 8 warps hold (at most P): 8 warps and 1 pose a CTA at
    256 poses (the shape of the one-block-per-pose kernel this replaced),
    1 warp and 8 poses at 2,048.  These are the fastest layouts of the
    H100 sweep (``cli/profile_kernels.py --sweep``, PERF.md).  A frame too
    large for one CTA's shared memory is split over a cluster.  Raises
    ValueError where no layout takes N."""
    if 2 * num_poses <= sm_count:
        layout = RefineLayout(MAX_CLUSTER, 1, CLUSTER_WARPS)
    else:
        warps = 1
        while (warps < 8
               and num_poses * warps * 2 <= WARPS_PER_SM * sm_count):
            warps *= 2
        layout = RefineLayout(1, max(1, min(8 // warps, P)), warps)
    while (refine_smem_bytes(layout, N) > SMEM_LIMIT_BYTES
           and layout.cluster < MAX_CLUSTER):
        layout = RefineLayout(layout.cluster * 2, 1, layout.warps_per_pose)
    check_refine_layout(layout, N)
    return layout


def launch_refine(R0: torch.Tensor, t0: torch.Tensor, coords: torch.Tensor,
                  pix: torch.Tensor, cam: Camera, steps: int,
                  threshold: float, beta: float, min_inliers: float,
                  damping: float, max_error: float,
                  layout: RefineLayout | None = None
                  ) -> tuple[Pose, torch.Tensor]:
    """One launch of the refine kernel on checked CUDA tensors, in
    ``layout`` (``refine_layout``'s by default).  Not counted: the caller
    counts its launches."""
    B, P, N, dev = _build.check_poses(R0, t0, coords, pix)
    if layout is None:
        layout = refine_layout(B * P, P, N, _build.sm_count(dev))
    check_refine_layout(layout, N)
    R = torch.empty_like(R0)
    t = torch.empty_like(t0)
    n_in = torch.empty((B, P), dtype=torch.float32, device=dev)
    _build.launch("dsac_refine_pose", dev, R0.data_ptr(), t0.data_ptr(),
                  coords.data_ptr(), pix.data_ptr(), B, P, N, steps,
                  cam.focal, cam.cx, cam.cy, max_error, threshold,
                  1.0 / beta, min_inliers, damping, *layout, R.data_ptr(),
                  t.data_ptr(), n_in.data_ptr())
    return Pose(R, t), n_in


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
    dev = _build.check_poses(R0, t0, coords, pix)[3]
    if dev.type == "cpu":
        return refine_pose_fused_ref(poses, coords, pix, cam, outer_steps,
                                     inner_iters, threshold, beta,
                                     min_inliers, damping, max_error)
    out = launch_refine(R0, t0, coords, pix, cam, outer_steps * inner_iters,
                        threshold, beta, min_inliers, damping, max_error)
    refine_pose_fused.launches += 1
    return out


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


# The IRLS-stats kernel takes the refine kernel's layouts and limits
# (csrc/pose_layout.cuh), and picks them by refine_layout's rule, which the
# H100 sweep of both of its shapes kept (cli/profile_kernels.py --sweep
# --kernels irls_stats, PERF.md).
irls_stats_layout = refine_layout
check_irls_stats_layout = check_refine_layout


def launch_irls_stats(R: torch.Tensor, t: torch.Tensor, coords: torch.Tensor,
                      pix: torch.Tensor, cam: Camera, threshold: float = 10.0,
                      beta: float = 1.0, max_error: float = 100.0,
                      layout: RefineLayout | None = None) -> torch.Tensor:
    """One launch of the IRLS-stats kernel on checked CUDA tensors, in
    ``layout`` (``irls_stats_layout``'s by default).  Not counted: the
    caller counts its launches."""
    B, P, N, dev = _build.check_poses(R, t, coords, pix)
    if layout is None:
        layout = irls_stats_layout(B * P, P, N, _build.sm_count(dev))
    check_irls_stats_layout(layout, N)
    out = torch.empty((B, P, 28), dtype=torch.float32, device=dev)
    _build.launch("dsac_irls_stats", dev, R.data_ptr(), t.data_ptr(),
                  coords.data_ptr(), pix.data_ptr(), B, P, N, cam.focal,
                  cam.cx, cam.cy, max_error, threshold, 1.0 / beta, *layout,
                  out.data_ptr())
    return out


def irls_stats(R: torch.Tensor, t: torch.Tensor, coords: torch.Tensor,
               pix: torch.Tensor, cam: Camera, threshold: float = 10.0,
               beta: float = 1.0, max_error: float = 100.0) -> torch.Tensor:
    """(B, P, 28) IRLS statistics of poses R (B, P, 3, 3), t (B, P, 3)
    against coords (B, N, 3) mm at pixels pix (B, N, 2): the 21
    upper-triangle entries of JtJ (row-major), the 6 of Jtr, and the soft
    inlier count, with soft-inlier weights and the 1 mm z-floor."""
    dev = _build.check_poses(R, t, coords, pix)[3]
    if dev.type == "cpu":
        return irls_stats_ref(R, t, coords, pix, cam, threshold, beta,
                              max_error)
    out = launch_irls_stats(R, t, coords, pix, cam, threshold, beta,
                            max_error)
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


# the init-pose probes: rotations exp(+-eps e_i) R, translations
# t +- eps e_i (gn_pallas.py:514-526; cnn_softam.h:738-836)
EPS_ROT, EPS_T = 1e-3, 1.0


def _hat_basis(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """hat(e_i) for the three axes: (3, 3, 3)."""
    return hat(torch.eye(3, dtype=dtype, device=device))


def init_probes(R: torch.Tensor, t: torch.Tensor) -> Pose:
    """The 12 probe poses of every pose R (B, P, 3, 3), t (B, P, 3), in
    the reference's order: (+, -) x (3 rotation dims, 3 translation dims).
    Returns poses (B, 12 * P), contiguous."""
    B, P = t.shape[:2]
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    dR = torch.stack([so3_exp(EPS_ROT * eye), so3_exp(-EPS_ROT * eye)])
    Rrot = torch.einsum("sdab,npbc->nsdpac", dR, R)  # (B, 2, 3, P, 3, 3)
    Rp = torch.cat([Rrot, R[:, None, None].expand(B, 2, 3, P, 3, 3)], dim=2)
    sign = 1.0 - 2.0 * torch.arange(2, dtype=t.dtype, device=t.device)
    tt = t[:, None, None] + EPS_T * (sign[:, None, None, None]
                                     * eye[None, :, None, :])  # (B,2,3,P,3)
    tp = torch.cat([t[:, None, None].expand(B, 2, 3, P, 3), tt], dim=2)
    return Pose(Rp.reshape(B, 12 * P, 3, 3).contiguous(),
                tp.reshape(B, 12 * P, 3).contiguous())


class InitSensitiveRefine(torch.autograd.Function):
    """The refine kernel with the reference's init-pose gradient.

    Forward: ``refine_pose_fused`` (one launch, counted there).  Backward:
    the 12 probes of every pose (``init_probes``) refined in one launch of
    the same kernel on (B, 12 * P) poses, counted in ``launches``; the
    central differences J_R, J_t of the refined pose per tangent dimension
    give v = <g, J>, and the gradient is gR0 = 0.5 sum_i v_i hat(e_i) R0,
    gt0 = v[3:] (gn_pallas.py:506-541).  The coordinates and pixels get no
    gradient: their path is the implicit step's.  With ``plain`` both
    refinements run the kernel's iteration in PyTorch
    (``refine_pose_fused_ref``), on either device."""

    launches = 0

    @staticmethod
    def forward(ctx, R, t, coords, pix, cam, kw, plain):
        R, t = R.contiguous(), t.contiguous()
        refine = refine_pose_fused_ref if plain else refine_pose_fused
        out, _ = refine(Pose(R, t), coords, pix, cam, **kw)
        ctx.save_for_backward(R, t, coords, pix)
        ctx.cam, ctx.kw, ctx.plain = cam, kw, plain
        return out.R, out.t

    @staticmethod
    def backward(ctx, gR, gt):
        R, t, coords, pix = ctx.saved_tensors
        B, P = t.shape[:2]
        kw = ctx.kw
        with torch.no_grad():
            probes = init_probes(R, t)
            if ctx.plain or t.device.type == "cpu":
                out, _ = refine_pose_fused_ref(probes, coords, pix, ctx.cam,
                                               **kw)
            else:
                out, _ = launch_refine(
                    probes.R, probes.t, coords, pix, ctx.cam,
                    kw["outer_steps"] * kw["inner_iters"], kw["threshold"],
                    kw["beta"], kw["min_inliers"], kw["damping"],
                    kw["max_error"])
                InitSensitiveRefine.launches += 1
            oR = out.R.reshape(B, 2, 6, P, 3, 3)
            ot = out.t.reshape(B, 2, 6, P, 3)
            # built on the device: a host tensor here would be a
            # synchronous copy in every backward
            eps = torch.cat([t.new_full((3,), EPS_ROT),
                             t.new_full((3,), EPS_T)])
            JR = (oR[:, 0] - oR[:, 1]) / (2.0 * eps[:, None, None, None])
            Jt = (ot[:, 0] - ot[:, 1]) / (2.0 * eps[:, None, None])
            v = (torch.einsum("bdpjk,bpjk->bpd", JR, gR)
                 + torch.einsum("bdpj,bpj->bpd", Jt, gt))  # (B, P, 6)
            gR0 = 0.5 * torch.einsum("bpi,ijk,bpkl->bpjl", v[..., :3],
                                     _hat_basis(t.dtype, t.device), R)
        return gR0, v[..., 3:], None, None, None, None, None


def refine_init_sensitive(poses: Pose, coords: torch.Tensor,
                          pix: torch.Tensor, cam: Camera,
                          outer_steps: int = 8, inner_iters: int = 2,
                          threshold: float = 10.0, beta: float = 1.0,
                          min_inliers: float = 50.0, damping: float = 1e-4,
                          max_error: float = 100.0, plain: bool = False
                          ) -> Pose:
    """Refined poses (B, P) with the truncated iteration's init-pose
    gradient (``InitSensitiveRefine``); coords (B, N, 3), pix (B, N, 2)."""
    kw = dict(outer_steps=outer_steps, inner_iters=inner_iters,
              threshold=threshold, beta=beta, min_inliers=min_inliers,
              damping=damping, max_error=max_error)
    R, t = InitSensitiveRefine.apply(poses.R, poses.t, coords.detach(),
                                     pix.detach(), cam, kw, plain)
    return Pose(R, t)
