"""Stratified pixel sampling and minimal-set hypothesis sampling (port of
dsac_tpu/ops/sampling.py): the two-phase sampler and both fixed-T
samplers, fused (the P3P kernel) and unfused (the PyTorch P3P solver).

Every function keeps a leading frame axis B, so one P3P launch serves all
lanes of a batch of frames.  Random draws come from an explicit
``torch.Generator``; each function also takes its draws as arguments, so
that tests can feed it the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dsac_tpu_torch.config import Camera, PoseConfig
from dsac_tpu_torch.geometry.p3p import gn_polish_pose, solve_pnp_minimal
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.projection import project
from dsac_tpu_torch.ops.p3p_cuda import p3p_solve


def stratified_sample(batch: int, image_width: int, image_height: int,
                      grid: int, patch_size: int,
                      jitter: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """One random pixel per cell of a (grid x grid) stratification.

    jitter: optional (B, 2, grid, grid) uniforms in [0, 1) for x and y;
    drawn from `generator` when None.  Returns integer pixel coordinates
    (B, grid, grid, 2) as (x, y).
    """
    x_stride = (image_width - patch_size) / grid
    y_stride = (image_height - patch_size) / grid
    half = patch_size // 2
    if jitter is None:
        jitter = torch.rand((batch, 2, grid, grid), generator=generator,
                            device=device)
    dev = jitter.device
    cell_x = torch.arange(grid, dtype=torch.float32, device=dev) * x_stride \
        + half
    cell_y = torch.arange(grid, dtype=torch.float32, device=dev) * y_stride \
        + half
    oy, ox = torch.meshgrid(cell_y, cell_x, indexing="ij")  # (gy, gx)
    px = torch.floor(ox + jitter[:, 0] * x_stride).to(torch.int64)
    py = torch.floor(oy + jitter[:, 1] * y_stride).to(torch.int64)
    return torch.stack([px, py], dim=-1)


class MinimalSets(NamedTuple):
    """Per-hypothesis minimal-set draws of a batch of frames."""

    indices: torch.Tensor  # (B, H, 4) flat indices into the N samples
    poses: Pose  # (B, H) P3P poses
    valid: torch.Tensor  # (B, H) bool: solved and self-consistent


def _rows_index(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """idx (B, ...) flattened to (B, M) and expanded over x's trailing
    dimensions, for gather/scatter along x's axis 1."""
    tail = x.shape[2:]
    return idx.reshape(idx.shape[0], -1, *([1] * len(tail))).expand(
        idx.shape[0], -1, *tail)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) at rows idx (B, ...) -> (B, ..., *x.shape[2:])."""
    return torch.gather(x, 1, _rows_index(x, idx)).reshape(*idx.shape,
                                                           *x.shape[2:])


def put_rows(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor
             ) -> torch.Tensor:
    """x (B, N, ...) with rows idx (B, K) set to val (B, K, ...)."""
    return x.scatter(1, _rows_index(x, idx), val)


def _has_dup(s: torch.Tensor) -> torch.Tensor:
    """True where a 4-index set repeats an index: (..., 4) -> (...)."""
    eq = s[..., :, None] == s[..., None, :]
    return eq.sum(dim=(-2, -1)) > 4  # the diagonal contributes 4


def _take(x: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """x (B, L, T, ...) at attempt chosen (B, L) -> (B, L, ...)."""
    tail = x.shape[3:]
    idx = chosen.reshape(*chosen.shape, 1, *([1] * len(tail)))
    return torch.gather(x, 2, idx.expand(*chosen.shape, 1, *tail)
                        ).squeeze(2)


def _select(idx_b: torch.Tensor, poses: Pose, valid: torch.Tensor,
            worst: torch.Tensor, coords: torch.Tensor, pix: torch.Tensor,
            cam: Camera, polish: bool = True) -> MinimalSets:
    """The first valid attempt per lane (B, L, T), or the attempt with the
    smallest worst error, flagged invalid; with ``polish`` the chosen set
    gets the sub-pixel GN polish."""
    first_valid = torch.argmax(valid.to(torch.int32), dim=-1)
    fallback = torch.argmin(torch.where(valid, torch.inf, worst), dim=-1)
    any_valid = valid.any(dim=-1)
    chosen = torch.where(any_valid, first_valid, fallback)

    sel_idx = _take(idx_b, chosen)
    sel = Pose(_take(poses.R, chosen), _take(poses.t, chosen))
    if not polish:
        return MinimalSets(indices=sel_idx, poses=sel, valid=any_valid)
    polished = gn_polish_pose(sel, gather_rows(coords, sel_idx),
                              gather_rows(pix, sel_idx), cam)
    ok = (torch.isfinite(polished.R).all(dim=(-2, -1))
          & torch.isfinite(polished.t).all(dim=-1))
    keep = any_valid & ok
    sel = Pose(torch.where(keep[..., None, None], polished.R, sel.R),
               torch.where(keep[..., None], polished.t, sel.t))
    return MinimalSets(indices=sel_idx, poses=sel, valid=any_valid)


def _solve_attempts_fused(idx: torch.Tensor, coords: torch.Tensor,
                          pix: torch.Tensor, cam: Camera, thresh: float):
    """Solve the (B, L, T) attempts idx (B, L, T, 4) in one P3P launch;
    returns (poses, valid, worst), each with batch (B, L, T)."""
    B, L, T, _ = idx.shape
    obj = gather_rows(coords, idx).reshape(B * L * T, 4, 3)
    img = gather_rows(pix, idx).reshape(B * L * T, 4, 2)
    flat, solved, worst = p3p_solve(obj, img, cam)
    poses = Pose(flat.R.reshape(B, L, T, 3, 3), flat.t.reshape(B, L, T, 3))
    worst = worst.reshape(B, L, T)
    valid = solved.reshape(B, L, T) & (worst < thresh) & ~_has_dup(idx)
    return poses, valid, worst


def _solve_attempts_plain(idx: torch.Tensor, coords: torch.Tensor,
                          pix: torch.Tensor, cam: Camera, thresh: float):
    """Solve the (B, L, T) attempts idx (B, L, T, 4) with the PyTorch P3P
    solver, each polished before the consistency check; returns (poses,
    valid, worst), each with batch (B, L, T)."""
    obj = gather_rows(coords, idx)  # (B, L, T, 4, 3)
    img = gather_rows(pix, idx)
    poses, solved = solve_pnp_minimal(obj, img, cam)
    err = torch.linalg.norm(project(poses, obj, cam) - img, dim=-1)
    worst = err.amax(dim=-1)
    valid = solved & (worst < thresh) & ~_has_dup(idx)
    return poses, valid, worst


def sample_minimal_sets(coords: torch.Tensor, pix: torch.Tensor,
                        cam: Camera, cfg: PoseConfig, fused: bool,
                        idx: torch.Tensor | None = None,
                        generator: torch.Generator | None = None
                        ) -> MinimalSets:
    """Fixed-T hypothesis sampling for a batch of frames: every one of the
    H lanes solves T attempts (draws idx (B, H, T, 4)) and keeps its first
    valid one (dsac_tpu/ops/sampling.py:sample_minimal_sets).

    coords (B, N, 3) mm; pix (B, N, 2) float.  ``fused=True``
    (sampling.py:218-221) solves all B * H * T attempts in one launch of
    the P3P kernel, checks the raw P3P poses and polishes only the chosen
    set.  ``fused=False`` (sampling.py:223-256) is the port of the
    reference's jnp path, which the reference computes without Pallas: the
    PyTorch P3P solver (geometry/p3p.py:solve_pnp_minimal) polishes every
    attempt before the 4-point consistency check.  It is not the P3P
    kernel's plain version standing in for the kernel.  The reference's
    ``hyp_sample_chunk`` bounds XLA scratch memory and changes no result;
    it has no counterpart here.
    """
    B, n = coords.shape[:2]
    H, T = cfg.num_hypotheses, cfg.sample_attempts
    if idx is None:
        idx = torch.randint(0, n, (B, H, T, 4), generator=generator,
                            device=coords.device)
    solve = _solve_attempts_fused if fused else _solve_attempts_plain
    return _select(idx, *solve(idx, coords, pix, cam,
                               cfg.inlier_threshold_2d),
                   coords, pix, cam, polish=fused)


def sample_minimal_sets_two_phase(coords: torch.Tensor, pix: torch.Tensor,
                                  cam: Camera, cfg: PoseConfig,
                                  idx1: torch.Tensor | None = None,
                                  idx2: torch.Tensor | None = None,
                                  generator: torch.Generator | None = None
                                  ) -> MinimalSets:
    """Resample-only-failures hypothesis sampling for a batch of frames.

    coords (B, N, 3) mm; pix (B, N, 2) float.  Phase 1 solves one attempt
    per lane (draws idx1 (B, H, 1, 4)); phase 2 re-solves the
    K = ceil(H * two_phase_budget) lanes that failed first (a stable sort
    puts invalid lanes first) at depth T - 1 (draws idx2 (B, K, T-1, 4))
    and rescues those that phase 2 validates.
    """
    B, n = coords.shape[:2]
    H, T = cfg.num_hypotheses, cfg.sample_attempts
    thresh = cfg.inlier_threshold_2d
    dev = coords.device

    def draw(shape):
        return torch.randint(0, n, shape, generator=generator, device=dev)

    if idx1 is None:
        idx1 = draw((B, H, 1, 4))
    sel1 = _select(idx1, *_solve_attempts_fused(idx1, coords, pix, cam,
                                                thresh), coords, pix, cam)
    if T <= 1:
        return sel1

    K = max(1, int(math.ceil(H * cfg.two_phase_budget)))
    order = torch.argsort(sel1.valid.to(torch.uint8), dim=-1, stable=True)
    lanes = order[:, :K]  # (B, K): invalid lanes first
    if idx2 is None:
        idx2 = draw((B, K, T - 1, 4))
    sel2 = _select(idx2, *_solve_attempts_fused(idx2, coords, pix, cam,
                                                thresh), coords, pix, cam)

    v1 = gather_rows(sel1.valid, lanes)
    take = ~v1 & sel2.valid  # only rescue failures

    def merge(old, new):
        mask = take.reshape(B, K, *([1] * (old.dim() - 2)))
        return put_rows(old, lanes, torch.where(mask, new,
                                                gather_rows(old, lanes)))

    R = merge(sel1.poses.R, sel2.poses.R)
    t = merge(sel1.poses.t, sel2.poses.t)
    indices = merge(sel1.indices, sel2.indices)
    valid = put_rows(sel1.valid, lanes, v1 | sel2.valid)
    return MinimalSets(indices=indices, poses=Pose(R, t), valid=valid)
