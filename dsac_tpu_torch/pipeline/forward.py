"""The DSAC forward passes for a batch of frames (port of
dsac_tpu/pipeline/forward.py: process_frame, process_frame_softam,
make_refiners and verified_selection).

stratified subsample -> coordinate CNN -> minimal-set P3P sampling ->
scoring -> softmax, argmax or draw -> IRLS refinement, of the winner, of
the top-K scored hypotheses with the largest final inlier count served
(``verify_topk``), or of the whole pool (``refine_all``).  SoftAM
(``process_frame_softam``) averages the pool by softmax weight instead and
refines only the average.

Scoring is ``"fused_soft"`` (the score kernel: reprojection and
soft-inlier sum in one pass, no error surface), ``"cnn"`` (the diff-map
kernel writes the (B, H, N) error surface, whose (G, G) maps the score
CNN scores) or ``"cnn_torch"`` (the same surface in PyTorch,
differentiable: training takes it because the reference trains through
its jnp diff-maps, ops/diffmap.py:26, and no diff-map kernel has a
backward).  Sampling is ``"two_phase"``, fixed-T through the P3P kernel
(``True``) or fixed-T through the PyTorch solver (``False``, which
training takes because the reference trains through its jnp solver,
ops/sampling.py:223-256).

Refinement (``make_refiners``) is ``"fused"``/``True`` (the refine kernel,
no gradient), ``"unroll"``/``False`` (the PyTorch IRLS, differentiated by
autograd through every step), ``"hard"`` (the hard-threshold ablation,
evaluation only), ``"implicit"`` (the refine kernel's fixed
point and one differentiable GN step there) or ``"implicit_jnp"`` (the
same with the PyTorch IRLS for the fixed point).

Where the reference vmaps one frame, this carries a leading frame axis B
through every stage, so each kernel launches once per batch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from dsac_tpu_torch.config import Camera, DSACConfig, PoseConfig
from dsac_tpu_torch.geometry.gn import implicit_refine_step, refine_pose_hard
from dsac_tpu_torch.geometry.pose import Pose, pose_from_vec6, pose_to_vec6
from dsac_tpu_torch.ops.diffmap import diffmaps as diffmaps_torch
from dsac_tpu_torch.ops.diffmap_cuda import diffmaps, soft_inlier_scores
from dsac_tpu_torch.ops.gn_cuda import (refine_init_sensitive,
                                        refine_pose_fused, refine_pose_ref)
from dsac_tpu_torch.ops.sampling import (gather_rows, put_rows,
                                         sample_minimal_sets,
                                         sample_minimal_sets_two_phase,
                                         stratified_sample)
from dsac_tpu_torch.ops.select import (draw_hypothesis, shannon_entropy,
                                       softmax_scores)

# (images (B, H, W, 3), pixels (B, N, 2) int) -> scene coordinates (B, N, 3)
# in metres
CoordFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# diff-maps (M, G, G) -> scores (M,)
ScoreFn = Callable[[torch.Tensor], torch.Tensor]

# hypotheses per chunk of the differentiable implicit step in refine-all
# training (forward.py:43): each chunk's (B, C, N, 2, 6) Jacobians are
# recomputed in the backward instead of kept
_IMPLICIT_STEP_CHUNK = 1024


class FrameDraws(NamedTuple):
    """Optional explicit random draws of a batch (None: drawn from the
    generator).  Tests inject the reference's jax.random draws here."""

    jitter: torch.Tensor | None = None  # (B, 2, G, G) stratified jitter
    idx1: torch.Tensor | None = None  # (B, H, 1, 4) phase-1 minimal sets
    idx2: torch.Tensor | None = None  # (B, K, T-1, 4) phase-2 minimal sets
    idx: torch.Tensor | None = None  # (B, H, T, 4) fixed-T minimal sets


class FrameResult(NamedTuple):
    """Everything the forward pass computes, with a leading frame axis."""

    sampling: torch.Tensor  # (B, G, G, 2) sampled pixels (x, y)
    coords: torch.Tensor  # (B, N, 3) predicted scene coordinates, mm
    hyps: Pose  # (B, H) unrefined P3P hypotheses
    hyp_valid: torch.Tensor  # (B, H) bool
    minimal_indices: torch.Tensor  # (B, H, 4)
    dmaps: torch.Tensor  # (B, H, G, G) error maps; (B, 0, G, G) unless cnn
    scores: torch.Tensor  # (B, H) scores, -1e9 where invalid
    probs: torch.Tensor  # (B, H)
    entropy: torch.Tensor  # (B,) bits
    chosen: torch.Tensor  # (B,) served hypothesis index
    refined: Pose  # (B, H): refined where refined_mask, else unrefined
    inlier_counts: torch.Tensor  # (B, H)
    final: Pose  # (B,) the served pose
    refined_mask: torch.Tensor  # (B, H) bool


def verified_selection(res: FrameResult) -> FrameResult:
    """Re-select each frame's winner as the refined hypothesis with the
    largest final soft-inlier count (forward.py:67-83); needs
    ``refine_all``."""
    counts = torch.where(res.hyp_valid, res.inlier_counts, -1.0)
    chosen = torch.argmax(counts, dim=-1)
    c = chosen[:, None]
    return res._replace(chosen=chosen,
                        final=Pose(gather_rows(res.refined.R, c)[:, 0],
                                   gather_rows(res.refined.t, c)[:, 0]))


def make_refiners(coords: torch.Tensor, pixf: torch.Tensor, cam: Camera,
                  p: PoseConfig, mode, inject_init: bool = False):
    """The refiner of pools (B, P) against coords (B, N, 3), pixf (B, N, 2)
    for a refinement ``mode`` (forward.py:117-284): a function
    pool -> (refined pool, soft inlier counts (B, P)).

    ``"fused"``/True: the refine kernel, without gradient (serving).
    ``"unroll"``/False: the reference's jnp IRLS (8 x 2), differentiated by
    autograd through every step.  ``"implicit"``: the refine kernel's
    fixed point from detached inputs, then one differentiable GN step
    there, whose coordinate gradient is the implicit-function gradient.
    ``"implicit_jnp"``: the same with the 8 x 2 PyTorch IRLS for the fixed
    point.  ``"hard"``: ``refine_pose_hard``, the reference's hard
    threshold with capped re-solves, in PyTorch on either device (the
    reference runs it in jnp; evaluation only).  ``inject_init`` (implicit modes; SoftAM) adds the truncated
    iteration's init-pose sensitivity as a zero-valued straight-through
    term: on ``"implicit"`` the refine kernel's finite-difference backward
    (``refine_init_sensitive``), on ``"implicit_jnp"`` autograd through the
    PyTorch IRLS with the coordinates detached.  Hypotheses whose soft
    inlier count ended below ``min_inliers`` keep the fixed point and get
    no pose-path gradient.
    """
    kw = dict(outer_steps=p.refinement_steps, inner_iters=p.gn_inner_steps,
              threshold=p.inlier_threshold_2d, beta=p.inlier_beta,
              min_inliers=p.min_inliers, damping=p.gn_damping,
              max_error=p.max_reprojection_error)

    def contiguous(pool: Pose) -> Pose:
        return Pose(pool.R.contiguous(), pool.t.contiguous())

    def fused(pool: Pose, c: torch.Tensor = coords):
        return refine_pose_fused(contiguous(pool), c, pixf, cam, **kw)

    def torch_irls(pool: Pose, c: torch.Tensor = coords):
        return refine_pose_ref(pool, c, pixf, cam, **kw)

    def hard(pool: Pose):
        return refine_pose_hard(
            pool, coords[:, None], pixf[:, None], cam,
            steps=p.refinement_steps, inner_iters=p.gn_inner_steps,
            threshold=p.inlier_threshold_2d, inlier_cap=p.inlier_count_cap,
            min_inliers=p.min_inliers, damping=p.gn_damping,
            max_error=p.max_reprojection_error)

    def step(R: torch.Tensor, t: torch.Tensor):
        out = implicit_refine_step(
            Pose(R, t), coords[:, None], pixf[:, None], cam,
            threshold=p.inlier_threshold_2d, beta=p.inlier_beta,
            damping=p.gn_damping, max_error=p.max_reprojection_error)
        return out.R, out.t

    def implicit(pool: Pose, fixed_point, fd_init: bool):
        pool0 = Pose(pool.R.detach(), pool.t.detach())
        refined, n_in = fixed_point(pool0, coords.detach())
        P, ch = pool.t.shape[1], _IMPLICIT_STEP_CHUNK
        if P > ch:
            parts = [checkpoint(step, refined.R[:, i:i + ch],
                                refined.t[:, i:i + ch], use_reentrant=False)
                     for i in range(0, P, ch)]
            stepped = Pose(torch.cat([a for a, _ in parts], dim=1),
                           torch.cat([b for _, b in parts], dim=1))
        else:
            stepped = Pose(*step(refined.R, refined.t))
        if inject_init:
            if fd_init:
                s = refine_init_sensitive(pool, coords, pixf, cam, **kw)
            else:
                s, _ = torch_irls(pool, coords.detach())
            stepped = Pose(stepped.R + s.R - s.R.detach(),
                           stepped.t + s.t - s.t.detach())
        ok = (n_in >= p.min_inliers)[..., None]
        return Pose(torch.where(ok[..., None], stepped.R, refined.R),
                    torch.where(ok, stepped.t, refined.t)), n_in

    if mode in (True, "fused"):
        return fused
    if mode in (False, "unroll"):
        return torch_irls
    if mode == "hard":
        return hard
    if mode == "implicit":
        return lambda pool: implicit(pool, fused, fd_init=True)
    if mode == "implicit_jnp":
        return lambda pool: implicit(pool, torch_irls, fd_init=False)
    raise ValueError(f"unknown refine mode {mode!r}")


def _front_end(images: torch.Tensor, coord_fn: CoordFn, cam: Camera,
               cfg: DSACConfig, draws: FrameDraws,
               generator: torch.Generator | None, scoring: str,
               score_fn: ScoreFn | None, sampling):
    """Sampling -> coordinates (mm) -> hypotheses -> scores -> softmax
    (``score_hypotheses``).  Returns (pixels, coords, pixf, sets, dmaps,
    scores, probs, entropy)."""
    B = images.shape[0]
    p = cfg.pose
    grid = cfg.net.subsample_size
    pixels = stratified_sample(B, cfg.data.image_width,
                               cfg.data.image_height, grid,
                               cfg.net.rgb_patch_size, jitter=draws.jitter,
                               generator=generator, device=images.device)
    pix = pixels.reshape(B, -1, 2)
    coords = (coord_fn(images, pix) * 1000.0).contiguous()  # m -> mm
    pixf = pix.to(torch.float32).contiguous()

    if sampling == "two_phase":
        sets = sample_minimal_sets_two_phase(coords, pixf, cam, p,
                                             idx1=draws.idx1, idx2=draws.idx2,
                                             generator=generator)
    elif sampling in (True, False):
        sets = sample_minimal_sets(coords, pixf, cam, p, fused=sampling,
                                   idx=draws.idx, generator=generator)
    else:
        raise ValueError(f"unknown sampling mode {sampling!r}")
    dmaps, scores, probs, ent = score_hypotheses(
        sets.poses, sets.valid, coords, pixf, cam, cfg, scoring, score_fn)
    return pixels, coords, pixf, sets, dmaps, scores, probs, ent


def score_hypotheses(hyps: Pose, valid: torch.Tensor, coords: torch.Tensor,
                     pixf: torch.Tensor, cam: Camera, cfg: DSACConfig,
                     scoring: str, score_fn: ScoreFn | None):
    """Scores of a pool hyps (B, H) against coords (B, N, 3) mm and pixf
    (B, N, 2), invalid lanes buried at -1e9, and their softmax.  Returns
    (dmaps (B, H, G, G), or (B, 0, G, G) under "fused_soft"; scores;
    probs; entropy (B,) in bits)."""
    p, grid, B = cfg.pose, cfg.net.subsample_size, coords.shape[0]
    if scoring == "fused_soft":
        scores = soft_inlier_scores(hyps.R.contiguous(), hyps.t.contiguous(),
                                    coords, pixf, cam,
                                    threshold=p.inlier_threshold_2d,
                                    beta=p.score_beta,
                                    max_error=p.max_reprojection_error)
        dmaps = coords.new_zeros((B, 0, grid, grid))
    elif scoring in ("cnn", "cnn_torch"):
        if scoring == "cnn":
            dm = diffmaps(hyps.R.contiguous(), hyps.t.contiguous(), coords,
                          pixf, cam, p.max_reprojection_error)
        else:
            dm = diffmaps_torch(hyps, coords, pixf, cam,
                                p.max_reprojection_error)
        # the pixel order of stratified_sample is row-major (gy, gx), so
        # each row of the surface is one (G, G) map (forward.py:110)
        dmaps = dm.reshape(B, -1, grid, grid)
        scores = score_fn(dmaps.reshape(-1, grid, grid)).reshape(B, -1)
    else:
        raise ValueError(f"unknown scoring mode {scoring!r}")
    # invalid hypotheses are buried, like the reference's zero-pose fallback
    scores = torch.where(valid, scores, -1e9)
    probs = softmax_scores(scores)
    return dmaps, scores, probs, shannon_entropy(probs)


def process_frames_batched(images: torch.Tensor, coord_fn: CoordFn,
                           cam: Camera, cfg: DSACConfig,
                           verify_topk: int = 0,
                           draws: FrameDraws = FrameDraws(),
                           generator: torch.Generator | None = None,
                           scoring: str = "fused_soft",
                           score_fn: ScoreFn | None = None,
                           sampling: str | bool = "two_phase",
                           refine_all: bool = False,
                           fused_refine=True,
                           softam: bool = False) -> FrameResult:
    """The forward pass of a batch of frames images (B, H, W, 3).

    scoring: "fused_soft", "cnn" or "cnn_torch" (``score_fn`` scores the
    maps); sampling: "two_phase", True (fixed-T, P3P kernel) or False
    (fixed-T, PyTorch solver); refine_all refines the whole pool and
    serves the drawn winner; fused_refine is the refinement mode of
    ``make_refiners``: True/"fused" (the refine kernel), False/"unroll"
    (the PyTorch IRLS), "hard" (``refine_pose_hard``), "implicit" or
    "implicit_jnp".  ``softam`` serves the soft-argmax average instead
    (``process_frame_softam``, forward.py:405-412): its refine mode is
    "fused" when ``fused_refine`` is set, else False, and ``verify_topk``
    and ``refine_all`` do not apply.
    """
    if softam:
        return process_frame_softam(
            images, coord_fn, score_fn, cam, cfg,
            refine_mode="fused" if fused_refine else False, draws=draws,
            generator=generator, scoring=scoring, sampling=sampling)
    p = cfg.pose
    pixels, coords, pixf, sets, dmaps, scores, probs, ent = _front_end(
        images, coord_fn, cam, cfg, draws, generator, scoring, score_fn,
        sampling)
    refine = make_refiners(coords, pixf, cam, p, fused_refine)

    H = scores.shape[1]
    if refine_all:
        chosen = draw_hypothesis(scores, p.random_draw, generator)
        refined, n_in = refine(sets.poses)
        c = chosen[:, None]
        final = Pose(gather_rows(refined.R, c)[:, 0],
                     gather_rows(refined.t, c)[:, 0])
        mask = torch.ones_like(sets.valid)
    elif verify_topk > 1:
        k = min(int(verify_topk), H)
        # stable descending sort: ties go to the lower index, as
        # jax.lax.top_k breaks them
        top_scores, top = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
        top_scores, top = top_scores[:, :k], top[:, :k]
        refined_k, n_k = refine(Pose(gather_rows(sets.poses.R, top),
                                     gather_rows(sets.poses.t, top)))
        n_k = torch.where(top_scores > -1e8, n_k, -1.0)
        best = torch.argmax(n_k, dim=-1)
        final = Pose(gather_rows(refined_k.R, best[:, None])[:, 0],
                     gather_rows(refined_k.t, best[:, None])[:, 0])
        chosen = gather_rows(top, best[:, None])[:, 0]
        refined = Pose(put_rows(sets.poses.R, top, refined_k.R),
                       put_rows(sets.poses.t, top, refined_k.t))
        n_in = put_rows(torch.zeros_like(scores), top,
                        torch.clamp(n_k, min=0.0))
        mask = put_rows(torch.zeros_like(sets.valid), top,
                    torch.ones_like(top, dtype=torch.bool))
    else:
        chosen = draw_hypothesis(scores, p.random_draw, generator)
        c = chosen[:, None]
        out, n_c = refine(Pose(gather_rows(sets.poses.R, c),
                               gather_rows(sets.poses.t, c)))
        final = Pose(out.R[:, 0], out.t[:, 0])
        refined = Pose(put_rows(sets.poses.R, c, out.R),
                       put_rows(sets.poses.t, c, out.t))
        n_in = put_rows(torch.zeros_like(scores), c, n_c)
        mask = put_rows(torch.zeros_like(sets.valid), c,
                    torch.ones_like(c, dtype=torch.bool))

    return FrameResult(pixels, coords, sets.poses, sets.valid,
                       sets.indices, dmaps, scores, probs, ent, chosen,
                       refined, n_in, final, mask)


def process_frame(image: torch.Tensor, coord_fn: CoordFn, cam: Camera,
                  cfg: DSACConfig, verify_topk: int = 0,
                  draws: FrameDraws = FrameDraws(),
                  generator: torch.Generator | None = None,
                  **kwargs) -> FrameResult:
    """One frame (H, W, 3): ``process_frames_batched`` with B = 1 (and its
    keyword options), the frame axis dropped from the result."""
    res = process_frames_batched(image[None], coord_fn, cam, cfg,
                                 verify_topk, draws, generator, **kwargs)
    return FrameResult(*[type(f)(*(x[0] for x in f))
                         if isinstance(f, Pose) else f[0] for f in res])


def softam_average(probs: torch.Tensor, hyps: Pose) -> Pose:
    """The softmax-weighted average of a pool (B, H) in (Rodrigues, t)
    6-vectors (cnn_softam.h:1082-1094) -> (B,).  Invalid lanes carry a
    weight of 0 (their score is -1e9 before the softmax); a non-finite
    6-vector, which would poison the sum even at weight 0, counts as 0."""
    vecs = pose_to_vec6(hyps)
    vecs = torch.where(torch.isfinite(vecs), vecs, 0.0)
    return pose_from_vec6(torch.sum(probs[..., None] * vecs, dim=1))


def process_frame_softam(images: torch.Tensor, coord_fn: CoordFn,
                         score_fn: ScoreFn | None, cam: Camera,
                         cfg: DSACConfig, refine_mode=False,
                         draws: FrameDraws = FrameDraws(),
                         generator: torch.Generator | None = None,
                         scoring: str = "cnn_torch",
                         sampling: str | bool = False) -> FrameResult:
    """The soft-argmax forward pass of a batch of frames (forward.py:
    422-478): the softmax weights average the pool (``softam_average``),
    and only the average is refined, with the init-pose sensitivity
    injected in the implicit modes (``make_refiners``, ``inject_init``).

    ``scoring`` and ``sampling`` are ``_front_end``'s: the defaults are
    training's (the score CNN on PyTorch diff-maps, fixed-T sampling
    through the PyTorch solver); serving takes the kernels ("fused_soft"
    or "cnn", "two_phase" or True) and refine mode "fused".  ``refined``
    is the unrefined pool, ``final`` the refined average, ``chosen`` the
    most probable hypothesis, as in the reference (forward.py:472-478)."""
    p = cfg.pose
    pixels, coords, pixf, sets, dmaps, scores, probs, ent = _front_end(
        images, coord_fn, cam, cfg, draws, generator, scoring, score_fn,
        sampling)
    avg = softam_average(probs, sets.poses)
    refine = make_refiners(coords, pixf, cam, p, refine_mode,
                           inject_init=True)
    out, n_in = refine(Pose(avg.R[:, None], avg.t[:, None]))
    return FrameResult(pixels, coords, sets.poses, sets.valid,
                       sets.indices, dmaps, scores, probs, ent,
                       torch.argmax(probs, dim=-1), sets.poses,
                       n_in.expand_as(scores), Pose(out.R[:, 0],
                                                    out.t[:, 0]),
                       torch.zeros_like(sets.valid))
