"""The serve forward pass for a batch of frames (port of
dsac_tpu/pipeline/forward.py:process_frame with ``refine_all=False``,
``scoring="fused_soft"``, ``fused_sampling="two_phase"`` and refine mode
``"fused"``).

stratified subsample -> coordinate CNN -> two-phase P3P sampling ->
fused soft-inlier scores -> argmax or draw -> fused IRLS refinement of the
winner, or of the top-K scored hypotheses with the largest final inlier
count served (``verify_topk``).

Where the reference vmaps one frame, this carries a leading frame axis B
through every stage, so each kernel launches once per batch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from dsac_tpu_torch.config import Camera, DSACConfig
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.ops.diffmap_cuda import soft_inlier_scores
from dsac_tpu_torch.ops.gn_cuda import refine_pose_fused
from dsac_tpu_torch.ops.sampling import (gather_rows, put_rows,
                                         sample_minimal_sets_two_phase,
                                         stratified_sample)
from dsac_tpu_torch.ops.select import (draw_hypothesis, shannon_entropy,
                                       softmax_scores)

# (images (B, H, W, 3), pixels (B, N, 2) int) -> scene coordinates (B, N, 3)
# in metres
CoordFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class FrameDraws(NamedTuple):
    """Optional explicit random draws of a batch (None: drawn from the
    generator).  Tests inject the reference's jax.random draws here."""

    jitter: torch.Tensor | None = None  # (B, 2, G, G) stratified jitter
    idx1: torch.Tensor | None = None  # (B, H, 1, 4) phase-1 minimal sets
    idx2: torch.Tensor | None = None  # (B, K, T-1, 4) phase-2 minimal sets


class FrameResult(NamedTuple):
    """Everything the serve path computes, with a leading frame axis."""

    sampling: torch.Tensor  # (B, G, G, 2) sampled pixels (x, y)
    coords: torch.Tensor  # (B, N, 3) predicted scene coordinates, mm
    hyps: Pose  # (B, H) unrefined P3P hypotheses
    hyp_valid: torch.Tensor  # (B, H) bool
    minimal_indices: torch.Tensor  # (B, H, 4)
    scores: torch.Tensor  # (B, H) soft-inlier scores, -1e9 where invalid
    probs: torch.Tensor  # (B, H)
    entropy: torch.Tensor  # (B,) bits
    chosen: torch.Tensor  # (B,) served hypothesis index
    refined: Pose  # (B, H): refined where refined_mask, else unrefined
    inlier_counts: torch.Tensor  # (B, H)
    final: Pose  # (B,) the served pose
    refined_mask: torch.Tensor  # (B, H) bool


def process_frames_batched(images: torch.Tensor, coord_fn: CoordFn,
                           cam: Camera, cfg: DSACConfig,
                           verify_topk: int = 0,
                           draws: FrameDraws = FrameDraws(),
                           generator: torch.Generator | None = None
                           ) -> FrameResult:
    """Serve a batch of frames images (B, H, W, 3)."""
    B = images.shape[0]
    p = cfg.pose
    grid = cfg.net.subsample_size
    sampling = stratified_sample(B, cfg.data.image_width,
                                 cfg.data.image_height, grid,
                                 cfg.net.rgb_patch_size, jitter=draws.jitter,
                                 generator=generator, device=images.device)
    pix = sampling.reshape(B, -1, 2)
    coords = (coord_fn(images, pix) * 1000.0).contiguous()  # m -> mm
    pixf = pix.to(torch.float32).contiguous()

    sets = sample_minimal_sets_two_phase(coords, pixf, cam, p,
                                         idx1=draws.idx1, idx2=draws.idx2,
                                         generator=generator)
    scores = soft_inlier_scores(sets.poses.R, sets.poses.t, coords, pixf,
                                cam, threshold=p.inlier_threshold_2d,
                                beta=p.score_beta,
                                max_error=p.max_reprojection_error)
    # invalid hypotheses are buried, like the reference's zero-pose fallback
    scores = torch.where(sets.valid, scores, -1e9)
    probs = softmax_scores(scores)
    ent = shannon_entropy(probs)

    def refine(pool: Pose):
        return refine_pose_fused(
            Pose(pool.R.contiguous(), pool.t.contiguous()), coords, pixf,
            cam, outer_steps=p.refinement_steps,
            inner_iters=p.gn_inner_steps, threshold=p.inlier_threshold_2d,
            beta=p.inlier_beta, min_inliers=p.min_inliers,
            damping=p.gn_damping, max_error=p.max_reprojection_error)

    H = scores.shape[1]
    if verify_topk > 1:
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

    return FrameResult(sampling, coords, sets.poses, sets.valid,
                       sets.indices, scores, probs, ent, chosen, refined,
                       n_in, final, mask)


def process_frame(image: torch.Tensor, coord_fn: CoordFn, cam: Camera,
                  cfg: DSACConfig, verify_topk: int = 0,
                  draws: FrameDraws = FrameDraws(),
                  generator: torch.Generator | None = None) -> FrameResult:
    """One frame (H, W, 3): ``process_frames_batched`` with B = 1, the
    frame axis dropped from the result."""
    res = process_frames_batched(image[None], coord_fn, cam, cfg,
                                 verify_topk, draws, generator)
    return FrameResult(*[type(f)(*(x[0] for x in f))
                         if isinstance(f, Pose) else f[0] for f in res])
