"""End-to-end DSAC and SoftAM training (port of the end-to-end part of
dsac_tpu/pipeline/train.py).

The objective of one round is the reference's (train_ransac.cpp:134-409):
E_{h ~ softmax(s)}[maxLoss(refine(h))] over the hypothesis pool for DSAC,
maxLoss of the refined softmax-average for SoftAM (cnn_softam.h:1163).
Autograd of that one scalar gives both of the reference's hand-built
gradient paths, the pose path and the REINFORCE score path.  The
coordinate CNN's output gradient is clamped to +-0.1 (train_obj.lua:172);
each net has SGD with momentum 0.9 (1e-5 for the coordinate net, 1e-7 for
the score net) after clipping its gradient to a global norm of 10.

Steps 4 and 5 of a round, the P3P sampling and the diff-maps, run as
plain PyTorch on the card because the reference trains through its jnp
solver and its jnp diff-maps there (ops/sampling.py:187-256 with
``fused=False``, ops/diffmap.py:26); no kernel has a backward for them.
The refinement is the refine kernel in ``refine_mode="implicit"``, with
its finite-difference backward for SoftAM (ops/gn_cuda.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from dsac_tpu_torch.config import Camera, DSACConfig
from dsac_tpu_torch.geometry.loss import max_loss
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.models.coord_net import coord_apply as net_coord_apply
from dsac_tpu_torch.pipeline.forward import (FrameDraws,
                                             process_frame_softam,
                                             process_frames_batched)

# (net, images (B, H, W, 3), pixels (B, N, 2)) -> coordinates (B, N, 3) m
CoordApply = Callable[[torch.nn.Module, torch.Tensor, torch.Tensor],
                      torch.Tensor]

GRAD_CLAMP = 0.1  # the coordinate CNN's output gradient (train_obj.lua:20)


class _ClampGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, -ctx.limit, ctx.limit), None


def clamp_grad(x: torch.Tensor, limit: float) -> torch.Tensor:
    """Identity whose gradient is clamped to [-limit, limit]
    (train.py:42-55)."""
    return _ClampGrad.apply(x, limit)


def coord_l1_loss(pred_m: torch.Tensor, gt_m: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean Euclidean distance in metres (MyL1Criterion.lua:7-20)."""
    d = torch.sqrt(torch.sum((pred_m - gt_m) ** 2, dim=-1) + 1e-12)
    if mask is None:
        return d.mean()
    return torch.sum(d * mask) / torch.clamp(mask.sum(), min=1.0)


def score_l1_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean absolute error of scalar scores (train_score.lua:41)."""
    return torch.mean(torch.abs(pred - label))


class ClippedSGD(torch.optim.Optimizer):
    """optax.chain(clip_by_global_norm(clip_norm), sgd(lr, momentum))
    written out: g <- g * clip_norm / |g| where |g| >= clip_norm, |g| the
    norm over all the optimizer's parameters; trace <- g + momentum *
    trace (zero at first); p <- p - lr * trace.  A parameter without a
    gradient counts as a zero gradient, as in JAX."""

    def __init__(self, params, lr: float, momentum: float = 0.9,
                 clip_norm: float = 10.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      clip_norm=clip_norm))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.where(norm < group["clip_norm"],
                                torch.ones_like(norm),
                                group["clip_norm"] / norm)
            for p, g in zip(params, grads):
                state = self.state[p]
                trace = state.get("trace")
                trace = g * scale if trace is None else \
                    g * scale + group["momentum"] * trace
                state["trace"] = trace
                p.sub_(group["lr"] * trace)


def e2e_optimizers(coord_params, score_params, coord_lr: float = 1e-5,
                   score_lr: float = 1e-7, clip_norm: float = 10.0
                   ) -> tuple[ClippedSGD, ClippedSGD]:
    """(coord, score) SGD with momentum 0.9 (train_obj.lua:18-19,
    train_score.lua:18-19) after global-norm clipping at ``clip_norm``,
    each over its own net (train.py:91-106)."""
    return (ClippedSGD(coord_params, coord_lr, clip_norm=clip_norm),
            ClippedSGD(score_params, score_lr, clip_norm=clip_norm))


@dataclasses.dataclass
class TrainState:
    """Both nets, their optimizers and the round count."""

    coord_net: torch.nn.Module
    score_net: torch.nn.Module
    coord_opt: ClippedSGD
    score_opt: ClippedSGD
    step: int = 0


def make_e2e_state(coord_net: torch.nn.Module,
                   score_net: torch.nn.Module) -> TrainState:
    c_opt, s_opt = e2e_optimizers(list(coord_net.parameters()),
                                  list(score_net.parameters()))
    return TrainState(coord_net, score_net, c_opt, s_opt, 0)


def e2e_expected_loss(coord_fn: Callable, score_fn: Callable,
                      images: torch.Tensor, gt: Pose, cam: Camera,
                      cfg: DSACConfig, softam: bool = False,
                      refine_mode=False,
                      score_anchor: float = 0.0,
                      draws: FrameDraws = FrameDraws(),
                      generator: torch.Generator | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """The objective whose gradient is the reference's two-path backward
    (train.py:351-424), for frames images (B, H, W, 3) at poses gt (B,).

    coord_fn(images, pix) -> (B, N, 3) metres; score_fn(dmaps (M, G, G))
    -> (M,).  Returns (objective, the mean over the frames, and aux, a
    dict of per-frame tensors (B,)).  DSAC: E[loss] over the refined
    pool, with the pose-path gradient cut where p < 1e-4
    (train_ransac.cpp:319).  SoftAM: maxLoss of the refined average.
    ``score_anchor`` > 0 adds, for DSAC, that weight times the L1 between
    the scores of the detached diff-maps and -10 min(maxLoss(raw
    hypothesis), 40), over the valid hypotheses: it reaches the score
    net only.
    """
    def clamped_coord_fn(imgs, pix):
        return clamp_grad(coord_fn(imgs, pix), GRAD_CLAMP)

    gt_pool = Pose(gt.R[:, None], gt.t[:, None])
    if softam:
        res = process_frame_softam(images, clamped_coord_fn, score_fn, cam,
                                   cfg, refine_mode=refine_mode, draws=draws,
                                   generator=generator)
        objective = max_loss(res.final, gt)
        losses = max_loss(res.refined, gt_pool)
    else:
        res = process_frames_batched(
            images, clamped_coord_fn, cam, cfg, draws=draws,
            generator=generator, scoring="cnn_torch", score_fn=score_fn,
            sampling=False, refine_all=True, fused_refine=refine_mode)
        losses = max_loss(res.refined, gt_pool)
        skip = res.probs < 1e-4
        objective = torch.sum(
            res.probs * torch.where(skip, losses.detach(), losses), dim=-1)

    anchor = torch.zeros_like(objective)
    if score_anchor > 0.0 and not softam:
        target = -10.0 * torch.clamp(max_loss(res.hyps, gt_pool), max=40.0)
        grid = res.dmaps.shape[-1]
        scores = score_fn(res.dmaps.detach().reshape(-1, grid, grid)
                          ).reshape(res.scores.shape)
        valid = res.hyp_valid.to(scores.dtype)
        anchor = (torch.sum(valid * torch.abs(scores - target.detach()), -1)
                  / torch.clamp(valid.sum(-1), min=1.0))
        objective = objective + score_anchor * anchor

    with torch.no_grad():
        aux = {
            "expected_loss": torch.sum(res.probs * losses, dim=-1),
            "entropy": res.entropy.detach(),
            "winner_loss": max_loss(res.final, gt),
            "valid_hyps": res.hyp_valid.sum(-1),
            "score_anchor_l1": anchor.detach(),
        }
    return objective.mean(), aux


def e2e_step(state: TrainState, images: torch.Tensor, gt: Pose,
             cam: Camera, cfg: DSACConfig,
             coord_apply: CoordApply = net_coord_apply,
             softam: bool = False, refine_mode=False,
             score_anchor: float = 0.0, draws: FrameDraws = FrameDraws(),
             generator: torch.Generator | None = None
             ) -> tuple[TrainState, torch.Tensor, dict]:
    """One joint SGD update of both nets (one frame per round,
    train_ransac.cpp:241), in place.  Returns (state, objective, aux), aux
    with the coordinate gradient's largest magnitude ``grad_max``, its
    norm ``grad_norm`` and ``grad_finite`` (train_ransac.cpp:384-395)."""
    state.coord_opt.zero_grad()
    state.score_opt.zero_grad()
    objective, aux = e2e_expected_loss(
        lambda imgs, pix: coord_apply(state.coord_net, imgs, pix),
        state.score_net, images, gt, cam, cfg,
        softam=softam, refine_mode=refine_mode, score_anchor=score_anchor,
        draws=draws, generator=generator)
    objective.backward()
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .flatten() for p in state.coord_net.parameters()])
    aux = dict(aux)
    aux["grad_max"] = flat.abs().max()
    aux["grad_norm"] = torch.linalg.norm(flat)
    aux["grad_finite"] = torch.isfinite(flat).all()
    state.coord_opt.step()
    state.score_opt.step()
    state.step += 1
    return state, objective.detach(), aux
