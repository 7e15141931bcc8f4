"""Hypothesis selection (port of dsac_tpu/ops/select.py)."""

from __future__ import annotations

import torch


def softmax_scores(scores: torch.Tensor) -> torch.Tensor:
    """Softmax over the hypothesis axis (last)."""
    return torch.softmax(scores, dim=-1)


def shannon_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Shannon entropy in bits."""
    p = torch.clamp(probs, min=1e-12)
    return -torch.sum(probs * torch.log2(p), dim=-1)


def draw_hypothesis(scores: torch.Tensor, random_draw: bool,
                    generator: torch.Generator | None = None
                    ) -> torch.Tensor:
    """Winner per row of scores (..., H): a categorical draw from the
    softmax (DSAC) or the first argmax (RANSAC)."""
    if random_draw:
        probs = softmax_scores(scores).reshape(-1, scores.shape[-1])
        idx = torch.multinomial(probs, 1, generator=generator)
        return idx.reshape(scores.shape[:-1])
    return torch.argmax(scores, dim=-1)
