"""Evaluation: per-frame pose errors and dataset summaries (port of
dsac_tpu/pipeline/evaluate.py, batched over frames).

The reporting of the reference's test_ransac (core/test_ransac.cpp:
221-273): rotation and translation errors of the served pose, the
5 cm / 5 deg accuracy, the expected loss over the pool, the score
entropy, and the median rotation (deg) and translation (cm).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsac_tpu_torch.geometry.loss import (expected_max_loss, max_loss,
                                          pose_errors)
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.pipeline.forward import FrameResult


class FrameEval(NamedTuple):
    rot_err_deg: torch.Tensor  # (B,)
    trans_err_mm: torch.Tensor  # (B,)
    correct: torch.Tensor  # (B,) 5 cm / 5 deg flag (core/cnn.h:1249-1256)
    expected_loss: torch.Tensor  # (B,)
    entropy: torch.Tensor  # (B,) bits
    losses: torch.Tensor  # (B, H) per-hypothesis losses


def evaluate_frame(result: FrameResult, gt: Pose) -> FrameEval:
    """Errors of a batch of results against ground-truth poses gt (B,).
    The pool's losses are taken at ``result.refined``: under refine_all
    every hypothesis is refined."""
    losses = max_loss(result.refined, Pose(gt.R[:, None], gt.t[:, None]))
    exp_loss = expected_max_loss(result.probs, losses)
    rot_err, t_err = pose_errors(result.final, gt)
    correct = (rot_err < 5.0) & (t_err < 50.0)
    return FrameEval(rot_err, t_err, correct, exp_loss, result.entropy,
                     losses)


def summarize(rot_errs_deg: np.ndarray, trans_errs_mm: np.ndarray,
              expected_losses: np.ndarray | None = None,
              entropies: np.ndarray | None = None) -> dict:
    """Dataset summary matching test_ransac.cpp:242-273; the median
    translation is reported in cm (test_ransac.cpp:263)."""
    rot = np.asarray(rot_errs_deg, np.float64)
    tra = np.asarray(trans_errs_mm, np.float64)
    correct = (rot < 5.0) & (tra < 50.0)
    out = {
        "frames": int(rot.size),
        "accuracy_5cm5deg": float(np.mean(correct)),
        "median_rot_err_deg": float(np.median(rot)),
        "median_trans_err_cm": float(np.median(tra) / 10.0),
    }
    if expected_losses is not None:
        e = np.asarray(expected_losses, np.float64)
        out["mean_expected_loss"] = float(np.mean(e))
        out["std_expected_loss"] = float(np.std(e))
    if entropies is not None:
        h = np.asarray(entropies, np.float64)
        out["mean_entropy_bits"] = float(np.mean(h))
        out["std_entropy_bits"] = float(np.std(h))
    return out
