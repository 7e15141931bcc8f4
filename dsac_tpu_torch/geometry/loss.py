"""Pose losses and pose-error metrics (port of
dsac_tpu/geometry/loss.py)."""

from __future__ import annotations

import torch

from dsac_tpu_torch.geometry.pose import Pose, invert
from dsac_tpu_torch.geometry.rotation import angular_distance_deg

MAX_LOSS = 1e7  # MAXLOSS clamp (core/maxloss.h:30)


def pose_errors(est: Pose, gt: Pose) -> tuple[torch.Tensor, torch.Tensor]:
    """(rot_err_deg, trans_err_mm) between the inverted (camera) poses."""
    inv_est = invert(est)
    inv_gt = invert(gt)
    rot_err = angular_distance_deg(inv_est.R, inv_gt.R)
    t_err = torch.linalg.norm(inv_est.t - inv_gt.t, dim=-1)
    return rot_err, t_err


def is_correct(est: Pose, gt: Pose, rot_thresh_deg: float = 5.0,
               trans_thresh_mm: float = 50.0) -> torch.Tensor:
    """The 5 cm / 5 degree correctness flag."""
    rot_err, t_err = pose_errors(est, gt)
    return (rot_err < rot_thresh_deg) & (t_err < trans_thresh_mm)


def max_loss(est: Pose, gt: Pose) -> torch.Tensor:
    """min(max(rot_deg, trans_mm / 10), MAX_LOSS): the larger of degrees
    and centimetres (core/maxloss.h:78)."""
    rot_err, t_err = pose_errors(est, gt)
    return torch.clamp(torch.maximum(rot_err, t_err / 10.0), max=MAX_LOSS)


def expected_max_loss(probs: torch.Tensor, losses: torch.Tensor
                      ) -> torch.Tensor:
    """E_p[loss] over a hypothesis pool (core/cnn.h:137-151)."""
    return torch.sum(probs * losses, dim=-1)
