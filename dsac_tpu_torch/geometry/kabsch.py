"""Branch-free triad alignment for three exact correspondences (port of
dsac_tpu/geometry/kabsch.py:triad_align), the P3P back end."""

from __future__ import annotations

import torch

from dsac_tpu_torch.geometry.pose import Pose


def triad_align(a: torch.Tensor, b: torch.Tensor) -> Pose:
    """Rigid transform with R a_i + t = b_i from 3 non-collinear points.

    a, b: (..., 3, 3) (three points, last axis xyz).
    """
    def normalize(x):
        return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)
                              + 1e-12)

    def triad(p):
        e0 = p[..., 1, :] - p[..., 0, :]
        e1 = p[..., 2, :] - p[..., 0, :]
        n0 = normalize(e0)
        n2 = normalize(torch.linalg.cross(n0, e1, dim=-1))
        n1 = torch.linalg.cross(n2, n0, dim=-1)
        return torch.stack([n0, n1, n2], dim=-1)

    R = triad(b) @ triad(a).transpose(-1, -2)
    t = b.mean(dim=-2) - (R @ a.mean(dim=-2)[..., None])[..., 0]
    return Pose(R, t)
