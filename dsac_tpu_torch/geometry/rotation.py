"""SO(3) utilities (port of dsac_tpu/geometry/rotation.py)."""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix: (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues vector -> rotation matrix, with the reference's Taylor
    branch below theta^2 = 1e-8.  (..., 3) -> (..., 3, 3)."""
    theta_sq = torch.sum(w * w, dim=-1)
    small = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq),
                                   theta_sq))
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta))
                    / torch.where(small, torch.ones_like(theta_sq),
                                  theta_sq))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector via the quaternion route
    (Shepperd's method).  (..., 3, 3) -> (..., 3)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(t, a, b, c):
        s = torch.sqrt(torch.clamp(t, min=_EPS)) * 2.0
        return s, a / s, b / s, c / s

    s0, x0, y0, z0 = cand(1.0 + tr, m21 - m12, m02 - m20, m10 - m01)
    q0 = torch.stack([0.25 * s0, x0, y0, z0], dim=-1)
    s1, w1, y1, z1 = cand(1.0 + m00 - m11 - m22, m21 - m12, m01 + m10,
                          m02 + m20)
    q1 = torch.stack([w1, 0.25 * s1, y1, z1], dim=-1)
    s2, w2, x2, z2 = cand(1.0 - m00 + m11 - m22, m02 - m20, m01 + m10,
                          m12 + m21)
    q2 = torch.stack([w2, x2, 0.25 * s2, z2], dim=-1)
    s3, w3, x3, y3 = cand(1.0 - m00 - m11 + m22, m10 - m01, m02 + m20,
                          m12 + m21)
    q3 = torch.stack([w3, x3, y3, 0.25 * s3], dim=-1)

    diag = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(diag, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4 cand, 4)
    q = torch.gather(qs, -2, idx[..., None, None].expand(
        *idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)

    w_, v = q[..., 0], q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vnorm, w_)
    small = vnorm < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(w_, min=_EPS),
                        angle / torch.where(small, torch.ones_like(vnorm),
                                            vnorm))
    return v * scale[..., None]


def angular_distance_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle in degrees between two rotations, by the trace formula
    clamped as the reference clamps it."""
    diff = R1 @ R2.transpose(-1, -2)
    tr = torch.diagonal(diff, dim1=-2, dim2=-1).sum(-1)
    tr = torch.clamp(tr, -1.0, 3.0)
    arg = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    return torch.acos(arg) * (180.0 / math.pi)
