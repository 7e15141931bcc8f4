"""Batched minimal PnP: Grunert P3P with a branchless closed-form quartic
(port of dsac_tpu/geometry/p3p.py).

Forward only: the port serves, it does not train yet, so the reference's
stop-gradient and implicit-step plumbing reduces to the values it
computes.  Every lane stays finite, degenerate ones included.
"""

from __future__ import annotations

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.kabsch import triad_align
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.projection import project

_EPS = 1e-12


def pixel_bearings(pix: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Unit bearings in the eye frame for pixels (..., 2) -> (..., 3)."""
    x = (pix[..., 0] - cam.cx) / cam.focal
    y = -(pix[..., 1] - cam.cy) / cam.focal
    d = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root with sign."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _cubic_max_real_root(b, c, d):
    """Largest real root of t^3 + b t^2 + c t + d: Cardano where one root
    is real, the trigonometric form where three are."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_card = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)

    p_neg = torch.clamp(p, max=-1e-20)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    arg = torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)
    t_trig = m * torch.cos(torch.acos(arg) / 3.0)

    return torch.where(disc >= 0.0, t_card, t_trig) - b / 3.0


def _solve_quartic_real(coeffs: torch.Tensor):
    """Real roots of a quartic by Ferrari's method, branchless.

    coeffs: (..., 5), highest power first.  Returns (roots (..., 4),
    is_real (..., 4)); non-real slots hold harmless values.
    """
    a4 = coeffs[..., 0]
    scale = torch.where(torch.abs(a4) < 1e-12,
                        torch.where(a4 < 0, -1e-12, 1e-12), a4)

    def clamp(x):
        return torch.clamp(x, -1e4, 1e4)

    b = clamp(coeffs[..., 1] / scale)
    c = clamp(coeffs[..., 2] / scale)
    d = clamp(coeffs[..., 3] / scale)
    e = clamp(coeffs[..., 4] / scale)

    b2 = b * b
    p = c - 3.0 * b2 / 8.0
    q = d - b * c / 2.0 + b * b2 / 8.0
    r = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0

    m = _cubic_max_real_root(p, p * p / 4.0 - r, -q * q / 8.0)
    m = torch.clamp(m, min=0.0)

    s2 = 2.0 * m
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    q_over_2s = q / torch.clamp(2.0 * s, min=1e-12)

    biq = (torch.abs(q) < 1e-10) & (s < 1e-10)
    disc_b = p * p - 4.0 * r
    y2a = (-p + torch.sqrt(torch.clamp(disc_b, min=0.0))) / 2.0
    y2b = (-p - torch.sqrt(torch.clamp(disc_b, min=0.0))) / 2.0

    c1 = p / 2.0 + m + q_over_2s
    c2 = p / 2.0 + m - q_over_2s
    disc1 = s2 / 4.0 - c1
    disc2 = s2 / 4.0 - c2
    sq1 = torch.sqrt(torch.clamp(disc1, min=0.0))
    sq2 = torch.sqrt(torch.clamp(disc2, min=0.0))

    y_quads = torch.stack([s / 2.0 + sq1, s / 2.0 - sq1,
                           -s / 2.0 + sq2, -s / 2.0 - sq2], dim=-1)
    real_quads = torch.stack([disc1, disc1, disc2, disc2], dim=-1) >= -1e-6

    sq_b_a = torch.sqrt(torch.clamp(y2a, min=0.0))
    sq_b_b = torch.sqrt(torch.clamp(y2b, min=0.0))
    y_biq = torch.stack([sq_b_a, -sq_b_a, sq_b_b, -sq_b_b], dim=-1)
    real_biq = ((torch.stack([disc_b] * 4, dim=-1) >= 0)
                & (torch.stack([y2a, y2a, y2b, y2b], dim=-1) >= 0))

    y = torch.where(biq[..., None], y_biq, y_quads)
    is_real = torch.where(biq[..., None], real_biq, real_quads)
    return y - b[..., None] / 4.0, is_real


def _newton_polish_real(coeffs: torch.Tensor, v0: torch.Tensor,
                        steps: int = 3, grad_floor: float = 1e-2
                        ) -> torch.Tensor:
    """``steps`` clipped Newton steps on a quartic root, then the
    reference's final step with the derivative floored at ``grad_floor``
    (the step that carries its implicit gradient; here only its value)."""
    def poly(cf, v):
        return ((((cf[..., 0] * v + cf[..., 1]) * v + cf[..., 2]) * v
                 + cf[..., 3]) * v + cf[..., 4])

    def dpoly(cf, v):
        return (((4.0 * cf[..., 0] * v + 3.0 * cf[..., 1]) * v
                 + 2.0 * cf[..., 2]) * v + cf[..., 3])

    v = v0
    for _ in range(steps):
        dpv = dpoly(coeffs, v)
        dpv = torch.where(torch.abs(dpv) < 1e-10,
                          torch.sign(dpv) * 1e-10 + 1e-12, dpv)
        v = v - torch.clamp(poly(coeffs, v) / dpv, -10.0, 10.0)
        v = torch.clamp(v, -100.0, 100.0)

    dpv = dpoly(coeffs, v)
    dpv = torch.where(dpv >= 0, torch.clamp(dpv, min=grad_floor),
                      torch.clamp(dpv, max=-grad_floor))
    return v - torch.clamp(poly(coeffs, v) / dpv, -10.0, 10.0)


def p3p_grunert(obj: torch.Tensor, bear: torch.Tensor):
    """Grunert P3P: ranges along three bearings.

    obj: (..., 3, 3) scene points (mm); bear: (..., 3, 3) unit bearings.
    Returns (ranges (..., 4, 3), valid (..., 4)).
    """
    x1, x2, x3 = obj[..., 0, :], obj[..., 1, :], obj[..., 2, :]
    f1, f2, f3 = bear[..., 0, :], bear[..., 1, :], bear[..., 2, :]

    a2 = torch.sum((x2 - x3) ** 2, dim=-1)
    b2 = torch.sum((x1 - x3) ** 2, dim=-1)
    c2 = torch.sum((x1 - x2) ** 2, dim=-1)
    b2_safe = torch.clamp(b2, min=_EPS)

    ca = torch.sum(f2 * f3, dim=-1)
    cb = torch.sum(f1 * f3, dim=-1)
    cg = torch.sum(f1 * f2, dim=-1)

    def ratio(x):
        return torch.clamp(x / b2_safe, -1e4, 1e4)

    q = ratio(a2 - c2)
    s = ratio(a2 + c2)

    A4 = (q - 1.0) ** 2 - 4.0 * ratio(c2) * ca ** 2
    A3 = 4.0 * (q * (1.0 - q) * cb - (1.0 - s) * ca * cg
                + 2.0 * ratio(c2) * ca ** 2 * cb)
    A2 = 2.0 * (q ** 2 - 1.0 + 2.0 * q ** 2 * cb ** 2
                + 2.0 * ratio(b2 - c2) * ca ** 2
                - 4.0 * s * ca * cb * cg
                + 2.0 * ratio(b2 - a2) * cg ** 2)
    A1 = 4.0 * (-q * (1.0 + q) * cb + 2.0 * ratio(a2) * cg ** 2 * cb
                - (1.0 - s) * ca * cg)
    A0 = (1.0 + q) ** 2 - 4.0 * ratio(a2) * cg ** 2

    coeffs = torch.stack([A4, A3, A2, A1, A0], dim=-1)
    coeffs = coeffs / (torch.amax(torch.abs(coeffs), dim=-1, keepdim=True)
                       + 1e-12)
    roots, is_real = _solve_quartic_real(coeffs)
    v = _newton_polish_real(coeffs[..., None, :], roots)

    denom_u = 2.0 * (cg[..., None] - v * ca[..., None])
    denom_u = torch.where(torch.abs(denom_u) < 1e-3,
                          torch.where(denom_u < 0, -1e-3, 1e-3), denom_u)
    u = ((-1.0 + q[..., None]) * v ** 2
         - 2.0 * q[..., None] * cb[..., None] * v
         + 1.0 + q[..., None]) / denom_u
    u = torch.clamp(u, -1e3, 1e3)
    s1_sq = b2_safe[..., None] / torch.clamp(
        1.0 + v ** 2 - 2.0 * v * cb[..., None], min=_EPS)
    s1 = torch.clamp(torch.sqrt(torch.clamp(s1_sq, min=_EPS)), 0.0, 1e6)
    ranges = torch.stack([s1, u * s1, v * s1], dim=-1)

    nondegen = torch.minimum(torch.minimum(a2, b2), c2) > 1.0
    valid = (is_real & (v > 0) & (u > 0)
             & torch.isfinite(ranges).all(dim=-1) & nondegen[..., None])
    ranges = torch.where(valid[..., None], ranges, 1000.0)
    return ranges, valid


def gn_polish_pose(pose: Pose, obj: torch.Tensor, pix: torch.Tensor,
                   cam: Camera, iters: int = 3) -> Pose:
    """A few unweighted Gauss-Newton steps on the minimal set."""
    from dsac_tpu_torch.geometry.gn import gn_pnp
    w = torch.ones(obj.shape[:-1], dtype=obj.dtype, device=obj.device)
    return gn_pnp(pose, obj, pix, w, cam, iters=iters, damping=1e-6)


def _eye_like(R: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)


def solve_pnp_minimal(obj: torch.Tensor, pix: torch.Tensor, cam: Camera,
                      polish_iters: int = 3) -> tuple[Pose, torch.Tensor]:
    """4-point minimal PnP: P3P on points 0..2, disambiguated by point 3.

    obj: (..., 4, 3) mm; pix: (..., 4, 2).  Returns (pose, valid); an
    invalid solve returns the identity pose.
    """
    bear = pixel_bearings(pix, cam)
    ranges, valid = p3p_grunert(obj[..., :3, :], bear[..., :3, :])

    cam_pts = ranges[..., :, None] * bear[..., None, :3, :]
    obj3 = obj[..., None, :3, :].expand(cam_pts.shape)
    cand = triad_align(obj3, cam_pts)  # batch (..., 4)
    cand_ok = (torch.isfinite(cand.R).all(dim=(-2, -1))
               & torch.isfinite(cand.t).all(dim=-1))
    cand = Pose(torch.where(cand_ok[..., None, None], cand.R,
                            _eye_like(cand.R)),
                torch.where(cand_ok[..., None], cand.t, 0.0))
    valid = valid & cand_ok

    obj4 = obj[..., 3, :][..., None, :].expand(cand.t.shape)
    p4 = project(cand, obj4[..., None, :], cam)  # (..., 4cand, 1, 2)
    err4 = torch.linalg.norm(p4[..., 0, :] - pix[..., 3, :][..., None, :],
                             dim=-1)
    eye4 = (cand.R @ obj4[..., None])[..., 0] + cand.t
    valid = valid & (eye4[..., 2] < 0)

    err4 = torch.where(valid, err4, torch.inf)
    best = torch.argmin(err4, dim=-1)
    R = torch.gather(cand.R, -3, best[..., None, None, None].expand(
        *best.shape, 1, 3, 3))[..., 0, :, :]
    t = torch.gather(cand.t, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    any_valid = valid.any(dim=-1)

    pose = Pose(torch.where(any_valid[..., None, None], R, _eye_like(R)),
                torch.where(any_valid[..., None], t, torch.zeros_like(t)))
    if polish_iters > 0:
        polished = gn_polish_pose(pose, obj, pix, cam, iters=polish_iters)
        ok = (torch.isfinite(polished.R).all(dim=(-2, -1))
              & torch.isfinite(polished.t).all(dim=-1))
        keep = (any_valid & ok)[..., None]
        pose = Pose(torch.where(keep[..., None], polished.R, pose.R),
                    torch.where(keep, polished.t, pose.t))
    return pose, any_valid
