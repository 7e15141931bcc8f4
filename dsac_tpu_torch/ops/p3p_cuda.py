"""Batched 4-point P3P: the CUDA kernel (csrc/p3p.cu) and its plain
PyTorch version.

Port of dsac_tpu/ops/p3p_pallas.py:p3p_solve_pallas.  ``p3p_solve`` takes
a CUDA tensor to the kernel and a CPU tensor to ``p3p_solve_ref``; it
counts its kernel launches in ``p3p_solve.launches``.  ``p3p_layout``
picks the kernel's threads per lane (a quad of 4, one per quartic root,
or 1) and its block size from the number of lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.p3p import solve_pnp_minimal
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.ops import _build


def _worst_support_error(pose: Pose, obj: torch.Tensor, pix: torch.Tensor,
                         cam: Camera) -> torch.Tensor:
    """Max reprojection error over the 4 support points, with the
    kernel's depth guard (|z| < 1e-8 -> -1e-8)."""
    eye = obj @ pose.R.transpose(-1, -2) + pose.t[..., None, :]
    z = eye[..., 2]
    z = torch.where(torch.abs(z) < 1e-8, -1e-8, z)
    du = pix[..., 0] - (-cam.focal * eye[..., 0] / z + cam.cx)
    dv = pix[..., 1] - (cam.focal * eye[..., 1] / z + cam.cy)
    return torch.sqrt(du * du + dv * dv + 1e-8).amax(dim=-1)


def p3p_solve_ref(obj: torch.Tensor, pix: torch.Tensor, cam: Camera
                  ) -> tuple[Pose, torch.Tensor, torch.Tensor]:
    """Plain version: geometry/p3p.py's solver without its GN polish.

    obj: (M, 4, 3) mm; pix: (M, 4, 2).  Returns (Pose (M,), valid (M,)
    bool, worst (M,) worst support-point reprojection error).
    """
    pose, valid = solve_pnp_minimal(obj, pix, cam, polish_iters=0)
    return pose, valid, _worst_support_error(pose, obj, pix, cam)


class P3PLayout(NamedTuple):
    """How csrc/p3p.cu lays the lanes out: ``threads_per_lane`` threads
    for each attempt lane (4: one per quartic root; or 1), in blocks of
    ``block`` threads."""

    threads_per_lane: int
    block: int


def check_p3p_layout(layout: P3PLayout) -> None:
    """Raise ValueError unless csrc/p3p.cu takes ``layout``."""
    tpl, block = layout
    if tpl not in (1, 4) or not (32 <= block <= 1024 and block % 32 == 0):
        raise ValueError(f"P3P layout {tuple(layout)}: threads per lane "
                         "must be 1 or 4, the block 32 to 1,024 threads "
                         "in whole warps")


def p3p_layout(M: int, sm_count: int) -> P3PLayout:
    """The P3P kernel's layout for M lanes on a card of ``sm_count`` SMs,
    in blocks of 64 threads: a quad of threads a lane while one thread a
    lane would leave fewer than 4 warps an SM (M < 128 x sm_count: a serve
    batch's 2,048 and 3,840 lanes, 1.4x faster than one thread a lane on
    the H100), else one thread a lane (fixed-T sampling's 32,768 lanes,
    where the quad's four copies of the root-independent prefix cost more
    than its shorter chain saves: 0.0130 against 0.0148 ms; PERF.md)."""
    return P3PLayout(4 if M < 4 * 32 * sm_count else 1, 64)


def launch_p3p(obj: torch.Tensor, pix: torch.Tensor, cam: Camera,
               layout: P3PLayout | None = None
               ) -> tuple[Pose, torch.Tensor, torch.Tensor]:
    """One launch of the P3P kernel on checked CUDA tensors, in
    ``layout`` (``p3p_layout``'s by default).  Not counted: the caller
    counts its launches."""
    M = obj.shape[0]
    dev = obj.device
    if layout is None:
        layout = p3p_layout(M, _build.sm_count(dev))
    check_p3p_layout(layout)
    R = torch.empty((M, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((M, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((M,), dtype=torch.bool, device=dev)
    worst = torch.empty((M,), dtype=torch.float32, device=dev)
    _build.launch("dsac_p3p_solve", dev, obj.data_ptr(), pix.data_ptr(),
                  M, cam.focal, cam.cx, cam.cy, *layout, R.data_ptr(),
                  t.data_ptr(), valid.data_ptr(), worst.data_ptr())
    return Pose(R, t), valid, worst


def p3p_solve(obj: torch.Tensor, pix: torch.Tensor, cam: Camera
              ) -> tuple[Pose, torch.Tensor, torch.Tensor]:
    """Batched minimal P3P, same interface as ``p3p_solve_ref``."""
    M = obj.shape[0]
    dev = obj.device
    _build.check("obj", obj, (M, 4, 3), dev)
    _build.check("pix", pix, (M, 4, 2), dev)
    if dev.type == "cpu":
        return p3p_solve_ref(obj, pix, cam)
    if dev.type != "cuda":
        raise ValueError(f"p3p_solve runs on cuda or cpu, not {dev}")
    out = launch_p3p(obj, pix, cam)
    p3p_solve.launches += 1
    return out


p3p_solve.launches = 0
