"""Batched 4-point P3P: the CUDA kernel (csrc/p3p.cu) and its plain
PyTorch version.

Port of dsac_tpu/ops/p3p_pallas.py:p3p_solve_pallas.  ``p3p_solve`` takes
a CUDA tensor to the kernel and a CPU tensor to ``p3p_solve_ref``; it
counts its kernel launches in ``p3p_solve.launches``.
"""

from __future__ import annotations

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
    R = torch.empty((M, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((M, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((M,), dtype=torch.bool, device=dev)
    worst = torch.empty((M,), dtype=torch.float32, device=dev)
    _build.launch("dsac_p3p_solve", obj.data_ptr(), pix.data_ptr(), M,
                  cam.focal, cam.cx, cam.cy, R.data_ptr(), t.data_ptr(),
                  valid.data_ptr(), worst.data_ptr(), _build.stream_of(obj))
    p3p_solve.launches += 1
    return Pose(R, t), valid, worst


p3p_solve.launches = 0
