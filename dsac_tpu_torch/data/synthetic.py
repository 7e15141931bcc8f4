"""The reference's default procedural room, rendered with PyTorch on the
device (port of dsac_tpu/data/synthetic.py, default room only).

The reference draws its texture parameters and the bench poses from
``jax.random``, which PyTorch cannot reproduce, so both come from the
fixture ``room_default.json`` written from the reference: the texture's
12 wave frequencies, directions and phases (seed 1305), and the 64 bench
poses of keys 9000..9063 (bench.py:135), scene -> eye, which are also the
ground truth.  Per-frame noise, occluders and the archetypes are not
ported.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from dsac_tpu_torch import resolve_device
from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose, invert

FIXTURE = Path(__file__).resolve().parent / "room_default.json"
ROOM_MM = (4000.0, 3000.0, 4000.0)  # the box [0, w] x [0, h] x [0, d]


class SyntheticScene:
    """The default room: an axis-aligned box textured by a sinusoid
    mixture of the 3D surface point.  Frames are (B, H, W, 3) RGB in
    [0, 255] with exact depth and scene coordinates."""

    def __init__(self, width: int = 640, height: int = 480,
                 focal: float = 525.0, device: torch.device | str = "cuda"):
        fx = json.loads(FIXTURE.read_text())
        self.width, self.height, self.focal = width, height, focal
        self.device = resolve_device(device)
        tex = fx["texture"]
        f32 = dict(dtype=torch.float32, device=self.device)
        self.freqs = torch.tensor(tex["freqs"], **f32)  # (M,)
        self.dirs = torch.tensor(tex["dirs"], **f32)  # (M, 3)
        self.phases = torch.tensor(tex["phases"], **f32)  # (M, 3)
        poses = fx["bench_poses"]
        self.bench_poses = Pose(torch.tensor(poses["R"], **f32),
                                torch.tensor(poses["t"], **f32))

    @property
    def camera(self) -> Camera:
        return Camera.make(self.focal, self.width, self.height)

    def texture(self, points_mm: torch.Tensor) -> torch.Tensor:
        """Scene points (..., 3) -> RGB in [0, 255] (..., 3)."""
        proj = points_mm @ self.dirs.T  # (..., M)
        arg = proj[..., :, None] * self.freqs[:, None] + self.phases
        mix = torch.mean(torch.sin(arg), dim=-2)
        return (mix * 0.5 + 0.5) * 255.0

    def render(self, pose: Pose):
        """Render scene -> eye poses R (B, 3, 3), t (B, 3).

        Returns rgb (B, H, W, 3) float32 in [0, 255], depth (B, H, W) mm
        and coords (B, H, W, 3) ground-truth scene coordinates, mm.
        """
        cam = self.camera
        inv = invert(pose)
        origin = inv.t  # (B, 3) camera centre in the scene frame
        dev = pose.t.device
        u = torch.arange(self.width, dtype=torch.float32, device=dev) + 0.5
        v = torch.arange(self.height, dtype=torch.float32, device=dev) + 0.5
        vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H, W)
        bx = (uu - cam.cx) / cam.focal
        by = -(vv - cam.cy) / cam.focal
        d_eye = torch.stack([bx, by, -torch.ones_like(bx)], dim=-1)
        d_scene = torch.einsum("bij,hwj->bhwi", inv.R, d_eye)

        bounds = torch.tensor(ROOM_MM, dtype=torch.float32, device=dev)
        o = origin[:, None, None, :]
        d_safe = torch.where(torch.abs(d_scene) < 1e-9, 1e-9, d_scene)
        t_hi = (bounds - o) / d_safe
        t_lo = (0.0 - o) / d_safe
        t = torch.where(d_scene > 0, t_hi, t_lo).amin(dim=-1)  # (B, H, W)
        points = o + t[..., None] * d_scene
        return self.texture(points), t, points
