"""Fully convolutional stride-8 scene-coordinate regressor (port of
dsac_tpu/models/coord_net.py:DenseCoordNet, plain stem).

Runs like the Flax reference: each layer casts its input and weights to
bf16 and adds the bias in bf16; the last 1x1 conv runs in f32.  Flax's
``padding="SAME"`` is reproduced exactly: a stride-2 3x3 conv on an even
input pads (0, 1), not (1, 1), so padding is explicit (``F.pad``) and the
convolutions themselves pad nothing.  The public layout is NHWC, as in
the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA/Flax SAME padding (low, high) of one spatial axis."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class DenseCoordNet(nn.Module):
    """(B, H, W, 3) RGB in [0, 255] -> (B, H/8, W/8, 3) scene coordinates
    in metres."""

    def __init__(self, width: int = 64):
        super().__init__()
        c = width
        # (out channels, kernel, stride) of Conv_0 .. Conv_9
        self.spec = [(c, 3, 1), (c, 3, 2), (2 * c, 3, 1), (2 * c, 3, 2),
                     (4 * c, 3, 1), (4 * c, 3, 2), (8 * c, 3, 1),
                     (8 * c, 1, 1), (8 * c, 1, 1), (3, 1, 1)]
        cin = 3
        self.convs = nn.ModuleList()
        for cout, k, _s in self.spec:
            self.convs.append(nn.Conv2d(cin, cout, k, padding=0))
            cin = cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x - 127.0) / 1.0
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        last = len(self.convs) - 1
        for i, (conv, (_cout, k, s)) in enumerate(zip(self.convs,
                                                      self.spec)):
            dtype = torch.float32 if i == last else torch.bfloat16
            ph = _same_pads(x.shape[2], k, s)
            pw = _same_pads(x.shape[3], k, s)
            x = x.to(dtype)
            if any(ph + pw):
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            x = F.conv2d(x, conv.weight.to(dtype), None, stride=s)
            x = x + conv.bias.to(dtype)[:, None, None]
            if i != last:
                x = torch.relu(x)
        return x.permute(0, 2, 3, 1).float().contiguous()


def gather_dense_coords(coord_map: torch.Tensor, pix: torch.Tensor,
                        stride: int = 8) -> torch.Tensor:
    """Bilinear lookup of stride-s coordinate maps at pixel locations.

    coord_map: (B, H/s, W/s, 3); pix: (B, N, 2) full-resolution (x, y).
    Returns (B, N, 3).
    """
    B, gh, gw, _ = coord_map.shape
    fx = torch.clamp(pix[..., 0].float() / stride - 0.5, 0, gw - 1)
    fy = torch.clamp(pix[..., 1].float() / stride - 0.5, 0, gh - 1)
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    x1 = torch.clamp(x0 + 1, max=gw - 1)
    y1 = torch.clamp(y0 + 1, max=gh - 1)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    b = torch.arange(B, device=coord_map.device)[:, None]
    c00 = coord_map[b, y0, x0]
    c01 = coord_map[b, y0, x1]
    c10 = coord_map[b, y1, x0]
    c11 = coord_map[b, y1, x1]
    return ((1 - wy) * ((1 - wx) * c00 + wx * c01)
            + wy * ((1 - wx) * c10 + wx * c11))
