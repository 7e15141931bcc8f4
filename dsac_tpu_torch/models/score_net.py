"""The hypothesis-score CNN (port of dsac_tpu/models/score_net.py).

A (40, 40) reprojection-error map per hypothesis, mean-normalised
(d - 45), goes through ten 3x3 convolutions (32 .. 512 channels, stride 2
down to 1x1) and three dense layers (512 -> 1024 -> 1024 -> 1) to one
score.  Runs like the Flax reference: each convolution and the first two
dense layers cast their input and weights to ``dtype`` (bf16) and add the
bias in ``dtype``; the last dense layer runs in f32 on the bf16
activations.  Padding is Flax's explicit (1, 1) on every convolution,
strided ones included, except Conv_7, which is VALID (5 -> 2).  The
convolutions run on cuDNN: the reference has no Pallas kernel for this net.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

SCORE_MEAN = 45.0  # NetConfig.score_mean, train_score.lua:24


class ScoreNet(nn.Module):
    """(M, 40, 40) or (M, 40, 40, 1) diff-maps -> (M,) scores."""

    def __init__(self, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.width_mult = width_mult
        self.dtype = dtype

        def w(f):
            return max(8, int(f * width_mult))

        # (out channels, stride, padding) of Conv_0 .. Conv_9
        self.spec = [(w(32), 1, 1), (w(32), 2, 1), (w(64), 1, 1),
                     (w(64), 2, 1), (w(128), 1, 1), (w(128), 2, 1),
                     (w(256), 1, 1), (w(256), 2, 0), (w(512), 1, 1),
                     (w(512), 2, 1)]
        cin = 1
        self.convs = nn.ModuleList()
        for cout, _s, _p in self.spec:
            self.convs.append(nn.Conv2d(cin, cout, 3))
            cin = cout
        fc = max(16, int(1024 * width_mult))
        self.dense = nn.ModuleList([nn.Linear(cin, fc), nn.Linear(fc, fc),
                                    nn.Linear(fc, 1)])

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        if d.dim() == 4:
            d = d[..., 0]
        x = ((d - SCORE_MEAN) / 1.0)[:, None].to(self.dtype)  # (M, 1, G, G)
        for conv, (_cout, s, p) in zip(self.convs, self.spec):
            x = F.conv2d(x, conv.weight.to(self.dtype), None, stride=s,
                         padding=p)
            x = torch.relu(x + conv.bias.to(self.dtype)[:, None, None])
        x = x.permute(0, 2, 3, 1).flatten(1)  # Flax's NHWC flatten order
        for fc in self.dense[:2]:
            x = torch.relu(F.linear(x, fc.weight.to(self.dtype))
                           + fc.bias.to(self.dtype))
        last = self.dense[2]
        x = F.linear(x.float(), last.weight.float(), last.bias.float())
        return x[:, 0]

    def flops_per_map(self, grid: int = 40) -> int:
        """Multiply-adds x 2 of the convolutions and dense layers for one
        (grid, grid) map."""
        flops, cin, size = 0, 1, grid
        for cout, s, p in self.spec:
            size = (size + 2 * p - 3) // s + 1
            flops += 2 * size * size * 9 * cin * cout
            cin = cout
        for fc in self.dense:
            flops += 2 * fc.in_features * fc.out_features
        return flops
