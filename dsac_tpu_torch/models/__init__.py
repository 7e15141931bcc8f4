"""The scene-coordinate CNN and the hypothesis-score CNN (port of
dsac_tpu/models), and their default initialisation."""

import math

import torch

from dsac_tpu_torch.models.coord_net import DenseCoordNet, gather_dense_coords
from dsac_tpu_torch.models.score_net import ScoreNet

# std of a unit normal truncated to [-2, 2]: lecun_normal divides by it
_TRUNC_STD = 0.87962566103423978


def init_like_flax(net: torch.nn.Module, generator: torch.Generator
                   ) -> torch.nn.Module:
    """Re-initialise every convolution and dense layer as Flax does by
    default: kernels lecun_normal (a normal truncated at 2 sigma, variance
    1 / fan_in), biases zero.  The draws come from ``generator``; they are
    not Flax's."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
                w = torch.empty_like(m.weight)
                torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0,
                                            generator=generator)
                m.weight.copy_(w * std)
                m.bias.zero_()
    return net
