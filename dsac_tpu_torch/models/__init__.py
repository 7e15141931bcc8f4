"""The scene-coordinate CNNs and the hypothesis-score CNN (port of
dsac_tpu/models), their default initialisation, and the loading of
parameters into them."""

import math

import torch

from dsac_tpu_torch.models.coord_net import (DenseCoordNet, PatchCoordNet,
                                             gather_dense_coords)
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


def load_exact(net: torch.nn.Module, state: dict[str, torch.Tensor]
               ) -> torch.nn.Module:
    """``net`` after ``net.load_state_dict(state)``, but every key and
    shape must match: ValueError otherwise, and nothing is loaded."""
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    if want != got:
        diff = sorted(k for k in want.keys() | got.keys()
                      if want.get(k) != got.get(k))
        raise ValueError(f"{type(net).__name__}: parameters do not fit: "
                         + ", ".join(f"{k} {got.get(k)} for {want.get(k)}"
                                     for k in diff[:4]))
    net.load_state_dict(state)
    return net


def coord_net_for_state(state: dict[str, torch.Tensor],
                        arch: str | None = None) -> torch.nn.Module:
    """A coordinate net holding ``state`` (keys ``convs.i.*`` and
    ``dense.i.*``), its arch read from it: dense layers make the patch
    net, a 12-channel Conv_0 the s2d stem, 14 convs the context stack.  A
    ``state`` of another arch than ``arch``, or one that does not fit its
    net in full, raises ValueError."""
    n_convs = sum(1 for k in state if k.startswith("convs.")
                  and k.endswith(".weight"))
    conv0 = state.get("convs.0.weight")
    if conv0 is None:
        raise ValueError("no convs.0.weight: not a coordinate net")
    if any(k.startswith("dense.") for k in state):
        found = "patch"
        net = PatchCoordNet(width_mult=conv0.shape[0] / 64,
                            dense_mult=state["dense.0.weight"].shape[0]
                            / 4096)
    else:
        found = ("dense_s2d" if conv0.shape[1] == 12 else
                 "dense_ctx" if n_convs == 14 else "dense")
        net = DenseCoordNet(width=conv0.shape[0], s2d=found == "dense_s2d",
                            context=found == "dense_ctx")
    if arch is not None and arch != found:
        raise ValueError(f"the weights are a {found} coordinate net, not "
                         f"{arch}")
    return load_exact(net, state)
