"""Numpy-only reader of the reference's npz weight artifacts (the format
of dsac_tpu/utils/params_io.py) and the carry-over into PyTorch modules.

Keys are ``|``-joined Flax parameter paths, e.g. ``params|Conv_3|kernel``;
kernels are HWIO, stored f16.  Nothing converted is written to disk.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from dsac_tpu_torch.models.coord_net import DenseCoordNet


def load_params_npz(path: str | Path) -> dict[str, np.ndarray]:
    """The flat {key: array} dict of an npz artifact."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def coord_net_from_flax(flat: dict[str, np.ndarray]) -> DenseCoordNet:
    """A DenseCoordNet holding the Flax parameters, as f32 OIHW."""
    width = flat["params|Conv_0|kernel"].shape[-1]
    net = DenseCoordNet(width=width)
    with torch.no_grad():
        for i, conv in enumerate(net.convs):
            kernel = flat[f"params|Conv_{i}|kernel"].astype(np.float32)
            bias = flat[f"params|Conv_{i}|bias"].astype(np.float32)
            w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
            if w.shape != conv.weight.shape:
                raise ValueError(f"Conv_{i}: kernel {tuple(w.shape)} does "
                                 f"not fit {tuple(conv.weight.shape)}")
            conv.weight.copy_(w)
            conv.bias.copy_(torch.from_numpy(bias))
    return net


def load_coord_net_npz(path: str | Path,
                       device: torch.device | str = "cuda") -> DenseCoordNet:
    """Read a coordinate-net artifact (e.g. artifacts/coord_e2e.npz)."""
    from dsac_tpu_torch import resolve_device
    return coord_net_from_flax(load_params_npz(path)).to(
        resolve_device(device)).eval()
