"""Numpy-only reader and writer of the reference's npz weight artifacts
(the format of dsac_tpu/utils/params_io.py) and the carry-over between
them and PyTorch modules.

Keys are ``|``-joined Flax parameter paths, e.g. ``params|Conv_3|kernel``;
convolution kernels are HWIO and become OIHW, dense kernels are
(in, out) and become ``nn.Linear``'s (out, in); all are stored f16 and
carried over as f32.  ``save_params_npz`` writes a port's net back in the
same layout, so that the reference and the port's ``--weights`` serve a
model the port trained.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from dsac_tpu_torch.models import ScoreNet, coord_net_for_state, load_exact


def load_params_npz(path: str | Path) -> dict[str, np.ndarray]:
    """The flat {key: array} dict of an npz artifact."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def state_from_flax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The port's state dict (``convs.i.*``, ``dense.i.*``, f32) of a
    Flax-layout flat dict: ``Conv_i`` HWIO kernels become OIHW, ``Dense_i``
    (in, out) kernels (out, in)."""
    state = {}
    for key, arr in flat.items():
        _params, layer, leaf = key.split("|")
        group, idx = layer.split("_")
        name = {"Conv": "convs", "Dense": "dense"}.get(group)
        if name is None or leaf not in ("kernel", "bias"):
            raise ValueError(f"no port name for parameter {key}")
        a = arr.astype(np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if group == "Conv" else a.T
        state[f"{name}.{idx}.{'weight' if leaf == 'kernel' else 'bias'}"] = \
            torch.from_numpy(np.ascontiguousarray(a))
    return state


def coord_net_from_flax(flat: dict[str, np.ndarray],
                        arch: str | None = None) -> torch.nn.Module:
    """The coordinate net holding the Flax parameters, as f32: its arch
    read from them (models/__init__.py:coord_net_for_state) and, when
    ``arch`` is given, checked against it; width (and for the patch net
    the dense width) from Conv_0 (and Dense_0).  Parameters that do not
    fit one net in full raise ValueError."""
    return coord_net_for_state(state_from_flax(flat), arch)


def score_net_from_flax(flat: dict[str, np.ndarray],
                        dtype: torch.dtype = torch.bfloat16) -> ScoreNet:
    """A ScoreNet holding the Flax parameters, as f32 OIHW convolutions
    and (out, in) dense weights; width_mult is read from Conv_9's width
    (512 x width_mult)."""
    width_mult = flat["params|Conv_9|kernel"].shape[-1] / 512
    return load_exact(ScoreNet(width_mult=width_mult, dtype=dtype),
                      state_from_flax(flat))


def to_flax_flat(net: torch.nn.Module,
                 values: dict[str, torch.Tensor] | None = None
                 ) -> dict[str, np.ndarray]:
    """The Flax-layout flat dict of a coordinate net's or ScoreNet's
    parameters, or of ``values`` keyed like ``net.named_parameters()``
    (their gradients, say), as f32 numpy."""
    values = dict(net.named_parameters()) if values is None else values
    flat = {}
    for name, v in values.items():
        group, idx, kind = name.split(".")
        a = v.detach().float().cpu().numpy()
        if group == "convs":
            key = f"params|Conv_{idx}|"
            a = a.transpose(2, 3, 1, 0) if kind == "weight" else a
        elif group == "dense":
            key = f"params|Dense_{idx}|"
            a = a.T if kind == "weight" else a
        else:
            raise ValueError(f"no Flax name for parameter {name}")
        flat[key + ("kernel" if kind == "weight" else "bias")] = \
            np.ascontiguousarray(a)
    return flat


def save_params_npz(path: str | Path, net: torch.nn.Module,
                    dtype=np.float16) -> None:
    """Write a net in the reference's npz layout (params_io.py:21), f32
    arrays stored as ``dtype`` (f16 by default, as the reference does)."""
    out = {k: v.astype(dtype) for k, v in to_flax_flat(net).items()}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)


def load_coord_net_npz(path: str | Path,
                       device: torch.device | str = "cuda",
                       arch: str | None = None) -> torch.nn.Module:
    """Read a coordinate-net artifact (e.g. artifacts/coord_e2e.npz, or
    coord_e2e_patch.npz for the patch net), of ``arch`` if given."""
    from dsac_tpu_torch import resolve_device
    return coord_net_from_flax(load_params_npz(path), arch).to(
        resolve_device(device)).eval()


def load_score_net_npz(path: str | Path,
                       device: torch.device | str = "cuda") -> ScoreNet:
    """Read a score-net artifact (e.g. artifacts/score_e2e.npz)."""
    from dsac_tpu_torch import resolve_device
    return score_net_from_flax(load_params_npz(path)).to(
        resolve_device(device)).eval()
