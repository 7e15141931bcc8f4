"""The port's DenseCoordNet, with the real artifacts/coord_e2e.npz weights
carried over, against the Flax reference on the same image.

Tolerance: both run bf16 convolutions (f32 accumulation, bf16 rounding of
each layer's output, bias added in bf16) and an f32 last layer, but round
in different places; at width 64 over nine bf16 layers the coordinates
(metres, |x| up to ~4.5) agree to about a centimetre: atol 0.03 m, and
the mean error under 5 mm.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.models.coord_net import DenseCoordNet as FlaxNet
from dsac_tpu.models.coord_net import gather_dense_coords as jax_gather
from dsac_tpu_torch.models.coord_net import (DenseCoordNet, _same_pads,
                                             gather_dense_coords)
from dsac_tpu_torch.utils.params_io import (coord_net_from_flax,
                                            load_coord_net_npz,
                                            load_params_npz)

WEIGHTS = Path(__file__).resolve().parent.parent / "artifacts" / \
    "coord_e2e.npz"


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(1305)
    # smooth structure plus texture, like the synthetic room's frames
    y, x = np.mgrid[0:96, 0:128].astype(np.float32)
    base = 127 + 80 * np.sin(x[..., None] * [0.11, 0.07, 0.05]
                             + y[..., None] * [0.03, 0.09, 0.06])
    return (base + rng.normal(size=base.shape) * 10).clip(0, 255).astype(
        np.float32)[None]


def test_same_padding_matches_flax():
    assert _same_pads(480, 3, 1) == (1, 1)
    assert _same_pads(480, 3, 2) == (0, 1)  # not (1, 1)
    assert _same_pads(61, 3, 2) == (1, 1)
    assert _same_pads(60, 1, 1) == (0, 0)


def test_trained_weights_match_flax_apply(image):
    flat = load_params_npz(WEIGHTS)
    net = coord_net_from_flax(flat)
    assert net.convs[0].weight.shape == (64, 3, 3, 3)
    assert net.convs[9].weight.shape == (3, 512, 1, 1)
    with torch.no_grad():
        got = net(torch.from_numpy(image)).numpy()

    # the f32 parameter tree that dsac_tpu.utils.params_io.load_params_npz
    # restores into (built directly: Flax's eager init costs ~15 s here)
    params = {}
    for key, arr in flat.items():
        *path, leaf = key.split("|")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr, jnp.float32)
    ref = np.asarray(jax.jit(FlaxNet(width=64).apply)(params,
                                                      jnp.asarray(image)))
    assert got.shape == ref.shape == (1, 12, 16, 3)
    np.testing.assert_allclose(got, ref, atol=0.03)
    assert np.abs(got - ref).mean() < 0.005


def test_loader_resolves_device_and_refuses_missing_cuda():
    net = load_coord_net_npz(WEIGHTS, device="cpu")
    assert not net.training
    assert net.convs[0].weight.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            load_coord_net_npz(WEIGHTS)  # defaults to cuda


def test_random_width_roundtrip(rng):
    """A narrow random net: the carry-over is exact (OIHW of HWIO)."""
    flat = {}
    cin = 3
    for i, (cout, k, _s) in enumerate(DenseCoordNet(width=8).spec):
        flat[f"params|Conv_{i}|kernel"] = rng.normal(
            size=(k, k, cin, cout)).astype(np.float16)
        flat[f"params|Conv_{i}|bias"] = rng.normal(size=cout).astype(
            np.float16)
        cin = cout
    net = coord_net_from_flax(flat)
    k = flat["params|Conv_4|kernel"].astype(np.float32)
    np.testing.assert_array_equal(net.convs[4].weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))


def test_gather_dense_coords_matches_reference(rng):
    cmap = rng.normal(size=(2, 12, 16, 3)).astype(np.float32)
    pix = rng.integers(0, [128, 96], size=(2, 50, 2))
    pix[0, 0] = [0, 0]
    pix[0, 1] = [127, 95]  # clamped at both borders
    got = gather_dense_coords(torch.from_numpy(cmap), torch.from_numpy(pix))
    for b in range(2):
        ref = jax_gather(jnp.asarray(cmap[b]), jnp.asarray(pix[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref),
                                   atol=1e-6)
