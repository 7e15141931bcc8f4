"""The port's ScoreNet against the Flax reference (dsac_tpu/models/
score_net.py) on the same numpy-seeded diff-maps.

Tolerances:
  f32, random weights at width_mult 0.25: 1e-5 relative and absolute.
      Both run true f32 convolutions and dense layers; the measured gap is
      ~3e-7 on scores of ~0.2.
  bf16, the trained artifacts/score_e2e.npz on a random (64, 40, 40)
      batch: atol 1.0 on scores of -420 .. -560 (spread ~29), and the
      same top-1 index.  Both cast every layer's input and weights to
      bf16 and add the bias in bf16, but round in different places; the
      measured gap is 0.29 at most, 0.05 on average, and the two best
      scores are 1.5 apart.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.models.score_net import ScoreNet as FlaxScoreNet
from dsac_tpu_torch.models.score_net import ScoreNet
from dsac_tpu_torch.utils.params_io import (load_params_npz,
                                            load_score_net_npz,
                                            score_net_from_flax)
from torch_problems import random_score_flat, one_torch_thread  # noqa: F401

WEIGHTS = Path(__file__).resolve().parent.parent / "artifacts" / \
    "score_e2e.npz"


def flax_params(flat):
    """The f32 parameter tree that Flax's apply takes, from a flat dict."""
    params = {}
    for key, arr in flat.items():
        *path, leaf = key.split("|")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr, jnp.float32)
    return params


def test_f32_random_weights_match_flax(rng):
    flat = random_score_flat(rng, 0.25)
    maps = rng.uniform(0, 100, (16, 40, 40)).astype(np.float32)
    ref = np.asarray(FlaxScoreNet(dtype=jnp.float32, width_mult=0.25).apply(
        flax_params(flat), jnp.asarray(maps)))
    net = score_net_from_flax(flat, dtype=torch.float32)
    assert net.width_mult == 0.25 and net.spec[0][0] == 8
    assert net.dense[0].in_features == 128 and net.dense[0].out_features == 256
    with torch.no_grad():
        got = net(torch.from_numpy(maps)).numpy()
        got4 = net(torch.from_numpy(maps[..., None])).numpy()
    assert got.shape == (16,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got4, got)  # (M, 40, 40, 1) input


def test_trained_weights_match_flax_bf16(rng):
    flat = load_params_npz(WEIGHTS)
    maps = rng.uniform(0, 100, (64, 40, 40)).astype(np.float32)
    ref = np.asarray(jax.jit(FlaxScoreNet().apply)(flax_params(flat),
                                                   jnp.asarray(maps)))
    net = score_net_from_flax(flat)
    assert net.width_mult == 1.0 and net.dtype == torch.bfloat16
    with torch.no_grad():
        got = net(torch.from_numpy(maps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.0)
    assert int(np.argmax(got)) == int(np.argmax(ref))


def test_carry_over_layouts(rng):
    """OIHW of HWIO convolutions, (out, in) of (in, out) dense kernels."""
    flat = random_score_flat(rng, 0.25)
    net = score_net_from_flax(flat, dtype=torch.float32)
    np.testing.assert_array_equal(
        net.convs[7].weight.detach().numpy(),
        flat["params|Conv_7|kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(net.dense[1].weight.detach().numpy(),
                                  flat["params|Dense_1|kernel"].T)
    bad = dict(flat)
    bad["params|Dense_0|kernel"] = flat["params|Dense_0|kernel"][:-1]
    with pytest.raises(ValueError):
        score_net_from_flax(bad)


def test_padding_and_cost_of_the_full_net():
    """Explicit (1, 1) padding on every convolution but the VALID Conv_7
    (5 -> 2); Conv_9 is stride 2 with (1, 1), 2 -> 1; 89.3 MFLOP a map."""
    net = ScoreNet()
    assert [p for _c, _s, p in net.spec] == [1] * 7 + [0, 1, 1]
    sizes, size = [], 40
    for _c, s, p in net.spec:
        size = (size + 2 * p - 3) // s + 1
        sizes.append(size)
    assert sizes == [40, 20, 20, 10, 10, 5, 5, 2, 2, 1]
    assert abs(net.flops_per_map() / 1e6 - 89.3) < 0.05


def test_loader_resolves_device_and_refuses_missing_cuda():
    net = load_score_net_npz(WEIGHTS, device="cpu")
    assert not net.training
    assert net.convs[0].weight.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            load_score_net_npz(WEIGHTS)  # defaults to cuda
