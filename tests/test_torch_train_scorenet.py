"""The port's end-to-end DSAC training against dsac_tpu.pipeline.train
with a score CNN: the toy coordinates of tests/test_torch_train.py scored
by a ScoreNet at width_mult 0.25 with random weights
(torch_problems.random_score_flat), in f32 on both sides, refine mode
"implicit_jnp".  Here the softmax is spread (entropy ~3 bits over 16
hypotheses), so the score gradient is held too.  The other refine modes,
and SoftAM, are held on this case's builder (scorenet_case) in
tests/test_torch_train_scorenet_dsac.py, _softam.py and _converged.py.

The reference runs op by op (its score net alone jitted), not under
jax.jit as a whole: jitted, XLA's fused f32
arithmetic flips the P3P validity of two ill-conditioned attempts of
hypothesis 12 (one gains a solution at 0.2 px, another loses its
solution), so that the jitted reference serves that lane another minimal
set (249 mm away) than both its own op-by-op run and the port, which
agree on every attempt.  With the toy's one-hot softmax the lane carries
no weight; with the score CNN it does.

Bars: the objective to 1e-2 relative + 0.2; the coordinate gradient and
the score gradient (over all ScoreNet parameters, in Flax's layout) each
cosine >= 0.99 and norm ratio 0.9-1.1.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.models.score_net import ScoreNet as FlaxScoreNet
from dsac_tpu_torch.utils.params_io import score_net_from_flax, to_flax_flat
from test_torch_score_net import flax_params
from test_torch_train import cosine_ratio, hold, make_toy, port, reference
from torch_problems import one_torch_thread, random_score_flat  # noqa: F401

MODE = "implicit_jnp"


def scorenet_case(noise_mm=5.0, seed=1305, jit=True):
    """The toy at ``noise_mm`` of coordinate noise, scored by ScoreNet
    weights of ``seed`` on both sides.  ``run(softam, mode)`` returns the
    reference's (objective, coordinate gradient, score gradient tree) and
    the port's (objective, aux, coordinate gradient, score gradients)."""
    toy = make_toy(noise_mm)
    flat = random_score_flat(np.random.default_rng(seed), 0.25)
    apply = jax.jit(FlaxScoreNet(dtype=jnp.float32, width_mult=0.25).apply)
    net = score_net_from_flax(flat, dtype=torch.float32)

    def run(softam, mode):
        return (reference(toy, softam, mode, score_apply=apply,
                          sp=flax_params(flat), jit=jit),
                port(toy, softam, mode, score_net=net))
    return types.SimpleNamespace(run=run, net=net)


def score_vectors(net, gs, ref_gs):
    """The port's and the reference's score gradients as two flat arrays,
    in Flax's layout and key order."""
    got = to_flax_flat(net, gs)
    ref = {f"params|{layer}|{kind}": np.asarray(v)
           for layer, leaves in ref_gs["params"].items()
           for kind, v in leaves.items()}
    assert sorted(got) == sorted(ref)
    keys = sorted(got)
    return (np.concatenate([got[k].ravel() for k in keys]),
            np.concatenate([ref[k].ravel() for k in keys]))


def hold_score(net, gs, ref_gs):
    cos, ratio = cosine_ratio(*score_vectors(net, gs, ref_gs))
    assert cos >= 0.99 and 0.9 <= ratio <= 1.1, (cos, ratio)


@pytest.fixture(scope="module")
def case():
    c = scorenet_case(jit=False)
    return c.run(False, MODE) + (c.net,)


def test_objective_and_coordinate_gradient(case):
    (ref_obj, ref_gc, _), (obj, aux, gc, _), _ = case
    hold(obj, ref_obj, gc, ref_gc)
    assert float(aux["entropy"][0]) > 1.0  # the softmax is spread


def test_score_gradient(case):
    (_, _, ref_gs), (_, _, _, gs), net = case
    hold_score(net, gs, ref_gs)
