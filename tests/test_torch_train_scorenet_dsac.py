"""The port's end-to-end DSAC training against dsac_tpu.pipeline.train
with a score CNN, in refine modes "unroll" (autograd through the 8 x 2
IRLS) and "implicit" (the refine kernel's fixed point and one
differentiable GN step; on the CPU the kernel is its plain version,
against the reference's Pallas kernel in interpret mode), on the case of
tests/test_torch_train_scorenet_softam.py: the toy's coordinates with 40
mm of noise, ScoreNet weights of seed 2.  "implicit_jnp" is held in
tests/test_torch_train_scorenet.py.

Bars: the objective to 1e-2 relative + 0.2; the coordinate gradient and
the score gradient (over all ScoreNet parameters, in Flax's layout) each
cosine >= 0.99 and norm ratio 0.9-1.1.
"""

import pytest

from test_torch_train import hold
from test_torch_train_scorenet import hold_score, scorenet_case
from torch_problems import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def case():
    return scorenet_case(noise_mm=40.0, seed=2)


@pytest.mark.parametrize("mode", [False, "implicit"],
                         ids=["unroll", "implicit"])
def test_dsac_objective_and_gradients_match_reference(case, mode):
    (ref_obj, ref_gc, ref_gs), (obj, aux, gc, gs) = case.run(False, mode)
    assert float(aux["entropy"][0]) > 0.5  # the softmax is spread
    hold(obj, ref_obj, gc, ref_gc)
    hold_score(case.net, gs, ref_gs)
