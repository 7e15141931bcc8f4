"""The port's end-to-end SoftAM training against dsac_tpu.pipeline.train
with a score CNN, in the three refine modes SoftAM trains with: "unroll"
(autograd through the 8 x 2 IRLS), "implicit_jnp" (the PyTorch IRLS's
fixed point, one differentiable GN step, the init-pose sensitivity by
autograd through the IRLS) and "implicit" (the refine kernel's fixed
point, and the init-pose sensitivity by the kernel's finite-difference
backward, ops/gn_cuda.py:InitSensitiveRefine; on the CPU the kernel is its
plain version, against the reference's Pallas kernel and custom VJP in
interpret mode).

SoftAM's score gradient flows only through the averaged pose's init
sensitivity, so the case must leave that sensitivity well above f32
rounding (scorenet_case): the toy's coordinates carry 40 mm of noise, so
that the hypotheses spread and their softmax average (entropy 0.87 bits)
starts away from the refinement's fixed point, with ScoreNet weights of
seed 2.  At the toy's 5 mm the average converges and the sensitivity is
rounding on both sides (tests/test_torch_train_scorenet_converged.py).

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


@pytest.mark.parametrize("mode", [False, "implicit_jnp", "implicit"],
                         ids=["unroll", "implicit_jnp", "implicit"])
def test_softam_objective_and_gradients_match_reference(case, mode):
    (ref_obj, ref_gc, ref_gs), (obj, aux, gc, gs) = case.run(True, mode)
    assert float(aux["entropy"][0]) > 0.5  # the softmax is spread
    hold(obj, ref_obj, gc, ref_gc)
    hold_score(case.net, gs, ref_gs)
