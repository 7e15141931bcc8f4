"""The port's end-to-end SoftAM training against dsac_tpu.pipeline.train,
on the toy of tests/test_torch_train.py, in two of the three refine modes
that SoftAM trains with: "unroll" (autograd through the 8 x 2 IRLS) and
"implicit_jnp" (the PyTorch IRLS's fixed point, one differentiable GN step,
and the init-pose sensitivity by autograd through the IRLS).  The third,
"implicit", is in tests/test_torch_train_softam_fd.py.

Bars as in tests/test_torch_train.py: the objective to 1e-2 relative +
0.2, the coordinate gradient cosine >= 0.99 and norm ratio 0.9-1.1, the
toy's score gradient finite (its softmax is one-hot; see there).  The
score gradient is held against the reference with a score CNN in
tests/test_torch_train_scorenet_softam.py.
"""

import pytest
import torch

from test_torch_train import hold, make_toy, port, reference
from torch_problems import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def toy():
    return make_toy()


@pytest.mark.parametrize("mode", [False, "implicit_jnp"],
                         ids=["unroll", "implicit_jnp"])
def test_softam_objective_and_gradients_match_reference(toy, mode):
    ref_obj, ref_gc, ref_gs = reference(toy, True, mode)
    obj, aux, gc, gs = port(toy, True, mode)
    hold(obj, ref_obj, gc, ref_gc)
    assert torch.isfinite(gs["gain"]).all()
    assert torch.isfinite(aux["winner_loss"]).all()
