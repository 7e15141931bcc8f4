"""The port's end-to-end SoftAM training in refine mode "implicit" against
dsac_tpu.pipeline.train, on the toy of tests/test_torch_train.py: the
refine kernel's fixed point, one differentiable GN step, and the averaged
pose's init-pose gradient by the refine kernel's finite-difference
backward (ops/gn_cuda.py:InitSensitiveRefine).  On the CPU the kernel is
its plain version, against the reference's Pallas kernel and its custom
VJP in interpret mode.

Bars as in tests/test_torch_train.py: the objective to 1e-2 relative +
0.2, the coordinate gradient cosine >= 0.99 and norm ratio 0.9-1.1, the
toy's score gradient finite (its softmax is one-hot; see there).  The
score gradient is held against the reference with a score CNN in
tests/test_torch_train_scorenet_softam.py.
"""

import torch

from dsac_tpu_torch.ops.gn_cuda import InitSensitiveRefine
from test_torch_train import hold, make_toy, port, reference
from torch_problems import one_torch_thread  # noqa: F401


def test_softam_implicit_objective_and_gradients_match_reference():
    toy = make_toy()
    ref_obj, ref_gc, _ = reference(toy, True, "implicit")
    before = InitSensitiveRefine.launches
    obj, aux, gc, gs = port(toy, True, "implicit")
    hold(obj, ref_obj, gc, ref_gc)
    assert torch.isfinite(gs["gain"]).all()
    assert torch.isfinite(aux["winner_loss"]).all()
    # on the CPU the backward takes the plain route and launches nothing
    assert InitSensitiveRefine.launches == before
