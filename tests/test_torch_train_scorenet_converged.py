"""What the refine kernel's init-pose finite-difference backward gives
where SoftAM's averaged pose has converged, on the port and on
dsac_tpu.pipeline.train alike.

SoftAM at the toy's 5 mm noise (ScoreNet weights of seed 1): the averaged
pose converges within the 8 x 2 steps, so its init sensitivity, the only
path of the score gradient, is ~0.  Autograd through the IRLS
("implicit_jnp") then gives a score gradient of ~1e-4, while the central
differences of "implicit" (1e-3 rad, 1 mm) divide the f32 rounding of the
refined pose (~2.4e-4 mm at 3 m) by the probe step and give rounding of
~0.1-1.  The reference shows the same: its own "implicit"/"implicit_jnp"
norm ratio is in the hundreds (531 here, with the reference jitted; 4,119
op by op), and so is the port's (1,169).  Both are held above 100; the
objective and the coordinate gradients, which do not pass through the
init sensitivity, are held as in every other case.
"""

import numpy as np
import pytest

from test_torch_train import hold
from test_torch_train_scorenet import score_vectors, scorenet_case
from torch_problems import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def converged():
    case = scorenet_case(noise_mm=5.0, seed=1)
    return {mode: case.run(True, mode) + (case.net,)
            for mode in ("implicit_jnp", "implicit")}


def test_softam_fd_score_gradient_at_a_converged_average_is_rounding(
        converged):
    norms = {}
    for mode, ((ref_obj, ref_gc, ref_gs), (obj, _, gc, gs), net) in \
            converged.items():
        hold(obj, ref_obj, gc, ref_gc)
        got, ref = score_vectors(net, gs, ref_gs)
        assert np.all(np.isfinite(got))
        norms[mode] = np.linalg.norm(got), np.linalg.norm(ref)
    port_ratio = norms["implicit"][0] / norms["implicit_jnp"][0]
    ref_ratio = norms["implicit"][1] / norms["implicit_jnp"][1]
    assert norms["implicit_jnp"][1] < 1e-3, norms
    assert port_ratio > 100.0 and ref_ratio > 100.0, (port_ratio, ref_ratio)
    print(f"score-gradient norm implicit/implicit_jnp: port {port_ratio:.0f},"
          f" reference {ref_ratio:.0f}")

