"""The port's CUDA kernels on the card (marker `gpu`; each test skips
without a CUDA device).  No JAX here, so that the machine with the card,
which has none, can run the file; tests/conftest.py imports JAX, so run it
there without the conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

Bars as in tests/test_torch_kernels.py: P3P decision agreement >= 0.98 and
median |dR| < 1e-3; score max abs error <= 1e-3; refine |dt| <= 2 mm,
|dR| <= 1e-4, |dn_in| <= 0.5.
"""

import numpy as np
import pytest
import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.rotation import so3_exp
from dsac_tpu_torch.ops.diffmap_cuda import (soft_inlier_scores,
                                             soft_inlier_scores_ref)
from dsac_tpu_torch.ops.gn_cuda import refine_pose_fused, refine_pose_ref
from dsac_tpu_torch.ops.p3p_cuda import p3p_solve, p3p_solve_ref
from dsac_tpu_torch.ops.sampling import gather_rows
from torch_problems import frames

CAM = Camera.make(525.0, 640, 480)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def problem(cuda):
    rng = np.random.default_rng(1305)
    gt, coords, pix = frames(rng, B=2)
    return rng, Pose(gt.R.to(cuda), gt.t.to(cuda)), coords.to(cuda), \
        pix.to(cuda)


def test_p3p_and_score_match_plain_versions(problem):
    rng, gt, coords, pix = problem
    idx = torch.from_numpy(rng.integers(0, 1600, size=(2, 256, 4))).to(
        coords.device)
    obj = gather_rows(coords, idx).reshape(-1, 4, 3).contiguous()
    img = gather_rows(pix, idx).reshape(-1, 4, 2).contiguous()
    before = p3p_solve.launches
    kp, kv, kw = p3p_solve(obj, img, CAM)
    assert p3p_solve.launches == before + 1
    rp, rv, rw = p3p_solve_ref(obj, img, CAM)
    kc, rc = kv & (kw < 10), rv & (rw < 10)
    assert float((kc == rc).float().mean()) >= 0.98
    both = kc & rc
    assert float((kp.R - rp.R).abs().flatten(1).amax(1)[both].median()) \
        < 1e-3
    assert torch.isfinite(kp.R).all() and torch.isfinite(kw).all()

    R = kp.R.reshape(2, 256, 3, 3).contiguous()
    t = kp.t.reshape(2, 256, 3).contiguous()
    err = (soft_inlier_scores(R, t, coords, pix, CAM)
           - soft_inlier_scores_ref(R, t, coords, pix, CAM)).abs().max()
    assert float(err) <= 1e-3


def test_refine_matches_plain_version(problem):
    rng, gt, coords, pix = problem
    def noise(scale):
        return torch.from_numpy(rng.normal(size=(2, 4, 3)) * scale).float(
        ).to(coords.device)

    poses = Pose((so3_exp(noise(0.005)) @ gt.R[:, None]).contiguous(),
                 (gt.t[:, None] + noise(15.0)).contiguous())
    a, na = refine_pose_fused(poses, coords, pix, CAM)
    b, nb = refine_pose_ref(poses, coords, pix, CAM)
    assert float((a.t - b.t).abs().max()) <= 2.0
    assert float((a.R - b.R).abs().max()) <= 1e-4
    assert float((na - nb).abs().max()) <= 0.5


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(problem):
    _, gt, coords, pix = problem
    R = gt.R[:, None].expand(2, 4, 3, 3).contiguous()
    t = gt.t[:, None].expand(2, 4, 3).contiguous()
    with pytest.raises(TypeError):
        soft_inlier_scores(R, t, coords.half(), pix, CAM)
    with pytest.raises(ValueError):
        soft_inlier_scores(R, t, coords.cpu(), pix, CAM)
    with pytest.raises(ValueError):
        refine_pose_fused(Pose(R.transpose(-1, -2), t), coords, pix, CAM)


def test_serve_localises_a_small_queue(cuda):
    from dsac_tpu_torch.cli import serve
    res = serve.main(["--synthetic", "8", "--batch", "4", "--queue", "2",
                      "--reps", "1"])
    assert res["accuracy_5cm5deg"] >= 0.95 and res["poses_finite"]
