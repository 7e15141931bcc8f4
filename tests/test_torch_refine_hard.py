"""The port's hard-threshold refinement (geometry/gn.py:refine_pose_hard and
make_refiners' "hard" mode) against dsac_tpu/geometry/gn.py:
refine_pose_hard (:193-247) and dsac_tpu/pipeline/forward.py:make_refiners
(:259-270), with the reference's point order injected.

Inputs: 2 frames of N = 1,600 scene coordinates (4 mm noise, 30% uniform
outliers; tests/torch_problems.py:frames), 4 start poses a frame at 0.02 to
0.05 rad and 20 to 60 mm from the truth.

Tolerances: the refined pose at the refine bars (2 mm, 1e-4;
tests/test_gn_pallas.py:79-83).  The hard inlier count (an integer compare
of the error with the threshold) exactly, except on the pixels whose error
at the served pose lies within 1e-3 px of the threshold, where f32
rounding of the two computations may fall on either side: the counts may
differ by at most that many.  A start below min_inliers freezes: the pose
comes back unchanged on both sides.  Degenerate coordinates (all zero, or
all on one line) stay finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.config import Camera as JCamera
from dsac_tpu.config import PoseConfig as JPoseCfg
from dsac_tpu.geometry.gn import refine_pose_hard as jax_refine_hard
from dsac_tpu.geometry.pose import Pose as JPose
from dsac_tpu.pipeline.forward import make_refiners as jax_make_refiners
from dsac_tpu_torch.config import Camera, PoseConfig
from dsac_tpu_torch.geometry.gn import hard_permutation, refine_pose_hard
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.projection import project
from dsac_tpu_torch.geometry.rotation import so3_exp
from dsac_tpu_torch.pipeline.forward import make_refiners
from torch_problems import T, frames, one_torch_thread  # noqa: F401

B, N, P = 2, 1600, 4
CAM, JCAM = Camera.make(525.0, 640, 480), JCamera.make(525.0, 640, 480)
THRESHOLD = 10.0


def reference_perm() -> np.ndarray:
    return np.array(jax.random.permutation(jax.random.PRNGKey(0), N))


def starts(rng, gt: Pose, rad, mm) -> Pose:
    """P start poses a frame around gt, rad and mm off (one per pose)."""
    w = rng.normal(size=(B, P, 3))
    w *= np.asarray(rad)[None, :, None] / np.linalg.norm(w, axis=-1,
                                                         keepdims=True)
    d = rng.normal(size=(B, P, 3))
    d *= np.asarray(mm)[None, :, None] / np.linalg.norm(d, axis=-1,
                                                        keepdims=True)
    return Pose((so3_exp(T(w)) @ gt.R[:, None]).contiguous(),
                (gt.t[:, None] + T(d)).contiguous())


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(1305)
    gt, coords, pix = frames(rng, B, N)
    pose0 = starts(rng, gt, [0.02, 0.03, 0.04, 0.05], [20.0, 30.0, 40.0,
                                                         60.0])
    return gt, coords, pix, pose0


def run_reference(pose0: Pose, coords, pix):
    """The reference per frame (its (P,) poses against (N,) points), with
    its default key."""
    fn = jax.jit(lambda R, t, c, x: jax_refine_hard(JPose(R, t), c, x, JCAM))
    out = [fn(*(jnp.asarray(a[b].numpy()) for a in (pose0.R, pose0.t,
                                                     coords, pix)))
           for b in range(B)]
    return (np.stack([np.asarray(o[0].R) for o in out]),
            np.stack([np.asarray(o[0].t) for o in out]),
            np.stack([np.asarray(o[1]) for o in out]))


def near_threshold(pose: Pose, coords, pix) -> np.ndarray:
    """(B, P) pixels whose error at pose lies within 1e-3 px of the
    threshold, in f64."""
    c, x = coords.double()[:, None], pix.double()[:, None]
    eye = c @ pose.R.double().transpose(-1, -2) + pose.t.double()[..., None,
                                                                 :]
    u = -CAM.focal * eye[..., 0] / eye[..., 2] + CAM.cx
    v = CAM.focal * eye[..., 1] / eye[..., 2] + CAM.cy
    err = torch.sqrt((x[..., 0] - u) ** 2 + (x[..., 1] - v) ** 2 + 1e-8)
    return ((err - THRESHOLD).abs() < 1e-3).sum(-1).numpy()


def test_committed_permutation_is_the_reference_s():
    assert hard_permutation(N).tolist() == reference_perm().tolist()
    with pytest.raises(ValueError):
        hard_permutation(N + 1)


@pytest.mark.parametrize("perm", ["injected", "committed"])
def test_refine_pose_hard_matches_reference(problem, perm):
    gt, coords, pix, pose0 = problem
    ref_R, ref_t, ref_n = run_reference(pose0, coords, pix)
    got, n_in = refine_pose_hard(
        pose0, coords[:, None], pix[:, None], CAM,
        perm=(torch.from_numpy(reference_perm()).long()
              if perm == "injected" else None))
    np.testing.assert_allclose(got.t.numpy(), ref_t, atol=2.0)
    np.testing.assert_allclose(got.R.numpy(), ref_R, atol=1e-4)
    assert n_in.dtype == torch.float32
    slack = near_threshold(got, coords, pix)
    assert (np.abs(n_in.numpy() - ref_n) <= slack).all()
    # the starts converge: every pose moved and keeps > 50 inliers
    assert (n_in.numpy() >= 50).all()
    assert (got.t - pose0.t).abs().amax() > 1.0


def test_make_refiners_hard_matches_reference(problem):
    """The "hard" mode over the (B, P) pool against the reference's vmap
    of refine_pose_hard over one frame's pool."""
    gt, coords, pix, pose0 = problem
    refine = make_refiners(coords, pix, CAM, PoseConfig(), "hard")
    got, n_in = refine(pose0)
    for b in range(B):
        rb, _ = jax_make_refiners(jnp.asarray(coords[b].numpy()),
                                  jnp.asarray(pix[b].numpy()), JCAM,
                                  JPoseCfg(), "hard")
        ref, ref_n = jax.jit(rb)(JPose(jnp.asarray(pose0.R[b].numpy()),
                                       jnp.asarray(pose0.t[b].numpy())))
        np.testing.assert_allclose(got.t[b].numpy(), np.asarray(ref.t),
                                   atol=2.0)
        np.testing.assert_allclose(got.R[b].numpy(), np.asarray(ref.R),
                                   atol=1e-4)
        slack = near_threshold(Pose(got.R[b:b + 1], got.t[b:b + 1]),
                               coords[b:b + 1], pix[b:b + 1])[0]
        assert (np.abs(n_in[b].numpy() - np.asarray(ref_n)) <= slack).all()


def test_start_below_min_inliers_freezes(problem):
    """Starts 0.5 rad off see fewer than 50 hard inliers: the pose comes
    back as it went in, on both sides, with the count below 50."""
    gt, coords, pix, _ = problem
    pose0 = starts(np.random.default_rng(7), gt, [0.5] * P, [400.0] * P)
    ref_R, ref_t, ref_n = run_reference(pose0, coords, pix)
    got, n_in = refine_pose_hard(pose0, coords[:, None], pix[:, None], CAM)
    assert (n_in.numpy() < 50).all() and (ref_n < 50).all()
    assert torch.equal(got.R, pose0.R) and torch.equal(got.t, pose0.t)
    np.testing.assert_array_equal(ref_R, pose0.R.numpy())
    np.testing.assert_array_equal(ref_t, pose0.t.numpy())
    np.testing.assert_array_equal(n_in.numpy(), ref_n)


@pytest.mark.parametrize("case", ["all_zero", "collinear"])
def test_degenerate_coordinates_stay_finite(problem, case):
    """Every pixel is where its degenerate point projects, so that every
    point is an inlier and the capped re-solves see a rank-deficient
    system."""
    gt, _coords, _pix, _ = problem
    if case == "all_zero":
        bad = torch.zeros(B, N, 3)
    else:
        s = torch.linspace(-1000.0, 1000.0, N)
        bad = torch.stack([s, 0.5 * s, -0.25 * s], -1).expand(B, N, 3)
    bad = bad.contiguous()
    pix = project(gt, bad, CAM)
    pose0 = Pose(gt.R[:, None].expand(B, P, 3, 3).contiguous(),
                 (gt.t[:, None] + 5.0).expand(B, P, 3).contiguous())
    got, n_in = refine_pose_hard(pose0, bad[:, None], pix[:, None], CAM)
    assert (n_in >= 50).all()  # alive: the solves ran
    for x in (got.R, got.t, n_in):
        assert torch.isfinite(x).all()
