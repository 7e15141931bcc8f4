"""The port's geometry (dsac_tpu_torch/geometry) against dsac_tpu's, on
the same numpy-seeded inputs, plus the closed-form cases of
tests/test_geometry.py and tests/test_p3p_gn.py.

Tolerances: both sides compute in f32 with the same formulas in another
order, so elementwise values agree to ~1e-5 relative; rotations to 1e-5,
translations to 1e-2 mm at ~3 m, pixels to 1e-3.  The P3P solver is held
to the reference statistically: its roots are ill-conditioned near double
roots, where f32 rounding in another order picks another root, so the
bars are agreement rates and medians (as tests/test_pallas_kernels.py
holds the reference's own P3P kernel), and, like the reference's tests,
the generating pose within 0.5 deg / 20 mm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu import geometry as jg
from dsac_tpu.config import Camera as JCamera
from dsac_tpu.geometry import gn as jgn
from dsac_tpu.geometry import p3p as jp3p
from dsac_tpu_torch import geometry as tg
from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry import gn as tgn
from dsac_tpu_torch.geometry import p3p as tp3p
from dsac_tpu_torch.geometry.pose import Pose

JCAM = JCamera.make(525.0, 640, 480)
CAM = Camera.make(525.0, 640, 480)


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


def J(x):
    return jnp.asarray(np.asarray(x, np.float32))


def random_w(rng, n, max_angle=3.1):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    return (w / np.linalg.norm(w, axis=-1, keepdims=True)
            * rng.uniform(0.001, max_angle, size=(n, 1))).astype(np.float32)


def make_scene(rng, n_points=4):
    """Eye-frame points in front of the camera pulled back to the scene by
    a random pose (tests/test_p3p_gn.py:make_scene)."""
    w = rng.normal(size=3).astype(np.float32)
    R = tg.so3_exp(T(w))
    t = T(rng.normal(size=3) * 800)
    x = rng.uniform(-1000, 1000, size=n_points)
    y = rng.uniform(-750, 750, size=n_points)
    z = -rng.uniform(1500, 3500, size=n_points)
    eye = T(np.stack([x, y, z], -1))
    pose = Pose(R, t)
    scene = tg.transform(tg.invert(pose), eye)
    pix = tg.project(Pose(torch.eye(3), torch.zeros(3)), eye, CAM)
    return pose, scene, pix


class TestRotation:
    def test_exp_log_match_reference(self, rng):
        w = random_w(rng, 64)
        R = tg.so3_exp(T(w))
        np.testing.assert_allclose(R.numpy(), np.asarray(jg.so3_exp(J(w))),
                                   atol=1e-6)
        np.testing.assert_allclose(tg.so3_log(R).numpy(),
                                   np.asarray(jg.so3_log(J(R.numpy()))),
                                   atol=1e-5)
        np.testing.assert_allclose(tg.so3_log(R).numpy(), w, atol=2e-3)

    @pytest.mark.parametrize("w", [[0.0, 0.0, 0.0], [1e-5, -2e-5, 1e-5],
                                   [np.pi - 1e-4, 0.0, 0.0],
                                   [0.0, 0.0, np.pi / 2]])
    def test_closed_form_cases(self, w):
        w = np.asarray(w, np.float32)
        R = tg.so3_exp(T(w))
        np.testing.assert_allclose(R.numpy(), np.asarray(jg.so3_exp(J(w))),
                                   atol=1e-6)
        np.testing.assert_allclose(tg.so3_log(R).numpy(), w, atol=1e-3)

    def test_hat_and_angular_distance(self, rng):
        a, b = rng.normal(size=(2, 3)).astype(np.float32)
        np.testing.assert_allclose((tg.hat(T(a)) @ T(b)).numpy(),
                                   np.cross(a, b), atol=1e-6)
        R1 = tg.so3_exp(T(random_w(rng, 1)[0]))
        R2 = tg.so3_exp(T([0.0, np.radians(37.0), 0.0])) @ R1
        d = tg.angular_distance_deg(R1, R2)
        np.testing.assert_allclose(float(d), 37.0, atol=0.01)
        np.testing.assert_allclose(
            float(d), float(jg.angular_distance_deg(J(R1), J(R2))),
            atol=1e-3)


class TestProjection:
    def test_x_flip_known_offsets(self):
        cam = Camera.make(500.0, 640, 480)
        ident = Pose(torch.eye(3), torch.zeros(3))
        uv = tg.project(ident, T([[100.0, 0.0, -1000.0],
                                  [0.0, 100.0, -1000.0],
                                  [0.0, 0.0, -1000.0]]), cam)
        np.testing.assert_allclose(uv.numpy(), [[370.0, 240.0],
                                                [320.0, 190.0],
                                                [320.0, 240.0]], atol=1e-3)

    def test_matches_reference(self, rng):
        w = random_w(rng, 5, 0.5)
        t = rng.normal(size=(5, 3)) * 300 + [0, 0, -2500]
        x = rng.uniform(-1000, 1000, size=(5, 50, 3))
        pix = rng.uniform(0, 640, size=(5, 50, 2))
        tp = Pose(tg.so3_exp(T(w)), T(t))
        jp = jg.Pose(jg.so3_exp(J(w)), J(t))
        np.testing.assert_allclose(tg.project(tp, T(x), CAM).numpy(),
                                   np.asarray(jg.project(jp, J(x), JCAM)),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(
            tg.reprojection_errors(tp, T(x), T(pix), CAM).numpy(),
            np.asarray(jg.reprojection_errors(jp, J(x), J(pix), JCAM)),
            rtol=1e-5, atol=1e-3)
        gt = Pose(tg.so3_exp(T(random_w(rng, 5, 0.5))), T(t + 30.0))
        jgt = jg.Pose(J(gt.R), J(gt.t))
        for a, b in zip(tg.pose_errors(tp, gt), jg.pose_errors(jp, jgt)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-2)


class TestSolve6:
    def test_cholesky_matches_reference_and_numpy(self, rng):
        M = rng.normal(size=(32, 6, 6)).astype(np.float32)
        A = M @ M.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
        b = rng.normal(size=(32, 6)).astype(np.float32)
        x = tgn.solve6_cholesky(T(A), T(b)).numpy()
        np.testing.assert_allclose(x, np.linalg.solve(A, b[..., None])[..., 0],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            x, np.asarray(jgn.solve6_cholesky(J(A), J(b))), atol=1e-5)

    def test_residuals_and_jacobian_match_reference(self, rng):
        w = random_w(rng, 3, 0.5)
        t = rng.normal(size=(3, 3)) * 300 + [0, 0, -2500]
        x = rng.uniform(-1000, 1000, size=(3, 40, 3))
        x[0, 0] = [0.0, 0.0, 2500.0 - t[0, 2] * 0]  # near the 1 mm z floor
        pix = rng.uniform(0, 640, size=(3, 40, 2))
        r, Jt = tgn._residuals_and_jac(Pose(tg.so3_exp(T(w)), T(t)), T(x),
                                       T(pix), CAM)
        jr, jJ = jgn._residuals_and_jac(jg.Pose(jg.so3_exp(J(w)), J(t)),
                                        J(x), J(pix), JCAM)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-4,
                                   atol=1e-2)
        np.testing.assert_allclose(Jt.numpy(), np.asarray(jJ), rtol=1e-4,
                                   atol=1e-3)
        assert torch.isfinite(Jt).all()


class TestP3P:
    def test_ranges_match_reference(self, rng):
        """Grunert ranges on exact 3-point sets against the reference's.
        Roots near a double root are ill-conditioned in f32, and XLA's
        fused arithmetic rounds differently from PyTorch's, so a few root
        slots differ: >= 90% agree in validity, the median common root
        is within 0.5 mm, and the median best root within 2 mm of truth."""
        grunert = jax.jit(lambda o, p: jp3p.p3p_grunert(
            o, jp3p.pixel_bearings(p, JCAM)))
        agree, diffs, best = [], [], []
        for _ in range(16):
            pose, scene, pix = make_scene(rng, n_points=3)
            gt_ranges = torch.linalg.norm(tg.transform(pose, scene), dim=-1)
            ranges, valid = tp3p.p3p_grunert(
                scene, tp3p.pixel_bearings(pix, CAM))
            jr, jv = grunert(J(scene), J(pix))
            jv = torch.from_numpy(np.array(jv))
            agree.append((valid == jv).float().mean().item())
            both = valid & jv
            diffs += (ranges - T(jr)).abs().amax(-1)[both].tolist()
            errs = (ranges - gt_ranges[None]).abs().amax(-1)
            errs[~valid] = float("inf")
            best.append(float(errs.min()))
        assert np.mean(agree) >= 0.9
        assert np.median(diffs) < 0.5
        assert np.median(best) < 2.0  # mm on ~2-3 m ranges

    def test_solve_recovers_pose(self, rng):
        scenes = [make_scene(rng) for _ in range(20)]
        gt = Pose(torch.stack([s[0].R for s in scenes]),
                  torch.stack([s[0].t for s in scenes]))
        est, valid = tp3p.solve_pnp_minimal(
            torch.stack([s[1] for s in scenes]),
            torch.stack([s[2] for s in scenes]), CAM)
        assert bool(valid.all())
        rot, trans = tg.pose_errors(est, gt)
        assert float(rot.max()) < 0.5 and float(trans.max()) < 20.0

    @pytest.mark.parametrize("noise", [0.0, 4.0])
    def test_matches_reference_solver(self, rng, noise):
        sets = [make_scene(rng) for _ in range(64)]
        obj = np.stack([s[1].numpy() for s in sets])
        obj = obj + rng.normal(size=obj.shape) * noise
        pix = np.stack([s[2].numpy() for s in sets])
        est, valid = tp3p.solve_pnp_minimal(T(obj), T(pix), CAM)
        jest, jvalid = jax.jit(jax.vmap(
            lambda o, p: jp3p.solve_pnp_minimal(o, p, JCAM)))(J(obj), J(pix))
        assert (valid.numpy() == np.asarray(jvalid)).mean() >= 0.95
        dR = np.abs(est.R.numpy() - np.asarray(jest.R)).reshape(64, -1)
        assert np.median(dR.max(1)) < 1e-4
        assert (dR.max(1) < 1e-3).mean() >= 0.9  # alternate-root ties

    def test_degenerate_sets_stay_finite(self, rng):
        pose, scene, pix = make_scene(rng)
        collinear = scene.clone()
        collinear[1] = scene[0] + T([10.0, 0, 0])
        collinear[2] = scene[0] + T([20.0, 0, 0])
        dup = scene[:1].expand(4, 3).clone()
        est, valid = tp3p.solve_pnp_minimal(torch.stack([collinear, dup]),
                                            torch.stack([pix, pix]), CAM)
        assert torch.isfinite(est.R).all() and torch.isfinite(est.t).all()
        assert not bool(valid[1])
        np.testing.assert_allclose(est.R[1].numpy(), np.eye(3), atol=1e-6)


class TestRefine:
    def test_refine_pose_matches_reference(self, rng):
        """geometry/gn.py:refine_pose, the refine kernel's plain version,
        from perturbed poses with 30% outliers: rotations to 1e-4, t to
        0.5 mm, inlier counts to 0.05."""
        gt, _, _ = make_scene(rng)
        eye = np.stack([rng.uniform(-1200, 1200, 500),
                        rng.uniform(-900, 900, 500),
                        -rng.uniform(1500, 3500, 500)], -1)
        scene = tg.transform(tg.invert(gt), T(eye)).numpy()
        scene = scene + rng.normal(size=scene.shape) * 4
        out = rng.random(500) < 0.3
        scene[out] = rng.uniform(-3000, 3000, size=(out.sum(), 3))
        pix = tg.project(Pose(torch.eye(3), torch.zeros(3)), T(eye), CAM)
        w = random_w(rng, 6, 0.01)
        R0 = tg.so3_exp(T(w)) @ gt.R
        t0 = gt.t + T(rng.normal(size=(6, 3)) * 20)
        ref, n = tgn.refine_pose(Pose(R0, t0), T(scene), pix, CAM)
        jref, jn = jax.jit(lambda p, o, x: jgn.refine_pose(p, o, x, JCAM))(
            jg.Pose(J(R0), J(t0)), J(scene), J(pix.numpy()))
        np.testing.assert_allclose(ref.R.numpy(), np.asarray(jref.R),
                                   atol=1e-4)
        np.testing.assert_allclose(ref.t.numpy(), np.asarray(jref.t),
                                   atol=0.5)
        np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=0.05)
        rot, trans = tg.pose_errors(ref, Pose(gt.R.expand(6, 3, 3),
                                              gt.t.expand(6, 3)))
        assert float(rot.max()) < 0.5 and float(trans.max()) < 20.0

    def test_freezes_below_min_inliers(self, rng):
        gt, _, _ = make_scene(rng)
        scene = T(rng.uniform(-3000, 3000, size=(200, 3)))
        pix = T(rng.uniform(0, 640, size=(200, 2)))
        p0 = Pose(gt.R[None], gt.t[None])
        out, n = tgn.refine_pose(p0, scene, pix, CAM)
        assert float(n[0]) < 50.0
        np.testing.assert_array_equal(out.t.numpy(), p0.t.numpy())
