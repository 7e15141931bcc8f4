"""The port's refinement gradients (geometry/gn.py:implicit_refine_step,
ops/gn_cuda.py:refine_init_sensitive, pipeline/forward.py:make_refiners)
and the plain route of the refine kernel, against dsac_tpu and against the
reference's own bars (the P3P and vec6 gradients are in
tests/test_torch_geometry_grad.py).

Against the reference, on the same numpy-seeded inputs:
  * implicit_refine_step at a converged fixed point: values to 1e-3 mm and
    1e-6, coordinate gradient cosine >= 0.999 and norm ratio 0.99-1.01;
  * the init-sensitivity function against
    make_init_sensitivity_refiner(interpret=True) from an init where the
    truncated refinement is alive and not converged (TestInitSensitivity):
    cosine >= 0.999, norm ratio 0.8-1.25 (f32 rounding of the two finite
    differences; the port against its f64 twin at 0.999, 0.99-1.01);
  * refine_pose_fused's plain version against the reference's
    interpret-mode refine_pose_fused at 4 steps from perturbed inits: 1e-3
    mm and 1e-6.
The reference's own bars on the port alone (tests/test_implicit_grad.py,
tests/test_train.py): the implicit step against autograd through the
unrolled IRLS at a fixed point, cosine > 0.97 and ratio 0.7-1.4; the
init-sensitivity gradient against autograd through the truncated PyTorch
unroll, cosine > 0.97 and ratio 0.8-1.25, its forward equal to the fused
forward to 1e-6 on R and 1e-4 on t; "implicit" against "unroll" on the
whole objective, coordinate cosine > 0.9, score cosine > 0.95, objective
within 5%; SoftAM "implicit" against "implicit_jnp", coordinate cosine >
0.9 and a finite, non-zero score gradient; chunked against unchunked
implicit steps, identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.config import Camera as JCamera
from dsac_tpu.geometry.gn import implicit_refine_step as jax_implicit_step
from dsac_tpu.geometry.gn import refine_pose as jax_refine_pose
from dsac_tpu.geometry.pose import Pose as JPose
from dsac_tpu.geometry.pose import pose_to_vec6 as jax_to_vec6
from dsac_tpu.geometry.rotation import so3_exp as jax_so3_exp
from dsac_tpu.ops.gn_pallas import make_init_sensitivity_refiner
from dsac_tpu.ops.gn_pallas import refine_pose_fused as jax_refine_fused
from dsac_tpu_torch.config import (Camera, DataConfig, DSACConfig, NetConfig,
                                   PoseConfig)
from dsac_tpu_torch.data.synthetic import SyntheticScene
from dsac_tpu_torch.geometry.gn import implicit_refine_step, refine_pose
from dsac_tpu_torch.geometry.pose import Pose, pose_to_vec6
from dsac_tpu_torch.geometry.rotation import so3_exp
from dsac_tpu_torch.models import DenseCoordNet, ScoreNet, init_like_flax
from dsac_tpu_torch.models.coord_net import coord_apply
from dsac_tpu_torch.ops.gn_cuda import (InitSensitiveRefine,
                                        refine_init_sensitive,
                                        refine_pose_fused, refine_pose_ref)
from dsac_tpu_torch.pipeline import forward as fwd
from dsac_tpu_torch.pipeline.train import e2e_expected_loss
from test_torch_train import cosine_ratio, make_toy, port
from torch_problems import one_torch_thread  # noqa: F401

JCAM = JCamera.make(525.0, 640, 480)
CAM = Camera.make(525.0, 640, 480)
FD_STEPS = 2  # the truncated refinement of the init-sensitivity tests


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


def scene(rng, n=256, noise=2.0, outlier_frac=0.2):
    """tests/test_implicit_grad.py:_scene in numpy: points in front of a
    random camera, noisy coordinates (mm) with gross outliers."""
    R = so3_exp(T(rng.normal(size=3) * 0.3)).numpy()
    t = np.float32([40.0, -30.0, -2500.0])
    eye = np.stack([rng.uniform(-800, 800, n), rng.uniform(-600, 600, n),
                    rng.uniform(-4000, -1500, n)], -1).astype(np.float32)
    obj = (R.T @ (eye - t).T).T
    pix = np.stack([-525.0 * eye[:, 0] / eye[:, 2] + 320.0,
                    525.0 * eye[:, 1] / eye[:, 2] + 240.0], -1)
    noise_mm = rng.normal(size=obj.shape) * noise
    out = rng.uniform(size=n) < outlier_frac
    noise_mm[out] += rng.normal(size=(out.sum(), 3)) * 500.0
    return (R, t, (obj + noise_mm).astype(np.float32),
            pix.astype(np.float32))


def jpose(R, t):
    return JPose(jnp.asarray(R), jnp.asarray(t))


class TestImplicitStep:
    def test_matches_reference_at_fixed_point(self, rng):
        R, t, coords, pix = scene(rng)
        dR = so3_exp(T(rng.normal(size=3) * 0.02)).numpy()
        init = jpose(dR @ R, t + rng.normal(size=3).astype(np.float32) * 20)
        star, _ = jax_refine_pose(init, jnp.asarray(coords),
                                  jnp.asarray(pix), JCAM, steps=20,
                                  remat=False)
        w = rng.normal(size=6).astype(np.float32)

        def jloss(c):
            s = jax_implicit_step(star, c, jnp.asarray(pix), JCAM)
            return jnp.sum(jnp.asarray(w) * jax_to_vec6(s)), s

        (_, js), jg = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(coords))
        c = T(coords).requires_grad_()
        s = implicit_refine_step(Pose(T(star.R), T(star.t)), c, T(pix), CAM)
        (T(w) * pose_to_vec6(s)).sum().backward()
        np.testing.assert_allclose(s.t.detach().numpy(), np.asarray(js.t),
                                   atol=1e-3)
        np.testing.assert_allclose(s.R.detach().numpy(), np.asarray(js.R),
                                   atol=1e-6)
        cos, ratio = cosine_ratio(c.grad.numpy(), jg)
        assert cos >= 0.999 and 0.99 <= ratio <= 1.01, (cos, ratio)

    def test_matches_unrolled_autograd_at_fixed_point(self, rng):
        """tests/test_implicit_grad.py:41-79 on the port alone."""
        R, t, coords, pix = scene(rng)
        dR = so3_exp(T(rng.normal(size=3) * 0.02))
        init = Pose(dR @ T(R), T(t) + T(rng.normal(size=3) * 20.0))
        w = T(rng.normal(size=6))

        c_u = T(coords).requires_grad_()
        refined, _ = refine_pose(init, c_u, T(pix), CAM, steps=20)
        (w * pose_to_vec6(refined)).sum().backward()
        c_i = T(coords).requires_grad_()
        with torch.no_grad():
            star, _ = refine_pose(init, c_i, T(pix), CAM, steps=20)
        (w * pose_to_vec6(implicit_refine_step(star, c_i, T(pix), CAM))
         ).sum().backward()
        assert torch.isfinite(c_i.grad).all()
        cos, ratio = cosine_ratio(c_i.grad.numpy(), c_u.grad.numpy())
        assert cos > 0.97 and 0.7 < ratio < 1.4, (cos, ratio)


class TestInitSensitivity:
    @pytest.fixture
    def far(self, rng):
        """An init 0.06 rad and 120 mm off, refined for 2 steps: alive
        (90 soft inliers at the init, above min_inliers) and not
        converged, so the truncated init sensitivity is neither the
        identity of a frozen pose nor the ~0 of a converged one.  The
        reference's own regime (0.15 rad, 300 mm, 4 steps;
        tests/test_implicit_grad.py:89-142) starts these draws at 19 soft
        inliers: the pose freezes at once and both gradients there are the
        identity's."""
        R, t, coords, pix = scene(rng)
        dR = so3_exp(T(rng.normal(size=3) * 0.06)).numpy()
        init_R = (dR @ R).astype(np.float32)
        init_t = (t + rng.normal(size=3) * 120.0).astype(np.float32)
        return init_R, init_t, coords, pix, rng.normal(size=6).astype(
            np.float32)

    def port_grad(self, far, refine):
        init_R, init_t, coords, pix, w = far
        v6 = torch.zeros(6, requires_grad=True)
        p = Pose(so3_exp(v6[:3]) @ T(init_R), T(init_t) + v6[3:])
        out = refine(p, T(coords), T(pix))
        (T(w) * pose_to_vec6(out)).sum().backward()
        return v6.grad.numpy().astype(np.float64)

    def fd(self, p, coords, pix, **kw):
        out = refine_init_sensitive(Pose(p.R[None, None], p.t[None, None]),
                                    coords[None], pix[None], CAM,
                                    outer_steps=FD_STEPS, inner_iters=1,
                                    **kw)
        return Pose(out.R[0, 0], out.t[0, 0])

    def test_matches_reference_custom_vjp(self, far):
        """Direction at cosine >= 0.999; the norm at the reference's own
        FD bar, 0.8-1.25.  A central difference over 1e-3 rad divides the
        f32 rounding of the refined pose (~2.4e-4 mm at 2.5 m) by 2e-3:
        here the reference's f32 estimate is 4.7% off its f64 twin in norm
        and the port's 0.55%, so the two f32 estimates differ by 4%; the
        port is held to its own f64 twin at 0.999 and 0.99-1.01."""
        init_R, init_t, coords, pix, w = far
        ref_fd = make_init_sensitivity_refiner(
            JCAM, steps=FD_STEPS, threshold=10.0, beta=1.0, min_inliers=50.0,
            damping=1e-4, max_error=100.0, interpret=True)

        def jloss(v6):
            R = jax_so3_exp(v6[:3]) @ jnp.asarray(init_R)
            t = jnp.asarray(init_t) + v6[3:]
            oR, ot = ref_fd(R[None], t[None], jnp.asarray(coords),
                            jnp.asarray(pix))
            return jnp.sum(jnp.asarray(w) * jax_to_vec6(JPose(oR[0], ot[0])))

        ref = np.asarray(jax.grad(jloss)(jnp.zeros(6)), np.float64)
        before = InitSensitiveRefine.launches
        got = self.port_grad(far, self.fd)
        assert InitSensitiveRefine.launches == before  # plain on the CPU
        assert np.all(np.isfinite(got))
        cos, ratio = cosine_ratio(got, ref)
        assert cos >= 0.999 and 0.8 < ratio < 1.25, (cos, ratio, got, ref)
        # the port's f32 estimate against its own f64 twin
        twin = self.port_grad(far, lambda p, c, x: self.fd(
            Pose(p.R.double(), p.t.double()), c.double(), x.double(),
            plain=True))
        cos, ratio = cosine_ratio(got, twin)
        assert cos >= 0.999 and 0.99 <= ratio <= 1.01, (cos, ratio)

    def test_matches_truncated_unroll(self, far):
        """tests/test_implicit_grad.py:89-142 on the port alone; the plain
        route gives the same gradient as the default one."""
        def unroll(p, coords, pix):
            return refine_pose(p, coords, pix, CAM, steps=FD_STEPS,
                               inner_iters=1)[0]

        g_u = self.port_grad(far, unroll)
        g_f = self.port_grad(far, self.fd)
        # neither frozen (the gradient of the identity map) nor converged
        g_id = self.port_grad(far, lambda p, c, x: p)
        assert cosine_ratio(g_u, g_id)[0] < 0.9 and np.linalg.norm(g_u) > 1.0
        cos, ratio = cosine_ratio(g_f, g_u)
        assert cos > 0.97 and 0.8 < ratio < 1.25, (cos, ratio)
        g_p = self.port_grad(far, lambda p, c, x: self.fd(p, c, x,
                                                         plain=True))
        np.testing.assert_array_equal(g_p, g_f)

    def test_forward_is_the_fused_forward(self, rng):
        R, t, coords, pix = scene(rng)
        init = Pose(T(R)[None, None], (T(t) + 30.0)[None, None])
        out = refine_init_sensitive(init, T(coords)[None], T(pix)[None],
                                    CAM, outer_steps=8, inner_iters=1)
        ref, _ = refine_pose_fused(init, T(coords)[None], T(pix)[None], CAM,
                                   outer_steps=8, inner_iters=1)
        np.testing.assert_allclose(out.R.numpy(), ref.R.numpy(), atol=1e-6)
        np.testing.assert_allclose(out.t.numpy(), ref.t.numpy(), atol=1e-4)


def test_refine_plain_route_is_the_kernels_iteration(rng):
    """refine_pose_fused's plain version runs the kernel's single-GN steps:
    it meets the reference's interpret-mode kernel at 4 steps from
    perturbed inits (16 poses, 256 points, 20% outliers) to 1e-3 mm and
    1e-6; refine_pose_ref stays the reference's jnp nest."""
    R, t, coords, pix = scene(rng)
    w = rng.normal(size=(16, 3)) * 0.05
    R0 = (so3_exp(T(w)) @ T(R)).contiguous()
    t0 = (T(t) + T(rng.normal(size=(16, 3)) * 100.0)).contiguous()
    got, n_got = refine_pose_fused(Pose(R0[None], t0[None]), T(coords)[None],
                                   T(pix)[None], CAM, outer_steps=4,
                                   inner_iters=1)
    ref, n_ref = jax_refine_fused(jpose(R0.numpy(), t0.numpy()),
                                  jnp.asarray(coords), jnp.asarray(pix),
                                  JCAM, steps=4, interpret=True)
    np.testing.assert_allclose(got.t[0].numpy(), np.asarray(ref.t), atol=1e-3)
    np.testing.assert_allclose(got.R[0].numpy(), np.asarray(ref.R), atol=1e-6)
    np.testing.assert_allclose(n_got[0].numpy(), np.asarray(n_ref), rtol=1e-4)
    nest, _ = refine_pose_ref(Pose(R0[None], t0[None]), T(coords)[None],
                              T(pix)[None], CAM, outer_steps=2,
                              inner_iters=2)
    own, _ = refine_pose(Pose(R0, t0), T(coords), T(pix), CAM, steps=2,
                         inner_iters=2)
    torch.testing.assert_close(nest.t[0], own.t, rtol=1e-6, atol=1e-3)


class TestPipelineGrad:
    """tests/test_implicit_grad.py:164-260 on the port: 320 x 240 frames,
    a DenseCoordNet at width 16 and a ScoreNet at width_mult 0.25 with
    random weights of Flax's default init (models.init_like_flax), H = 32
    hypotheses of 8 attempts."""

    @pytest.fixture(scope="class")
    def pipeline(self):
        cfg = DSACConfig(
            pose=PoseConfig(num_hypotheses=32, sample_attempts=8),
            data=DataConfig(image_width=320, image_height=240,
                            focal_length=260.0),
            net=NetConfig(subsample_size=40, rgb_patch_size=16))
        sc = SyntheticScene(320, 240, 260.0, device="cpu")
        gt = sc.random_pose(torch.Generator().manual_seed(5))
        gen = torch.Generator().manual_seed(1)
        coord_net = init_like_flax(DenseCoordNet(width=16), gen)
        score_net = init_like_flax(ScoreNet(0.25), gen)
        return cfg, sc.camera, sc.render(gt)[0], gt, coord_net, score_net

    def grads(self, pipeline, mode, softam=False):
        cfg, cam, image, gt, coord_net, score_net = pipeline
        coord_net.zero_grad()
        score_net.zero_grad()
        obj, _ = e2e_expected_loss(
            lambda im, pix: coord_apply(coord_net, im, pix), score_net,
            image, gt, cam, cfg, softam=softam, refine_mode=mode,
            generator=torch.Generator().manual_seed(11))
        obj.backward()

        def flat(net):
            return torch.cat([p.grad.flatten() for p in net.parameters()]
                             ).numpy()
        return float(obj.detach()), flat(coord_net), flat(score_net)

    def test_implicit_matches_unroll(self, pipeline):
        obj_u, gc_u, gs_u = self.grads(pipeline, "unroll")
        obj_i, gc_i, gs_i = self.grads(pipeline, "implicit")
        assert np.isfinite(obj_i) and np.all(np.isfinite(gc_i))
        assert abs(obj_u - obj_i) < 0.05 * (abs(obj_u) + 1e-3)
        assert cosine_ratio(gc_i, gc_u)[0] > 0.9
        assert cosine_ratio(gs_i, gs_u)[0] > 0.95

    def test_chunked_implicit_step_identical(self, pipeline, monkeypatch):
        obj_d, gc_d, gs_d = self.grads(pipeline, "implicit_jnp")
        for ch in (8, 7):  # an exact multiple and a ragged tail (28 + 4)
            monkeypatch.setattr(fwd, "_IMPLICIT_STEP_CHUNK", ch)
            obj_c, gc_c, gs_c = self.grads(pipeline, "implicit_jnp")
            assert obj_c == pytest.approx(obj_d, rel=1e-6), ch
            np.testing.assert_allclose(gc_c, gc_d, rtol=2e-4, atol=1e-7)
            np.testing.assert_allclose(gs_c, gs_d, rtol=2e-4, atol=1e-7)


def test_softam_implicit_matches_implicit_jnp():
    """tests/test_train.py:257-282 on the port alone, on its toy."""
    toy = make_toy()
    _, _, gc_f, gs_f = port(toy, True, "implicit")
    _, _, gc_j, _ = port(toy, True, "implicit_jnp")
    assert np.all(np.isfinite(gc_f))
    assert torch.isfinite(gs_f["gain"]) and float(gs_f["gain"]) != 0.0
    assert cosine_ratio(gc_f, gc_j)[0] > 0.9
