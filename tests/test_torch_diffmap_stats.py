"""The diff-map and IRLS-statistics kernel modules of the port against the
reference's Pallas kernels, run in interpret mode as
tests/test_pallas_kernels.py and tests/test_gn_pallas.py run them.  On the
CPU each wrapper takes its plain PyTorch version, which is what these
tests hold to the reference; the CUDA kernels are held to the same plain
versions on the card by chip_smoke.py and tests/test_torch_cuda.py.

Bars (the reference's own):
  diff-maps        rtol 1e-4, atol 1e-2 (tests/test_pallas_kernels.py:42-53),
                   at the non-aligned shapes H=37, N=130;
  IRLS statistics  n_in rtol 1e-3 / atol 0.05; JtJ and Jtr rtol 2e-3 /
                   atol 2.0 (tests/test_gn_pallas.py:46-55);
  stepwise refine  |dt| <= 1e-2 mm, |dR| <= 1e-5, n_in rtol 1e-4
                   (tests/test_gn_pallas.py:112-115).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.config import Camera as JCamera
from dsac_tpu.geometry.pose import Pose as JPose
from dsac_tpu.ops.diffmap_pallas import diffmaps_pallas
from dsac_tpu.ops.gn_pallas import irls_stats as jax_irls_stats
from dsac_tpu.ops.gn_pallas import refine_pose_fused_steps as jax_steps
from dsac_tpu.ops.gn_pallas import unpack_stats as jax_unpack
from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.rotation import so3_exp
from dsac_tpu_torch.ops.diffmap_cuda import diffmaps, diffmaps_ref
from dsac_tpu_torch.ops.gn_cuda import (irls_stats, irls_stats_ref,
                                        refine_pose_fused_steps,
                                        unpack_stats)
from torch_problems import T, frames, one_torch_thread  # noqa: F401

JCAM = JCamera.make(525.0, 640, 480)
CAM = Camera.make(525.0, 640, 480)
CAM_VEC = jnp.asarray([525.0, 320.0, 240.0], jnp.float32)
STATS_VEC = jnp.asarray([525.0, 320.0, 240.0, 100.0, 10.0, 1.0], jnp.float32)


def random_poses(rng, B, H):
    """Poses as tests/test_gn_pallas.py:_problem draws them."""
    R = so3_exp(T(rng.normal(size=(B, H, 3)) * 0.5))
    t = rng.normal(size=(B, H, 3)) * 300
    t[..., 2] -= 2500.0
    return R.contiguous(), T(t).contiguous()


def random_scene(rng, B, N):
    coords = np.stack([rng.uniform(-1000, 1000, (B, N)),
                       rng.uniform(-800, 800, (B, N)),
                       rng.uniform(-500, 500, (B, N))], -1)
    pix = np.stack([rng.uniform(0, 640, (B, N)),
                    rng.uniform(0, 480, (B, N))], -1)
    return T(coords), T(pix)


def jnp_of(x):
    return jnp.asarray(x.numpy())


def test_diffmaps_match_pallas_kernel_at_nonaligned_shapes(rng):
    R, t = random_poses(rng, 2, 37)
    coords, pix = random_scene(rng, 2, 130)
    R[:, :3] = torch.eye(3)  # identity lanes: z = 0 meets the depth guard
    t[:, :3] = 0.0
    coords[:, 0] = 0.0
    got = diffmaps(R, t, coords, pix, CAM)
    assert got.shape == (2, 37, 130)
    for b in range(2):
        ref = diffmaps_pallas(jnp_of(R[b]), jnp_of(t[b]), jnp_of(coords[b]),
                              jnp_of(pix[b]), CAM_VEC, interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-2)
    assert float(got.max()) <= 100.0 and torch.isfinite(got).all()


def test_irls_stats_match_pallas_kernel(rng):
    R, t = random_poses(rng, 2, 16)
    coords, pix = random_scene(rng, 2, 700)
    got = irls_stats(R, t, coords, pix, CAM)
    assert got.shape == (2, 16, 28)
    JtJ, Jtr, n_in = unpack_stats(got)
    for b in range(2):
        ref = jax_irls_stats(jnp_of(R[b]), jnp_of(t[b]), jnp_of(coords[b]),
                             jnp_of(pix[b]), STATS_VEC, interpret=True)
        rJtJ, rJtr, rn = (np.asarray(x) for x in jax_unpack(ref))
        np.testing.assert_allclose(n_in[b].numpy(), rn, rtol=1e-3, atol=0.05)
        np.testing.assert_allclose(Jtr[b].numpy(), rJtr, rtol=2e-3, atol=2.0)
        np.testing.assert_allclose(JtJ[b].numpy(), rJtJ, rtol=2e-3, atol=2.0)


def test_unpack_stats_matches_reference(rng):
    stats = rng.normal(size=(5, 28)).astype(np.float32)
    got = unpack_stats(torch.from_numpy(stats))
    for g, r in zip(got, jax_unpack(jnp.asarray(stats))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_stepwise_refiner_matches_reference(rng):
    """The scene of tests/test_gn_pallas.py:test_single_launch_matches_
    step_scan, in two frames: 5 poses per frame near the true one."""
    gt, coords, pix = frames(rng, B=2, N=700, noise=6.0, outliers=0.0)
    w = rng.normal(size=(2, 5, 3)) * 0.01
    R0 = (so3_exp(T(w)) @ gt.R[:, None]).contiguous()
    t0 = (gt.t[:, None] + T(rng.normal(size=(2, 5, 3)) * 30)).contiguous()
    out, n_in = refine_pose_fused_steps(Pose(R0, t0), coords, pix, CAM,
                                        steps=12)
    for b in range(2):
        ref, rn = jax_steps(JPose(jnp_of(R0[b]), jnp_of(t0[b])),
                            jnp_of(coords[b]), jnp_of(pix[b]), JCAM,
                            steps=12, interpret=True)
        np.testing.assert_allclose(out.t[b].numpy(), np.asarray(ref.t),
                                   atol=1e-2)
        np.testing.assert_allclose(out.R[b].numpy(), np.asarray(ref.R),
                                   atol=1e-5)
        np.testing.assert_allclose(n_in[b].numpy(), np.asarray(rn),
                                   rtol=1e-4)


def test_stepwise_refiner_freezes_below_min_inliers(rng):
    gt, coords, pix = frames(rng, B=1, N=300, outliers=1.0)
    p0 = Pose(gt.R[:, None].contiguous(), gt.t[:, None].contiguous())
    out, n_in = refine_pose_fused_steps(p0, coords, pix, CAM)
    assert float(n_in[0, 0]) < 50.0
    np.testing.assert_array_equal(out.t.numpy(), p0.t.numpy())
    np.testing.assert_array_equal(out.R.numpy(), p0.R.numpy())


class TestWrappers:
    def _inputs(self, rng):
        R, t = random_poses(rng, 1, 4)
        coords, pix = random_scene(rng, 1, 32)
        return R, t, coords, pix

    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self, rng):
        R, t, coords, pix = self._inputs(rng)
        before = (diffmaps.launches, irls_stats.launches)
        torch.testing.assert_close(diffmaps(R, t, coords, pix, CAM),
                                   diffmaps_ref(R, t, coords, pix, CAM))
        torch.testing.assert_close(irls_stats(R, t, coords, pix, CAM),
                                   irls_stats_ref(R, t, coords, pix, CAM))
        refine_pose_fused_steps(Pose(R, t), coords, pix, CAM, steps=2)
        assert (diffmaps.launches, irls_stats.launches) == before

    def test_rejects_wrong_dtype_shape_layout_and_device(self, rng):
        R, t, coords, pix = self._inputs(rng)
        with pytest.raises(TypeError):
            diffmaps(R, t, coords.double(), pix, CAM)
        with pytest.raises(ValueError):
            diffmaps(R, t, coords[:, :16], pix, CAM)
        with pytest.raises(ValueError):
            irls_stats(R.transpose(-1, -2), t, coords, pix, CAM)
        with pytest.raises(ValueError):
            irls_stats(R.to("meta"), t.to("meta"), coords.to("meta"),
                       pix.to("meta"), CAM)
