"""The three kernel modules of the port against the reference's Pallas
kernels, run in interpret mode as tests/test_pallas_kernels.py and
tests/test_gn_pallas.py run them.  On the CPU each wrapper takes its plain
PyTorch version, which is what these tests hold to the reference; the CUDA
kernels are held to the same plain versions on the card by chip_smoke.py
and tests/test_torch_cuda.py.

Bars (the reference's own):
  P3P     decision agreement >= 0.98 (results/tpu_kernel_check.json) and
          median |dR| < 1e-3 on lanes both accept
          (tests/test_pallas_kernels.py:97-131);
  score   max abs error <= 1e-3: a sum of 1600 terms <= 1 in another order;
  refine  |dt| <= 2 mm, |dR| <= 1e-4 (tests/test_gn_pallas.py:79-83),
          n_in within 0.5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.config import Camera as JCamera
from dsac_tpu.geometry.pose import Pose as JPose
from dsac_tpu.ops.diffmap_pallas import soft_inlier_scores_pallas
from dsac_tpu.ops.gn_pallas import refine_pose_fused as jax_refine_fused
from dsac_tpu.ops.p3p_pallas import p3p_solve_pallas
from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.rotation import so3_exp
from dsac_tpu_torch.ops import _build
from dsac_tpu_torch.ops.diffmap_cuda import (soft_inlier_scores,
                                             soft_inlier_scores_ref)
from dsac_tpu_torch.ops.gn_cuda import (refine_pose_fused,
                                        refine_pose_fused_ref)
from dsac_tpu_torch.ops.p3p_cuda import p3p_solve, p3p_solve_ref
from torch_problems import T, frames, one_torch_thread  # noqa: F401

JCAM = JCamera.make(525.0, 640, 480)
CAM = Camera.make(525.0, 640, 480)
CAM_VEC = jnp.asarray([525.0, 320.0, 240.0], jnp.float32)


class TestP3P:
    def test_plain_version_matches_pallas_kernel(self, rng):
        _, coords, pix = frames(rng, B=1)
        idx = rng.integers(0, 1600, size=(512, 4))
        obj, img = coords[0][idx].contiguous(), pix[0][idx].contiguous()
        pose, valid, worst = p3p_solve(obj, img, CAM)
        jp, jv, jw = p3p_solve_pallas(jnp.asarray(obj.numpy()),
                                      jnp.asarray(img.numpy()), CAM_VEC,
                                      interpret=True)
        pc = valid.numpy() & (worst.numpy() < 10.0)
        jc = np.asarray(jv) & (np.asarray(jw) < 10.0)
        assert (pc == jc).mean() >= 0.98
        assert 0.05 < pc.mean() < 0.95  # the pool holds both kinds
        both = pc & jc
        dR = np.abs(pose.R.numpy() - np.asarray(jp.R)).reshape(512, -1)
        assert np.median(dR.max(1)[both]) < 1e-3

    def test_invalid_lanes_identity_and_finite(self, rng):
        _, coords, pix = frames(rng, B=1, N=64)
        idx = rng.integers(0, 64, size=(16, 4))
        obj, img = coords[0][idx].clone(), pix[0][idx].contiguous()
        obj[0] = obj[0, 0]  # all four points coincident
        pose, valid, worst = p3p_solve(obj, img, CAM)
        assert not bool(valid[0])
        np.testing.assert_allclose(pose.R[0].numpy(), np.eye(3), atol=1e-6)
        np.testing.assert_allclose(pose.t[0].numpy(), 0.0, atol=1e-6)
        for x in (pose.R, pose.t, worst):
            assert torch.isfinite(x).all()


class TestScore:
    @pytest.mark.parametrize("N", [1600, 100])
    def test_plain_version_matches_pallas_kernel(self, rng, N):
        gt, coords, pix = frames(rng, B=2, N=N)
        w = rng.normal(size=(2, 64, 3)) * 0.02
        R = (so3_exp(T(w)) @ gt.R[:, None]).contiguous()
        t = (gt.t[:, None] + T(rng.normal(size=(2, 64, 3)) * 50)).contiguous()
        R[:, :8] = torch.eye(3)  # identity lanes, as invalid P3P lanes give
        t[:, :8] = 0.0
        got = soft_inlier_scores(R, t, coords, pix, CAM)
        assert got.shape == (2, 64)
        for b in range(2):
            ref = soft_inlier_scores_pallas(
                jnp.asarray(R[b].numpy()), jnp.asarray(t[b].numpy()),
                jnp.asarray(coords[b].numpy()), jnp.asarray(pix[b].numpy()),
                CAM_VEC, interpret=True)
            np.testing.assert_allclose(got[b].numpy(), np.asarray(ref),
                                       rtol=0, atol=1e-3)


class TestRefine:
    def test_plain_version_matches_pallas_kernel(self, rng):
        gt, coords, pix = frames(rng, B=2, N=900)
        w = rng.normal(size=(2, 4, 3)) * 0.005
        R0 = (so3_exp(T(w)) @ gt.R[:, None]).contiguous()
        t0 = (gt.t[:, None] + T(rng.normal(size=(2, 4, 3)) * 15)).contiguous()
        out, n_in = refine_pose_fused(Pose(R0, t0), coords, pix, CAM)
        for b in range(2):
            ref, jn = jax_refine_fused(
                JPose(jnp.asarray(R0[b].numpy()), jnp.asarray(t0[b].numpy())),
                jnp.asarray(coords[b].numpy()), jnp.asarray(pix[b].numpy()),
                JCAM, steps=16, interpret=True)
            np.testing.assert_allclose(out.t[b].numpy(), np.asarray(ref.t),
                                       atol=2.0)
            np.testing.assert_allclose(out.R[b].numpy(), np.asarray(ref.R),
                                       atol=1e-4)
            np.testing.assert_allclose(n_in[b].numpy(), np.asarray(jn),
                                       atol=0.5)

    def test_frozen_pose_keeps_its_start(self, rng):
        """Below min_inliers the pose never moves and n_in is the count at
        the start pose, in the plain version as in the kernel."""
        gt, coords, pix = frames(rng, B=1, N=300, outliers=1.0)
        p0 = Pose(gt.R[:, None].contiguous(), gt.t[:, None].contiguous())
        out, n_in = refine_pose_fused(p0, coords, pix, CAM)
        assert float(n_in[0, 0]) < 50.0
        np.testing.assert_array_equal(out.t.numpy(), p0.t.numpy())


class TestWrappers:
    def _inputs(self, rng):
        gt, coords, pix = frames(rng, B=1, N=32)
        R = gt.R[:, None].expand(1, 4, 3, 3).contiguous()
        t = gt.t[:, None].expand(1, 4, 3).contiguous()
        return R, t, coords, pix

    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self, rng):
        R, t, coords, pix = self._inputs(rng)
        before = (p3p_solve.launches, soft_inlier_scores.launches,
                  refine_pose_fused.launches)
        torch.testing.assert_close(
            soft_inlier_scores(R, t, coords, pix, CAM),
            soft_inlier_scores_ref(R, t, coords, pix, CAM))
        a, na = refine_pose_fused(Pose(R, t), coords, pix, CAM)
        b, nb = refine_pose_fused_ref(Pose(R, t), coords, pix, CAM)
        torch.testing.assert_close(a.t, b.t)
        torch.testing.assert_close(na, nb)
        obj, img = coords[0, :8].reshape(2, 4, 3), pix[0, :8].reshape(2, 4, 2)
        torch.testing.assert_close(p3p_solve(obj, img, CAM)[0].R,
                                   p3p_solve_ref(obj, img, CAM)[0].R)
        assert (p3p_solve.launches, soft_inlier_scores.launches,
                refine_pose_fused.launches) == before

    def test_rejects_wrong_dtype_shape_layout_and_device(self, rng):
        R, t, coords, pix = self._inputs(rng)
        with pytest.raises(TypeError):
            soft_inlier_scores(R, t, coords.double(), pix, CAM)
        with pytest.raises(ValueError):
            soft_inlier_scores(R, t, coords[:, :16], pix, CAM)
        with pytest.raises(ValueError):
            soft_inlier_scores(R.transpose(-1, -2), t, coords, pix, CAM)
        with pytest.raises(ValueError):
            refine_pose_fused(Pose(R.to("meta"), t.to("meta")),
                              coords.to("meta"), pix.to("meta"), CAM)
        with pytest.raises(ValueError):
            p3p_solve(coords[0, :8].reshape(2, 4, 3), pix[0, :6], CAM)

    @pytest.mark.parametrize("mangled, name", [
        ("_ZN12_GLOBAL__N_113refine_kernelENS_10RefineArgsE",
         "refine_kernel"),
        ("_ZN12_GLOBAL__N_110p3p_kernelILi4EEEvPKfS2_iPf", "p3p_kernel<4>"),
        ("_ZN12_GLOBAL__N_117irls_stats_kernelILb1EEEvNS_8IrlsArgsE",
         "irls_stats_kernel<true>"),
        ("_ZN12_GLOBAL__N_117irls_stats_kernelILb0EEEvNS_8IrlsArgsE",
         "irls_stats_kernel<false>"),
    ])
    def test_ptxas_report_names_each_instantiation(self, mangled, name):
        assert _build.kernel_name(mangled) == name

    def test_build_names_the_sources(self, monkeypatch, tmp_path):
        assert [p.name for p in _build.sources()] == [
            "diffmap.cu", "irls_stats.cu", "p3p.cu", "refine.cu", "score.cu"]
        assert [p.name for p in _build.headers()] == [
            "irls_stats.cuh", "pose_layout.cuh", "reproj.cuh"]
        name = _build.library_path().name
        assert name.startswith("libdsac_kernels_") and name.endswith(".so")
        assert _build.library_path() == _build.library_path()
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        if not _build.Path("/usr/local/cuda/bin/nvcc").exists():
            with pytest.raises(RuntimeError):
                _build.nvcc()
