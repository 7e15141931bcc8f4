"""The port's serve path (dsac_tpu_torch.pipeline.process_frames_batched)
against dsac_tpu.pipeline.forward.process_frames_batched, stage by stage,
with the reference's own random draws injected.

Small config: 160x120 frames, a 12x12 grid, H=64 hypotheses, T=4 attempts,
verify_topk=4; fused_soft scoring, two-phase sampling and the fused
refiner, whose Pallas kernels run in interpret mode.  The coordinate
network is replaced by ground-truth scene coordinates (numpy: 4 mm noise,
30% uniform outliers), so that frames are localisable.

Tolerances: sampling and coordinates are exact.  The port's CPU path uses
the kernels' plain versions, whose P3P differs from the Pallas kernel in
the last bits (agreement >= 0.98 on decisions, as the kernel bar), so
validity masks agree on >= 95% of lanes and scores on lanes valid on both
sides to 0.05 of a count up to 144.  The served pose is held at the refine
bars of tests/test_gn_pallas.py:79-83 (2 mm, 1e-4).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.config import DataConfig as JData
from dsac_tpu.config import DSACConfig as JCfg
from dsac_tpu.config import NetConfig as JNet
from dsac_tpu.config import PoseConfig as JPoseCfg
from dsac_tpu.data.synthetic import SyntheticScene as JScene
from dsac_tpu.pipeline.forward import process_frames_batched as jax_serve
from dsac_tpu_torch.config import Camera, DataConfig, DSACConfig, NetConfig
from dsac_tpu_torch.config import PoseConfig
from dsac_tpu_torch.geometry.loss import pose_errors
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.pipeline import (FrameDraws, process_frame,
                                     process_frames_batched)
from torch_problems import one_torch_thread  # noqa: F401

B, W, HGT, FOCAL, G, NH, T, TOPK = 2, 160, 120, 130.0, 12, 64, 4, 4
POSE_KW = dict(num_hypotheses=NH, sample_attempts=T, random_draw=False)
DATA_KW = dict(image_width=W, image_height=HGT, focal_length=FOCAL)


def reference_draws(key, cfg):
    """The draws process_frame makes from `key` (forward.py:318, :97;
    sampling.py:165-173, :110): stratified jitter, phase-1 and phase-2
    minimal-set indices."""
    k_front, _k_draw = jax.random.split(key)
    k_samp, k_hyp = jax.random.split(k_front)
    kx, ky = jax.random.split(k_samp)
    jitter = jnp.stack([jax.random.uniform(kx, (G, G)),
                        jax.random.uniform(ky, (G, G))])
    k1, k2 = jax.random.split(k_hyp)
    n = G * G
    K = max(1, int(math.ceil(NH * cfg.pose.two_phase_budget)))
    idx1 = jax.random.randint(k1, (NH, 1, 4), 0, n)
    idx2 = jax.random.randint(k2, (K, T - 1, 4), 0, n)
    return jitter, idx1, idx2


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(1305)
    jscene = JScene(width=W, height=HGT, focal=FOCAL)
    gt_R, gt_t, maps = [], [], []
    for i in range(B):
        pose, _rgb, _depth, coords = jscene.frame(jax.random.PRNGKey(7 + i))
        c = np.asarray(coords) + rng.normal(size=coords.shape) * 4.0
        out = rng.random(c.shape[:2]) < 0.3
        c[out] = rng.uniform(0, 4000, size=(out.sum(), 3))
        gt_R.append(np.asarray(pose.R))
        gt_t.append(np.asarray(pose.t))
        maps.append(c / 1000.0)  # metres, as a coordinate net predicts
    maps = np.stack(maps).astype(np.float32)

    jcfg = JCfg(pose=JPoseCfg(**POSE_KW), data=JData(**DATA_KW),
                net=JNet(subsample_size=G))
    keys = jax.random.split(jax.random.PRNGKey(11), B)

    def jcoord_fn(image, pix):
        return image[pix[:, 1], pix[:, 0]]

    ref = jax.jit(lambda k, im: jax_serve(
        k, im, jcoord_fn, None, jscene.camera, jcfg, refine_all=False,
        fused_refine="fused", scoring="fused_soft",
        fused_sampling="two_phase", verify_topk=TOPK))(keys, jnp.asarray(maps))
    ref = jax.tree.map(np.asarray, ref)

    draws = [reference_draws(k, jcfg) for k in keys]
    draws = FrameDraws(*(torch.from_numpy(np.stack([np.asarray(d[i])
                                                    for d in draws]))
                         .to(torch.int64 if i else torch.float32)
                         for i in range(3)))
    cfg = DSACConfig(pose=PoseConfig(**POSE_KW), data=DataConfig(**DATA_KW),
                     net=NetConfig(subsample_size=G))

    def coord_fn(images, pix):
        b = torch.arange(images.shape[0])[:, None]
        return images[b, pix[..., 1], pix[..., 0]]

    got = process_frames_batched(torch.from_numpy(maps), coord_fn,
                                 Camera.make(FOCAL, W, HGT), cfg,
                                 verify_topk=TOPK, draws=draws)
    gt = Pose(torch.from_numpy(np.stack(gt_R)),
              torch.from_numpy(np.stack(gt_t)))
    return got, ref, gt, maps, cfg, coord_fn, draws


def test_sampling_and_coords_are_exact(served):
    got, ref, *_ = served
    np.testing.assert_array_equal(got.sampling.numpy(), ref.sampling)
    np.testing.assert_allclose(got.coords.numpy(), ref.coords, rtol=1e-6)


def test_hypothesis_pool_matches(served):
    got, ref, *_ = served
    valid = got.hyp_valid.numpy()
    assert (valid == ref.hyp_valid).mean() >= 0.95
    assert valid.mean() > 0.2  # 0.7^4 of the draws avoid the outliers
    same = (got.minimal_indices.numpy() == ref.minimal_indices).all(-1)
    both = valid & ref.hyp_valid & same
    assert both.mean() > 0.2
    dR = np.abs(got.hyps.R.numpy() - ref.hyps.R).reshape(B, NH, -1).max(-1)
    assert np.median(dR[both]) < 1e-3
    for x in (got.hyps.R, got.hyps.t):
        assert torch.isfinite(x).all()


def test_scores_match_on_common_hypotheses(served):
    got, ref, *_ = served
    dR = np.abs(got.hyps.R.numpy() - ref.hyps.R).reshape(B, NH, -1).max(-1)
    both = got.hyp_valid.numpy() & ref.hyp_valid & (dR < 1e-3)
    np.testing.assert_allclose(got.scores.numpy()[both], ref.scores[both],
                               atol=0.05)
    assert (got.scores.numpy()[~got.hyp_valid.numpy()] == -1e9).all()


def test_served_pose_matches(served):
    got, ref, gt, *_ = served
    np.testing.assert_allclose(got.final.t.numpy(), ref.final.t, atol=2.0)
    np.testing.assert_allclose(got.final.R.numpy(), ref.final.R, atol=1e-4)
    # the chosen hypothesis is the reference's, unless the top-K refine to
    # the same pose with inlier counts tied within the refine bar
    for b, c in enumerate(got.chosen.tolist()):
        if c != ref.chosen[b]:
            counts = ref.inlier_counts[b]
            assert abs(counts[c] - counts[ref.chosen[b]]) < 0.5
    assert got.refined_mask.sum(-1).tolist() == [TOPK] * B
    rot, trans = pose_errors(got.final, gt)
    assert float(rot.max()) < 5.0 and float(trans.max()) < 50.0


def test_winner_only_branch_and_single_frame(served):
    """verify_topk=0 refines only the argmax; process_frame is the B=1
    case of the batch."""
    got, ref, gt, maps, cfg, coord_fn, draws = served
    one = process_frames_batched(torch.from_numpy(maps), coord_fn,
                                 Camera.make(FOCAL, W, HGT), cfg,
                                 verify_topk=0, draws=draws)
    np.testing.assert_array_equal(
        one.chosen.numpy(), torch.argmax(one.scores, dim=-1).numpy())
    assert one.refined_mask.sum(-1).tolist() == [1] * B
    rot, trans = pose_errors(one.final, gt)
    assert float(rot.max()) < 5.0 and float(trans.max()) < 50.0

    single = process_frame(
        torch.from_numpy(maps[1]), coord_fn, Camera.make(FOCAL, W, HGT),
        cfg, verify_topk=TOPK,
        draws=FrameDraws(*(None if d is None else d[1:] for d in draws)))
    torch.testing.assert_close(single.final.t, got.final.t[1])
    assert single.scores.shape == (NH,)


def test_random_draw_samples_the_softmax(served):
    """random_draw=True (DSAC) draws the winner from softmax(scores) with
    the generator: seeded draws repeat, and only valid hypotheses (whose
    scores are not buried at -1e9) can win."""
    *_, maps, cfg, coord_fn, draws = served
    cfg = dataclasses.replace(cfg, pose=dataclasses.replace(
        cfg.pose, random_draw=True))
    runs = [process_frames_batched(
        torch.from_numpy(maps), coord_fn, Camera.make(FOCAL, W, HGT), cfg,
        verify_topk=0, draws=draws, generator=torch.Generator().manual_seed(5))
        for _ in range(2)]
    np.testing.assert_array_equal(runs[0].chosen.numpy(),
                                  runs[1].chosen.numpy())
    chosen = runs[0].chosen[:, None]
    assert torch.gather(runs[0].hyp_valid, 1, chosen).all()


def test_generator_draws_are_seeded(served):
    *_, maps, cfg, coord_fn, _draws = served
    runs = [process_frames_batched(
        torch.from_numpy(maps), coord_fn, Camera.make(FOCAL, W, HGT), cfg,
        verify_topk=TOPK, generator=torch.Generator().manual_seed(3))
        for _ in range(2)]
    torch.testing.assert_close(runs[0].final.t, runs[1].final.t)
    np.testing.assert_array_equal(runs[0].minimal_indices.numpy(),
                                  runs[1].minimal_indices.numpy())
