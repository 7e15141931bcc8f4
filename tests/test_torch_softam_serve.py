"""The port's SoftAM serving (process_frames_batched(softam=True), i.e.
process_frame_softam with the serve options) against
dsac_tpu.pipeline.forward.process_frames_batched(softam=True), with the
reference's own random draws injected, for each combination of scoring
("fused_soft": the score kernel; "cnn": the diff-map kernel and the
soft-inlier head of cli/common.py:soft_inlier_score_fn) and sampling
("two_phase", or fixed-T through the P3P kernel), with the fused refiner
on the average.  The reference's Pallas kernels run in interpret mode, the
port's wrappers their plain versions.

Small config: 160x120 frames, a 40x40 grid (N = 1,600), H = 32
hypotheses, T = 4 attempts.  The coordinate network is replaced by the
reference frame's ground-truth scene coordinates with 4 mm noise and 30%
uniform outliers (numpy), as tests/test_torch_pipeline_cnn.py makes them:
the pipeline samples its pixels from a dense map.

Tolerances: sampling and coordinates exact; validity on >= 95% of lanes
(the P3P kernel bar, 0.98, of 32 lanes).  On the reference's own pool, the
port's scoring and softmax give its probabilities to 1e-4 and its
average at the refine bars (2 mm, 1e-4; tests/test_gn_pallas.py:79-83).
End to end, the refined average (the served pose) at the refine bars; the
probabilities of lanes valid on both sides with the same minimal set and
poses within 1e-3 ("common" lanes) to 1e-2 and the average to 2 mm and
1e-3, because the two P3P solves of an ill-conditioned set differ (see
test_probabilities_average_and_served_pose).  Every lane of the port
finite, masked lanes included.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.cli.common import soft_inlier_score_fn as jax_soft_head
from dsac_tpu.config import DataConfig as JData
from dsac_tpu.config import DSACConfig as JCfg
from dsac_tpu.config import NetConfig as JNet
from dsac_tpu.config import PoseConfig as JPoseCfg
from dsac_tpu.data.synthetic import SyntheticScene as JScene
from dsac_tpu.geometry.pose import pose_from_vec6 as jax_from_vec6
from dsac_tpu.geometry.pose import pose_to_vec6 as jax_to_vec6
from dsac_tpu.pipeline.forward import process_frames_batched as jax_forward
from dsac_tpu_torch.cli.common import soft_inlier_score_fn
from dsac_tpu_torch.config import Camera, DataConfig, DSACConfig, NetConfig
from dsac_tpu_torch.config import PoseConfig
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.pipeline import FrameDraws, process_frames_batched
from dsac_tpu_torch.pipeline.forward import score_hypotheses, softam_average
from torch_problems import one_torch_thread  # noqa: F401

B, W, HGT, FOCAL, G, NH, T = 2, 160, 120, 130.0, 40, 32, 4
POSE_KW = dict(num_hypotheses=NH, sample_attempts=T, random_draw=False)
DATA_KW = dict(image_width=W, image_height=HGT, focal_length=FOCAL)
CASES = [(scoring, sampling) for scoring in ("fused_soft", "cnn")
         for sampling in ("two_phase", True)]


def reference_draws(key, cfg, sampling):
    """The draws process_frame_softam makes from `key` (forward.py:449,
    :97; sampling.py): stratified jitter, then the two-phase sampler's
    phase-1 and phase-2 minimal sets, or fixed-T's (H, T, 4)."""
    k_front, _ = jax.random.split(key)
    k_samp, k_hyp = jax.random.split(k_front)
    kx, ky = jax.random.split(k_samp)
    jitter = jnp.stack([jax.random.uniform(kx, (G, G)),
                        jax.random.uniform(ky, (G, G))])
    n = G * G
    if sampling != "two_phase":
        return jitter, jax.random.randint(k_hyp, (NH, T, 4), 0, n)
    k1, k2 = jax.random.split(k_hyp)
    K = max(1, int(math.ceil(NH * cfg.pose.two_phase_budget)))
    return (jitter, jax.random.randint(k1, (NH, 1, 4), 0, n),
            jax.random.randint(k2, (K, T - 1, 4), 0, n))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(1305)
    jscene = JScene(width=W, height=HGT, focal=FOCAL)
    maps = []
    for i in range(B):
        _pose, _rgb, _depth, coords = jscene.frame(jax.random.PRNGKey(7 + i))
        c = np.asarray(coords) + rng.normal(size=coords.shape) * 4.0
        out = rng.random(c.shape[:2]) < 0.3
        c[out] = rng.uniform(0, 4000, size=(out.sum(), 3))
        maps.append(c / 1000.0)  # metres, as a coordinate net predicts
    return jscene, np.stack(maps).astype(np.float32)


def coord_fn(images, pix):
    b = torch.arange(images.shape[0])[:, None]
    return images[b, pix[..., 1], pix[..., 0]]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{s}-{'two_phase' if p == 'two_phase' else 'fixed_t'}"
                     for s, p in CASES])
def served(request, scene):
    jscene, maps = scene
    scoring, sampling = request.param
    jcfg = JCfg(pose=JPoseCfg(**POSE_KW), data=JData(**DATA_KW),
                net=JNet(subsample_size=G))
    keys = jax.random.split(jax.random.PRNGKey(11), B)

    def run(k, im):
        res = jax_forward(k, im, lambda image, pix: image[pix[:, 1],
                                                          pix[:, 0]],
                          jax_soft_head(jcfg), jscene.camera, jcfg,
                          fused_refine=True, scoring=scoring,
                          fused_sampling=sampling, softam=True)
        avg = jax.vmap(lambda pr, R, t: jax_from_vec6(jnp.sum(
            pr[:, None] * jax_to_vec6(type(res.hyps)(R, t)), axis=0)))(
                res.probs, res.hyps.R, res.hyps.t)
        return res, avg

    ref, ref_avg = jax.tree.map(np.asarray, jax.jit(run)(
        keys, jnp.asarray(maps)))
    draws = [reference_draws(k, jcfg, sampling) for k in keys]
    stacked = [torch.from_numpy(np.stack([np.asarray(d[i]) for d in draws]))
               for i in range(len(draws[0]))]
    draws = (FrameDraws(stacked[0], idx1=stacked[1].long(),
                        idx2=stacked[2].long())
             if sampling == "two_phase"
             else FrameDraws(stacked[0], idx=stacked[1].long()))
    cfg = DSACConfig(pose=PoseConfig(**POSE_KW), data=DataConfig(**DATA_KW),
                     net=NetConfig(subsample_size=G))
    with torch.no_grad():
        got = process_frames_batched(
            torch.from_numpy(maps), coord_fn, Camera.make(FOCAL, W, HGT),
            cfg, draws=draws, scoring=scoring,
            score_fn=soft_inlier_score_fn(cfg), sampling=sampling,
            fused_refine=True, softam=True)
    return got, ref, ref_avg, scoring


def common_lanes(got, ref):
    dR = np.abs(got.hyps.R.numpy() - ref.hyps.R).reshape(B, NH, -1).max(-1)
    same = (got.minimal_indices.numpy() == ref.minimal_indices).all(-1)
    return got.hyp_valid.numpy() & ref.hyp_valid & same & (dR < 1e-3)


def test_pool(served):
    got, ref, _avg, scoring = served
    np.testing.assert_array_equal(got.sampling.numpy(), ref.sampling)
    np.testing.assert_allclose(got.coords.numpy(), ref.coords, rtol=1e-6)
    assert (got.hyp_valid.numpy() == ref.hyp_valid).mean() >= 0.95
    assert common_lanes(got, ref).mean() > 0.2
    assert (got.scores.numpy()[~got.hyp_valid.numpy()] == -1e9).all()
    assert got.dmaps.shape == ref.dmaps.shape
    assert got.dmaps.shape[1] == (0 if scoring == "fused_soft" else NH)


def test_probabilities_and_average_of_the_reference_pool(served):
    """The port's scoring, masking, softmax and average on the reference's
    own pool: the probabilities to 1e-4, the average at the refine bars."""
    got, ref, ref_avg, scoring = served
    cfg = DSACConfig(pose=PoseConfig(**POSE_KW), data=DataConfig(**DATA_KW),
                     net=NetConfig(subsample_size=G))
    pool = Pose(torch.tensor(ref.hyps.R), torch.tensor(ref.hyps.t))
    _dm, _scores, probs, _ent = score_hypotheses(
        pool, torch.tensor(ref.hyp_valid), got.coords,
        got.sampling.reshape(B, -1, 2).float(), Camera.make(FOCAL, W, HGT),
        cfg, scoring, soft_inlier_score_fn(cfg))
    np.testing.assert_allclose(probs.numpy(), ref.probs, atol=1e-4)
    avg = softam_average(probs, pool)
    np.testing.assert_allclose(avg.t.numpy(), ref_avg.t, atol=2.0)
    np.testing.assert_allclose(avg.R.numpy(), ref_avg.R, atol=1e-4)


def test_probabilities_average_and_served_pose(served):
    """End to end.  The probabilities of common lanes to 1e-2 and the
    average to 2 mm and 1e-3: the two P3P solves of one minimal set differ
    by up to ~3e-3 and ~3 mm where a set is ill-conditioned (P3P is held
    at decision agreement >= 0.98 and a median |dR| < 1e-3), which moves a
    dominant lane's score by ~1e-2 of a count and the average by its
    weight times that gap (measured on these frames: up to 4e-3 on the
    probabilities, 0.44 mm and 3.1e-4 on the average).  The refined
    average, the served pose, at the refine bars (2 mm, 1e-4)."""
    got, ref, ref_avg, _ = served
    both = common_lanes(got, ref)
    np.testing.assert_allclose(got.probs.numpy()[both], ref.probs[both],
                               atol=1e-2)
    avg = softam_average(got.probs, got.hyps)
    np.testing.assert_allclose(avg.t.numpy(), ref_avg.t, atol=2.0)
    np.testing.assert_allclose(avg.R.numpy(), ref_avg.R, atol=1e-3)
    np.testing.assert_allclose(got.final.t.numpy(), ref.final.t, atol=2.0)
    np.testing.assert_allclose(got.final.R.numpy(), ref.final.R, atol=1e-4)
    # the reference's fields (forward.py:472-478): the unrefined pool, the
    # refined average, argmax of the probabilities
    assert torch.equal(got.refined.R, got.hyps.R)
    assert not got.refined_mask.any()
    assert got.chosen.tolist() == torch.argmax(got.probs, -1).tolist()
    assert got.chosen.tolist() == ref.chosen.tolist()
    np.testing.assert_allclose(got.inlier_counts.numpy(), ref.inlier_counts,
                               rtol=1e-3, atol=0.5)


def test_every_lane_is_finite(served):
    got, *_ = served
    for x in (got.hyps.R, got.hyps.t, got.scores, got.probs, got.entropy,
              got.dmaps, got.final.R, got.final.t, got.inlier_counts):
        assert torch.isfinite(x).all()


def test_average_ignores_a_non_finite_lane_of_weight_zero():
    """A lane of weight 0 whose pose is not finite leaves the average as it
    is without that lane."""
    rng = np.random.default_rng(3)
    R = torch.from_numpy(np.linalg.qr(rng.normal(size=(1, 4, 3, 3)))[0]
                         .astype(np.float32))
    R = R * torch.sign(torch.linalg.det(R))[..., None, None]
    t = torch.from_numpy(rng.normal(size=(1, 4, 3)).astype(np.float32))
    probs = torch.tensor([[0.5, 0.25, 0.25, 0.0]])
    clean = softam_average(probs[:, :3], Pose(R[:, :3], t[:, :3]))
    t_bad = t.clone()
    t_bad[0, 3] = float("nan")
    got = softam_average(probs, Pose(R, t_bad))
    torch.testing.assert_close(got.t, clean.t)
    torch.testing.assert_close(got.R, clean.R)
