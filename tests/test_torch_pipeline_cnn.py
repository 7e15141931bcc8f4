"""The port's score-CNN path (dsac_tpu_torch.pipeline with scoring="cnn")
against dsac_tpu.pipeline.forward.process_frames_batched, stage by stage,
with the reference's own random draws injected; its evaluation against
dsac_tpu.pipeline.evaluate; and rehearsals of the two entry points on the
CPU.

Small config: 160x120 frames, a 40x40 grid (N = 1600, the score net's
input size), H = 64 hypotheses, T = 4 attempts, and a ScoreNet at
width_mult 0.25 with random weights in f32, the same in both.  The
coordinate network is replaced by ground-truth scene coordinates (numpy:
4 mm noise, 30% uniform outliers).  Two forms:

  refine_all  the reference's test_ransac path: unfused fixed-T sampling
              (every attempt polished), the jnp refiner (the port's
              PyTorch IRLS), argmax, then verified_selection;
  verify_topk serving: fixed-T sampling through the P3P kernel (its plain
              version here, interpret-mode Pallas in the reference) and
              the fused refiner, top 4 refined.

Tolerances: sampling and coordinates are exact.  Hypotheses agree on
>= 95% of the validity decisions.  The two P3P solves differ in the last
bits, and the GN polish of a few ill-conditioned sets makes that ~5e-4
and ~2 mm; so the maps are held at the diff-map bar (rtol 1e-4, atol
1e-2; tests/test_pallas_kernels.py:42-53) on the reference's own
hypotheses and on lanes whose poses agree to 1e-5 and 0.05 mm, where the
scores agree to 1e-4; on lanes valid on both sides with the same minimal
set and poses within 1e-3 ("common" lanes) scores agree to 1e-2.  The
served pose is held at the refine bars (2 mm, 1e-4;
tests/test_gn_pallas.py:79-83), the refined pool at them on >= 90% of the
common lanes, losses (max of degrees and cm) to 0.2 and the expected loss
to 1e-2 relative + 0.2.

Run as a script, it prints the reference's test_ransac accuracy on the 64
fixture frames (the bar of chip_smoke.py's test_ransac phase):

    PYTHONPATH=. python tests/test_torch_pipeline_cnn.py 64
"""

import sys
from pathlib import Path

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
from dsac_tpu.geometry.loss import is_correct as jax_is_correct
from dsac_tpu.geometry.pose import Pose as JPose
from dsac_tpu.models.coord_net import DenseCoordNet as JCoordNet
from dsac_tpu.models.coord_net import gather_dense_coords as jax_gather
from dsac_tpu.models.score_net import ScoreNet as FlaxScoreNet
from dsac_tpu.pipeline.evaluate import evaluate_frame as jax_evaluate
from dsac_tpu.pipeline.evaluate import summarize as jax_summarize
from dsac_tpu.pipeline.forward import process_frame as jax_process
from dsac_tpu.pipeline.forward import process_frames_batched as jax_forward
from dsac_tpu.pipeline.forward import verified_selection as jax_verified
from dsac_tpu.utils.params_io import load_params_npz as jax_load
from dsac_tpu_torch.config import Camera, DataConfig, DSACConfig, NetConfig
from dsac_tpu_torch.config import PoseConfig
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.ops.diffmap_cuda import diffmaps
from dsac_tpu_torch.pipeline import (FrameDraws, FrameResult,
                                     evaluate_frame, process_frame,
                                     process_frames_batched, summarize,
                                     verified_selection)
from dsac_tpu_torch.utils.params_io import score_net_from_flax
from test_torch_score_net import flax_params
from torch_problems import random_score_flat, one_torch_thread  # noqa: F401

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
B, W, HGT, FOCAL, G, NH, T, TOPK = 2, 160, 120, 130.0, 40, 64, 4, 4
POSE_KW = dict(num_hypotheses=NH, sample_attempts=T, random_draw=False)
DATA_KW = dict(image_width=W, image_height=HGT, focal_length=FOCAL)
FORMS = {
    "refine_all": (dict(refine_all=True, fused_refine=False,
                        fused_sampling=False),
                   dict(refine_all=True, fused_refine=False,
                        sampling=False)),
    "verify_topk": (dict(refine_all=False, fused_refine="fused",
                         fused_sampling=True, verify_topk=TOPK),
                    dict(verify_topk=TOPK, sampling=True)),
}


def reference_draws(key):
    """The draws process_frame makes from `key` with fixed-T sampling
    (forward.py:318, :97; sampling.py:240, :110): stratified jitter and
    the (H, T, 4) minimal-set indices."""
    k_front, _k_draw = jax.random.split(key)
    k_samp, k_hyp = jax.random.split(k_front)
    kx, ky = jax.random.split(k_samp)
    jitter = jnp.stack([jax.random.uniform(kx, (G, G)),
                        jax.random.uniform(ky, (G, G))])
    return jitter, jax.random.randint(k_hyp, (NH, T, 4), 0, G * G)


@pytest.fixture(scope="module")
def scene():
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
    flat = random_score_flat(rng, 0.25)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    draws = [reference_draws(k) for k in keys]
    draws = FrameDraws(
        jitter=torch.from_numpy(np.stack([np.asarray(d[0]) for d in draws])),
        idx=torch.from_numpy(np.stack([np.asarray(d[1]) for d in draws])
                             ).to(torch.int64))
    gt = Pose(torch.from_numpy(np.stack(gt_R)),
              torch.from_numpy(np.stack(gt_t)))
    return jscene, maps, flat, keys, draws, gt


def coord_fn(images, pix):
    b = torch.arange(images.shape[0])[:, None]
    return images[b, pix[..., 1], pix[..., 0]]


@pytest.fixture(scope="module", params=list(FORMS))
def form(request, scene):
    jscene, maps, flat, keys, draws, gt = scene
    jkw, kw = FORMS[request.param]
    jcfg = JCfg(pose=JPoseCfg(**POSE_KW), data=JData(**DATA_KW),
                net=JNet(subsample_size=G))
    jnet = FlaxScoreNet(dtype=jnp.float32, width_mult=0.25)
    params = flax_params(flat)

    def jcoord_fn(image, pix):
        return image[pix[:, 1], pix[:, 0]]

    def run(k, im, gR, gt_):
        res = jax_forward(k, im, jcoord_fn, lambda dm: jnet.apply(params, dm),
                          jscene.camera, jcfg, scoring="cnn", **jkw)
        if jkw["refine_all"]:
            res = jax.vmap(jax_verified)(res)
        ev = jax.vmap(jax_evaluate)(res, JPose(gR, gt_))
        return res, ev

    ref, ref_ev = jax.tree.map(np.asarray, jax.jit(run)(
        keys, jnp.asarray(maps), jnp.asarray(gt.R.numpy()),
        jnp.asarray(gt.t.numpy())))
    cfg = DSACConfig(pose=PoseConfig(**POSE_KW), data=DataConfig(**DATA_KW),
                     net=NetConfig(subsample_size=G))
    net = score_net_from_flax(flat, dtype=torch.float32)
    with torch.no_grad():
        got = process_frames_batched(torch.from_numpy(maps), coord_fn,
                                     Camera.make(FOCAL, W, HGT), cfg,
                                     draws=draws, scoring="cnn", score_fn=net,
                                     **kw)
        if jkw["refine_all"]:
            got = verified_selection(got)
    return request.param, got, ref, evaluate_frame(got, gt), ref_ev, scene


def common_lanes(got, ref, max_dR=1e-3):
    dR = np.abs(got.hyps.R.numpy() - ref.hyps.R).reshape(B, NH, -1).max(-1)
    same = (got.minimal_indices.numpy() == ref.minimal_indices).all(-1)
    return got.hyp_valid.numpy() & ref.hyp_valid & same & (dR < max_dR)


def test_sampling_coords_and_pool(form):
    _name, got, ref, *_ = form
    np.testing.assert_array_equal(got.sampling.numpy(), ref.sampling)
    np.testing.assert_allclose(got.coords.numpy(), ref.coords, rtol=1e-6)
    assert (got.hyp_valid.numpy() == ref.hyp_valid).mean() >= 0.95
    assert common_lanes(got, ref).mean() > 0.2  # 0.7^4 of the draws
    for x in (got.hyps.R, got.hyps.t):
        assert torch.isfinite(x).all()


def test_diffmaps_and_scores_on_common_lanes(form):
    """The (B, H, G, G) maps hold each hypothesis's errors in the pixel
    order of the stratified grid (forward.py:110): a transposed map would
    miss the reference's.  The maps of the reference's own hypotheses
    match at the diff-map bar (rtol 1e-4, atol 1e-2); so do the pipeline's
    on lanes whose poses agree to 1e-5 and 0.05 mm (the polished P3P
    poses of a few ill-conditioned sets differ by up to ~5e-4 and ~2 mm,
    which moves their maps by up to ~0.2 px)."""
    _name, got, ref, *_ = form
    assert got.dmaps.shape == ref.dmaps.shape == (B, NH, G, G)
    pixf = got.sampling.reshape(B, -1, 2).float()
    own = diffmaps(torch.tensor(ref.hyps.R), torch.tensor(ref.hyps.t),
                   got.coords, pixf, Camera.make(FOCAL, W, HGT))
    np.testing.assert_allclose(own.reshape(B, NH, G, G).numpy(), ref.dmaps,
                               rtol=1e-4, atol=1e-2)
    assert not np.allclose(own.reshape(B, NH, G, G).transpose(-1, -2),
                           ref.dmaps, rtol=1e-4, atol=1e-2)
    tight = common_lanes(got, ref, 1e-5) & (np.abs(
        got.hyps.t.numpy() - ref.hyps.t).max(-1) < 0.05)
    assert tight.mean() > 0.2
    np.testing.assert_allclose(got.dmaps.numpy()[tight], ref.dmaps[tight],
                               rtol=1e-4, atol=1e-2)
    both = common_lanes(got, ref)
    np.testing.assert_allclose(got.scores.numpy()[tight], ref.scores[tight],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy()[both], ref.scores[both],
                               rtol=1e-2, atol=1e-2)
    assert (got.scores.numpy()[~got.hyp_valid.numpy()] == -1e9).all()


def within_refine_bars(got, ref):
    """(B, H) lanes whose refined poses agree at the refine bars."""
    dt = np.abs(got.refined.t.numpy() - ref.refined.t).max(-1)
    dR = np.abs(got.refined.R.numpy() - ref.refined.R).reshape(
        B, NH, -1).max(-1)
    return (dt <= 2.0) & (dR <= 1e-4)


def test_refined_pool_and_selection(form):
    """The served pose at the refine bars; under refine_all, where both
    sides run the same IRLS (8 reweightings of 2 GN steps), the refined
    pool at the bars on >= 90% of the common lanes (a wrong hypothesis
    that keeps 50 inliers can wander to another pose from a start 1e-5
    away).  Under verify_topk the reference runs the fused kernel's 16
    single steps and the port's CPU path the plain version, which reach
    the same fixed point on the served pose."""
    name, got, ref, *_ = form
    both = common_lanes(got, ref) & got.refined_mask.numpy() \
        & ref.refined_mask
    assert both.sum() >= (4 if name == "verify_topk" else 20)
    if name == "refine_all":
        assert within_refine_bars(got, ref)[both].mean() >= 0.9
    np.testing.assert_allclose(got.final.t.numpy(), ref.final.t, atol=2.0)
    np.testing.assert_allclose(got.final.R.numpy(), ref.final.R, atol=1e-4)
    # the chosen hypothesis is the reference's, unless two refine to the
    # same pose with inlier counts tied within the refine bar
    for b, c in enumerate(got.chosen.tolist()):
        if c != ref.chosen[b]:
            counts = ref.inlier_counts[b]
            assert abs(counts[c] - counts[ref.chosen[b]]) < 0.5
    if name == "refine_all":
        assert got.refined_mask.all()
        c = got.chosen[:, None]
        counts = torch.where(got.hyp_valid, got.inlier_counts, -1.0)
        assert (torch.gather(counts, 1, c) == counts.amax(-1, keepdim=True)
                ).all()
    else:
        assert got.refined_mask.sum(-1).tolist() == [TOPK] * B


def test_evaluate_frame_matches_reference(form):
    """Losses are max(degrees, cm): the refine bars (2 mm, 1e-4) allow
    0.2 of a loss; errors of the served pose likewise.  A validity flip of
    one of the 64 lanes (the P3P bar allows 2%) moves the entropy by a few
    hundredths of a bit."""
    _name, got, ref, ev, ref_ev, _scene = form
    both = common_lanes(got, ref) & got.refined_mask.numpy() \
        & within_refine_bars(got, ref)
    assert both.sum() >= 4
    np.testing.assert_allclose(ev.losses.numpy()[both], ref_ev.losses[both],
                               atol=0.2)
    np.testing.assert_allclose(ev.rot_err_deg.numpy(), ref_ev.rot_err_deg,
                               atol=0.02)
    np.testing.assert_allclose(ev.trans_err_mm.numpy(), ref_ev.trans_err_mm,
                               atol=3.5)
    np.testing.assert_array_equal(ev.correct.numpy(), ref_ev.correct)
    np.testing.assert_allclose(ev.entropy.numpy(), ref_ev.entropy,
                               rtol=1e-2, atol=0.05)
    np.testing.assert_allclose(ev.expected_loss.numpy(),
                               (got.probs * ev.losses).sum(-1).numpy(),
                               rtol=1e-6)


def test_evaluate_frame_of_the_reference_result(form):
    """evaluate_frame on the reference's own result gives the reference's
    evaluation (the expected loss weighs losses of up to ~1e3 with the
    softmax, so it is compared on equal inputs): to 1e-5 relative and 0.02
    of a degree, the f32 rounding of an arccos near 1."""
    _name, _got, ref, _ev, ref_ev, scene = form
    res = FrameResult(*[
        Pose(torch.tensor(f.R), torch.tensor(f.t))
        if isinstance(f, JPose) else torch.tensor(f)
        for f in ref])
    ev = evaluate_frame(res, scene[-1])
    for got, want in zip(ev, ref_ev):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0.02)


def test_summarize_matches_reference(rng):
    rot = rng.gamma(1.0, 2.0, 50)
    tra = rng.gamma(1.0, 30.0, 50)
    exp, ent = rng.random(50) * 20, rng.random(50) * 8
    assert summarize(rot, tra, exp, ent) == jax_summarize(rot, tra, exp, ent)
    assert summarize(rot, tra) == jax_summarize(rot, tra)


def test_fused_soft_placeholder_and_single_frame(scene):
    """Under fused_soft the maps are a (B, 0, G, G) placeholder, as in
    the reference; process_frame is the B = 1 case of the batch."""
    _jscene, maps, _flat, _keys, draws, _gt = scene
    cfg = DSACConfig(pose=PoseConfig(**POSE_KW), data=DataConfig(**DATA_KW),
                     net=NetConfig(subsample_size=G))
    cam = Camera.make(FOCAL, W, HGT)
    soft = process_frames_batched(torch.from_numpy(maps), coord_fn, cam, cfg,
                                  draws=draws, sampling=True)
    assert soft.dmaps.shape == (B, 0, G, G)
    one = process_frame(torch.from_numpy(maps[1]), coord_fn, cam, cfg,
                        draws=FrameDraws(jitter=draws.jitter[1:],
                                         idx=draws.idx[1:]),
                        sampling=True)
    assert one.dmaps.shape == (0, G, G) and one.scores.shape == (NH,)
    torch.testing.assert_close(one.final.t, soft.final.t[1])
    with pytest.raises(ValueError):
        process_frames_batched(torch.from_numpy(maps), coord_fn, cam, cfg,
                               sampling="fixed")


def test_cli_rehearsals_on_the_cpu():
    """serve --no-fused-scoring and test_ransac on 2 fixture frames."""
    from dsac_tpu_torch.cli import serve, test_ransac
    res = serve.main(["--synthetic", "2", "--batch", "1", "--queue", "2",
                      "--reps", "1", "--device", "cpu",
                      "--no-fused-scoring", "--no-two-phase", "--attempts",
                      "4"])
    assert res["scoring"] == "cnn" and res["sampling"] == "fixed_t_fused"
    assert res["accuracy_5cm5deg"] == 1.0 and res["poses_finite"]
    res = test_ransac.main(["--synthetic", "2", "--device", "cpu",
                            "--rdraw", "0"])
    assert res["frames"] == 2 and res["all_finite"]
    assert res["accuracy_5cm5deg"] == 1.0
    assert set(res) >= {"mean_expected_loss", "std_expected_loss",
                        "mean_entropy_bits", "median_trans_err_cm"}
    if not torch.cuda.is_available():  # the entry points default to cuda
        for entry in (serve.main, test_ransac.main):
            with pytest.raises(RuntimeError):
                entry(["--synthetic", "1"])


def reference_test_ransac(frames: int = 64, seed: int = 0) -> dict:
    """The reference's test_ransac forward pass (dsac_tpu process_frame
    with refine_all, the trained score CNN, unfused fixed-T sampling, the
    fused refiner in interpret mode, argmax) on the first `frames` fixture
    frames, keyed PRNGKey(seed * 131 + i) as dsac_tpu/cli/test_ransac.py
    keys them; the accuracy of --select score and --select inlier."""
    scene = JScene()
    cfg = JCfg(pose=JPoseCfg(num_hypotheses=256, random_draw=False))
    coord_net, score_net = JCoordNet(), FlaxScoreNet()
    cp = jax_load(ARTIFACTS / "coord_e2e.npz", coord_net.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 480, 640, 3))))
    sp = jax_load(ARTIFACTS / "score_e2e.npz", score_net.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 40, 40))))

    def coord_fn(img, pix):
        return jax_gather(coord_net.apply(cp, img[None])[0], pix, stride=8)

    @jax.jit
    def run(key, image, gt_R, gt_t):
        res = jax_process(key, image, coord_fn,
                          lambda dm: score_net.apply(sp, dm), scene.camera,
                          cfg, refine_all=True, fused_refine=True,
                          scoring="cnn", fused_sampling=False)
        gt = JPose(gt_R, gt_t)
        return (jax_is_correct(res.final, gt),
                jax_is_correct(jax_verified(res).final, gt))

    hits = []
    for i in range(frames):
        pose, rgb, _depth, _coords = scene.frame(
            jax.random.PRNGKey(9000 + i))
        hits.append([bool(x) for x in run(
            jax.random.PRNGKey(seed * 131 + i), rgb, pose.R, pose.t)])
        print(i, hits[-1], flush=True)
    hits = np.asarray(hits)
    return {"frames": frames,
            "accuracy_select_score": float(hits[:, 0].mean()),
            "accuracy_select_inlier": float(hits[:, 1].mean())}


if __name__ == "__main__":
    import json
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(reference_test_ransac(int(sys.argv[1]) if len(sys.argv)
                                           > 1 else 64)))
