"""The port's evaluation entry points and their helpers against the
reference: cli/test_ransac.py (and test_ransac_softam.py) with --softam,
--model, --refine-variant hard, --fused-scoring, --export-poses and --out;
cli/serve.py --softam; the model selection of cli/common.py; the pose
files of data/seven_scenes.py; utils/logging.py:TestLog.

The CLI rehearsals run on the CPU on 2 fixture frames.  Those that select
nets from --out load small snapshots (DenseCoordNet of width 8, ScoreNet
at width 0.125, random weights) written with utils/checkpoint.py into a
temporary directory; they check the JSON line's keys, the tag and the
TestLog files, not accuracy.  serve --softam serves the committed SoftAM
artifacts at full width (batch 1).

Tolerances: pose files and 6-vectors to 1e-6 of the reference's on 32
random poses (the written text is the reference's, character for
character); the TestLog files byte for byte; the soft-inlier head to
1e-4 relative.

Run as a script, it prints the reference's accuracy at 5 cm / 5 deg of a
configuration of chip_smoke.py's SoftAM and test_ransac-variant phases on
the first fixture frames (the bars beside REF_TEST_RANSAC_ACCURACY there):

    PYTHONPATH=. python tests/test_torch_eval_cli.py serve_softam 64
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.cli.common import soft_inlier_score_fn as jax_soft_head
from dsac_tpu.config import DSACConfig as JCfg
from dsac_tpu.data import seven_scenes as jax_seven
from dsac_tpu.utils.logging import TestLog as JaxTestLog
from dsac_tpu_torch.cli import common, serve, test_ransac, test_ransac_softam
from dsac_tpu_torch.config import DSACConfig
from dsac_tpu_torch.data.seven_scenes import (parse_pose_file,
                                              pose_to_7scenes_vec6,
                                              write_pose_file)
from dsac_tpu_torch.geometry.rotation import so3_exp
from dsac_tpu_torch.models import DenseCoordNet, ScoreNet, init_like_flax
from dsac_tpu_torch.utils import checkpoint as ckpt
from dsac_tpu_torch.utils.logging import TestLog
from torch_problems import one_torch_thread  # noqa: F401

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"

# variant -> (process_frame_softam or not, keyword options, weights)
REFERENCE_VARIANTS = {
    # cli/serve.py --softam: two-phase sampling, fused soft scoring, the
    # refine kernel on the average
    "serve_softam": (True, dict(refine_mode="fused",
                                fused_sampling="two_phase",
                                scoring="fused_soft"), "_softam"),
    # cli/serve.py --softam --no-fused-scoring: the score CNN
    "serve_softam_cnn": (True, dict(refine_mode="fused",
                                    fused_sampling="two_phase",
                                    scoring="cnn"), "_softam"),
    # cli/test_ransac.py --softam --fused-refine: the score CNN on
    # unfused fixed-T sampling
    "test_ransac_softam": (True, dict(refine_mode="fused"), "_softam"),
    # cli/test_ransac.py --fused-refine and --model none (the soft-inlier
    # head), --refine-variant hard, --fused-scoring
    "model_none": (False, dict(refine_all=True, fused_refine=True,
                               scoring="cnn"), None),
    "refine_hard": (False, dict(refine_all=True, fused_refine="hard",
                                scoring="cnn"), ""),
    "fused_scoring": (False, dict(refine_all=True, fused_refine=True,
                                  scoring="fused_soft"), ""),
}


def reference_accuracy(variant: str, frames: int) -> dict:
    """The reference's forward pass of ``variant`` (REFERENCE_VARIANTS)
    with the committed weights on the first ``frames`` fixture frames,
    H = 256, argmax, keyed PRNGKey(i) as the port's test_ransac keys frame
    i with its default --seed 0; the accuracy at 5 cm / 5 deg."""
    from dsac_tpu.config import DSACConfig, PoseConfig
    from dsac_tpu.data.synthetic import SyntheticScene
    from dsac_tpu.geometry.loss import is_correct
    from dsac_tpu.models.coord_net import DenseCoordNet, gather_dense_coords
    from dsac_tpu.models.score_net import ScoreNet
    from dsac_tpu.ops.diffmap import soft_inlier_scores
    from dsac_tpu.pipeline.forward import (process_frame,
                                           process_frame_softam)
    from dsac_tpu.utils.params_io import load_params_npz

    softam, kw, weights = REFERENCE_VARIANTS[variant]
    scene = SyntheticScene()
    cfg = DSACConfig(pose=PoseConfig(num_hypotheses=256, random_draw=False))
    coord_net, score_net = DenseCoordNet(), ScoreNet()
    suffix = weights or ""
    cp = load_params_npz(ARTIFACTS / f"coord_e2e{suffix}.npz", coord_net.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 480, 640, 3))))
    if weights is None:
        def score_fn(dm):
            return soft_inlier_scores(dm.reshape(dm.shape[0], -1),
                                      cfg.pose.inlier_threshold_2d,
                                      cfg.pose.score_beta)
    else:
        sp = load_params_npz(ARTIFACTS / f"score_e2e{suffix}.npz",
                             score_net.init(jax.random.PRNGKey(2),
                                            jnp.zeros((1, 40, 40))))

        def score_fn(dm):
            return score_net.apply(sp, dm)

    def coord_fn(img, pix):
        return gather_dense_coords(coord_net.apply(cp, img[None])[0], pix,
                                   stride=8)

    forward = process_frame_softam if softam else process_frame

    @jax.jit
    def run(key, image, gt_R, gt_t):
        res = forward(key, image, coord_fn, score_fn, scene.camera, cfg,
                      **kw)
        from dsac_tpu.geometry.pose import Pose
        return is_correct(res.final, Pose(gt_R, gt_t))

    hits = []
    for i in range(frames):
        pose, rgb, _depth, _coords = scene.frame(jax.random.PRNGKey(9000 + i))
        hits.append(bool(run(jax.random.PRNGKey(i), rgb, pose.R, pose.t)))
        print(i, hits[-1], flush=True)
    return {"variant": variant, "frames": frames,
            "accuracy_5cm5deg": float(np.mean(hits))}


# ---- pose files, TestLog and the soft-inlier head ----

def random_poses(n=32, seed=5):
    rng = np.random.default_rng(seed)
    R = so3_exp(torch.from_numpy(rng.normal(size=(n, 3)) * 1.2)).numpy()
    t = rng.normal(size=(n, 3)) * 1500.0
    return R.astype(np.float32), t.astype(np.float32)


@pytest.mark.parametrize("offset", [None, [0.5, -1.25, 2.0]],
                         ids=["no_offset", "offset"])
def test_pose_files_and_vec6_match_reference(tmp_path, offset):
    R, t = random_poses()
    off = None if offset is None else np.asarray(offset)
    for i in range(len(R)):
        ours, theirs = tmp_path / f"p{i}.txt", tmp_path / f"r{i}.txt"
        write_pose_file(ours, R[i], t[i], off)
        jax_seven.write_pose_file(theirs, R[i], t[i], off)
        assert ours.read_text() == theirs.read_text()
        pR, pt = parse_pose_file(ours, off)
        rR, rt = jax_seven.parse_pose_file(ours, off)
        np.testing.assert_allclose(pR, rR, atol=1e-6)
        np.testing.assert_allclose(pt, rt, atol=1e-6)
        # the round trip gives the pose back: metres and mm
        np.testing.assert_allclose(pR, R[i], atol=1e-6)
        np.testing.assert_allclose(pt * 1000.0, t[i], atol=1e-3)
        np.testing.assert_allclose(
            pose_to_7scenes_vec6(R[i], t[i], off),
            jax_seven.pose_to_7scenes_vec6(R[i], t[i], off), atol=1e-6)


def test_test_log_matches_reference(tmp_path):
    rng = np.random.default_rng(9)
    rows = [(*rng.random(5) * [20, 8, 30, 500, 90], rng.normal(size=6))
            for _ in range(3)]
    stats = {"accuracy_5cm5deg": 0.5, "mean_expected_loss": 3.25,
             "std_expected_loss": 1.5, "mean_entropy_bits": 2.0,
             "std_entropy_bits": 0.25, "median_rot_err_deg": 1.75,
             "median_trans_err_cm": 4.5}
    for cls, out in ((TestLog, tmp_path / "port"),
                     (JaxTestLog, tmp_path / "ref")):
        log = cls(out, "dsac_dense_x_rdraw0")
        for *cols, vec6 in rows:
            log.frame(*cols, vec6)
        log.frame(1.0, 2.0, 3.0, 4.0, 5.0)  # no pose
        log.summary(stats)
        log.close()
    for name in ("ransac_pose_errors_dsac_dense_x_rdraw0.txt",
                 "ransac_summary_dsac_dense_x_rdraw0.txt"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes())
    lines = (tmp_path / "port" / "ransac_pose_errors_dsac_dense_x_rdraw0"
             ".txt").read_text().splitlines()
    assert [len(x.split()) for x in lines] == [11, 11, 11, 5]


def test_soft_inlier_head_matches_reference():
    dm = np.random.default_rng(4).random((6, 40, 40)).astype(np.float32) * 40
    got = common.soft_inlier_score_fn(DSACConfig())(torch.from_numpy(dm))
    want = jax_soft_head(JCfg())(jnp.asarray(dm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


# ---- model selection and the entry points ----

SNAPSHOTS = {ckpt.OBJ_INIT: 1, ckpt.OBJ_E2E: 2, ckpt.OBJ_E2E + "_best": 3,
             ckpt.OBJ_SOFTAM: 4, ckpt.SCORE_INIT: 5, ckpt.SCORE_E2E: 6,
             ckpt.SCORE_E2E + "_best": 7, ckpt.SCORE_SOFTAM: 8}


def small_net(name: str, seed: int) -> torch.nn.Module:
    net = (DenseCoordNet(width=8) if name.startswith("obj")
           else ScoreNet(width_mult=0.125))
    return init_like_flax(net, torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    out = tmp_path_factory.mktemp("snapshots")
    for name, seed in SNAPSHOTS.items():
        ckpt.save(out, name, {"params": small_net(name, seed).state_dict(),
                              "step": 1}, step=1)
    return out


def args_for(out, model="endtoend", weights=None, score_weights=None):
    import argparse
    return argparse.Namespace(model=model, out=out and str(out),
                              weights=weights, score_weights=score_weights,
                              arch="dense", width_mult=1.0)


def same_weights(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))


@pytest.mark.parametrize("model, softam, coord, score", [
    ("endtoend", False, ckpt.OBJ_E2E, ckpt.SCORE_E2E),
    ("endtoend", True, ckpt.OBJ_SOFTAM, ckpt.SCORE_SOFTAM),
    ("best", False, ckpt.OBJ_E2E + "_best", ckpt.SCORE_E2E + "_best"),
    # no *_softam_endtoend_best: best falls back to the end-to-end ones
    ("best", True, ckpt.OBJ_SOFTAM, ckpt.SCORE_SOFTAM),
    ("init", False, ckpt.OBJ_INIT, ckpt.SCORE_INIT),
    ("none", False, "random", "soft_inlier_head"),
])
def test_model_selection_from_snapshots(snapshots, model, softam, coord,
                                        score):
    m = common.load_eval_models(args_for(snapshots, model), DSACConfig(),
                                torch.device("cpu"), softam)
    assert (m.coord_src, m.score_src) == (coord, score)
    if coord != "random":
        assert same_weights(m.coord_net, small_net(coord, SNAPSHOTS[coord]))
    if score == "soft_inlier_head":
        assert m.score_net is None and m.score_fn is not None
    else:
        assert same_weights(m.score_net, small_net(score, SNAPSHOTS[score]))


def test_model_selection_fallbacks_and_errors(tmp_path, snapshots):
    cpu = torch.device("cpu")
    # an empty --out: the reference's fallbacks, a fresh coordinate net
    # and the soft-inlier head
    m = common.load_eval_models(args_for(tmp_path), DSACConfig(), cpu, False)
    assert (m.coord_src, m.score_src) == ("random", "soft_inlier_head")
    # explicit artifacts win over --model
    m = common.load_eval_models(
        args_for(snapshots, "none", weights=str(ARTIFACTS / "coord_e2e.npz"),
                 score_weights=str(ARTIFACTS / "score_e2e.npz")),
        DSACConfig(), cpu, False)
    assert (m.coord_src, m.score_src) == ("coord_e2e", "score_e2e")
    # fused scoring loads no score net
    m = common.load_eval_models(args_for(snapshots), DSACConfig(), cpu,
                                False, score_cnn=False)
    assert m.score_fn is None and m.score_src == "none"
    # without --out: the committed artifacts, and a missing one is an error
    with pytest.raises(SystemExit):
        common.load_eval_models(args_for(None, "init"), DSACConfig(), cpu,
                                False)
    with pytest.raises(FileNotFoundError):
        common.load_eval_models(args_for(None, weights=str(
            tmp_path / "missing.npz")), DSACConfig(), cpu, False)


EVAL = ["--synthetic", "2", "--device", "cpu", "--rdraw", "0",
        "--fused-refine"]
KEYS = {"accuracy_5cm5deg", "median_rot_err_deg", "median_trans_err_cm",
        "mean_expected_loss", "std_expected_loss", "mean_entropy_bits",
        "std_entropy_bits", "all_finite", "variant", "tag", "model",
        "coord_src", "score_src", "scoring", "refine_variant", "launches",
        "seconds", "frames"}


@pytest.mark.parametrize("flags, tag", [
    (["--softam"], "softam_dense_obj_model_softam_endtoend_rdraw0"),
    # the reference ignores the DSAC-only flags under --softam
    (["--softam", "--fused-scoring", "--refine-variant", "hard", "--select",
      "inlier"], "softam_dense_obj_model_softam_endtoend_rdraw0"),
    (["--model", "none"], "dsac_dense_random_rdraw0"),
    (["--model", "best", "--refine-variant", "hard"],
     "dsac_dense_obj_model_endtoend_best_rdraw0_hardref"),
    (["--fused-scoring", "--select", "inlier"],
     "dsac_dense_obj_model_endtoend_rdraw0_selinlier_fusedscore_h256"),
], ids=["softam", "softam_ignores", "model_none", "hard", "fused_scoring"])
def test_test_ransac_rehearsals(tmp_path, snapshots, flags, tag):
    out = tmp_path / "out"
    for name in SNAPSHOTS:  # --out holds the snapshots and gets the logs
        (out / name).mkdir(parents=True)
        (out / name / "1.pt").write_bytes(
            (snapshots / name / "1.pt").read_bytes())
    entry = test_ransac.main
    if flags[0] == "--softam":
        entry, flags = test_ransac_softam.main, flags[1:]
    pose_dir = tmp_path / "poses"
    res = entry(EVAL + flags + ["--out", str(out), "--export-poses",
                                str(pose_dir)])
    assert KEYS <= set(res) and res["tag"] == tag and res["all_finite"]
    assert res["variant"] == tag.split("_")[0]
    errors = (out / f"ransac_pose_errors_{tag}.txt").read_text().splitlines()
    assert [len(x.split()) for x in errors] == [11, 11]
    summary = (out / f"ransac_summary_{tag}.txt").read_text().split()
    assert len(summary) == 7 and float(summary[0]) == \
        res["accuracy_5cm5deg"]
    files = sorted(pose_dir.iterdir())
    assert [f.name for f in files] == ["frame-000000.pose.txt",
                                       "frame-000001.pose.txt"]
    for i, f in enumerate(files):
        R, t = parse_pose_file(f)
        np.testing.assert_allclose(R, res["final"].R[i].numpy(), atol=1e-6)
        np.testing.assert_allclose(t * 1000.0, res["final"].t[i].numpy(),
                                   atol=1e-3)
        # columns 5-10 of the error file are the exported pose's 6-vector
        np.testing.assert_allclose(
            [float(x) for x in errors[i].split()[5:]],
            pose_to_7scenes_vec6(R, t * 1000.0), atol=2e-6)


def test_serve_softam_rehearsal(tmp_path):
    """serve --softam with the committed SoftAM artifacts, 2 frames."""
    res = serve.main(["--synthetic", "2", "--batch", "1", "--queue", "2",
                      "--reps", "1", "--device", "cpu", "--softam",
                      "--verify-topk", "4", "--two-phase-sampling",
                      "--two-phase-budget", "0.25", "--export-poses",
                      str(tmp_path)])
    assert res["variant"] == "softam" and res["verify_topk"] == 0
    assert res["scoring"] == "fused_soft" and res["sampling"] == "two_phase"
    assert res["accuracy_5cm5deg"] == 1.0 and res["poses_finite"]
    assert len(list(tmp_path.glob("frame-*.pose.txt"))) == 2


if __name__ == "__main__":
    import json
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(reference_accuracy(
        sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 64)))
