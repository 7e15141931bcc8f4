"""The port's entry points on the archetypes and on 7-Scenes-layout data
against the reference: serve and test_ransac with ``--scene clutter`` and
with ``--data`` (an export of the room), on 2 frames at full size with
the committed weights.

The port draws its hypotheses from torch generators and the reference
from jax.random keys, so the served poses are held to the reference's on
the same frames at the accuracy bar, 5 cm and 5 deg apart, and each frame
is right (within 5 cm / 5 deg of the ground truth) in the port exactly
where it is in the reference.  The reference's poses are those that its
own test_ransac exports (``--export-poses``).

Run as a script, it prints the reference's accuracy at 5 cm / 5 deg for a
phase of chip_smoke.py (its REF_SCENE_ACCURACY), on the CPU, minutes
each:

    PYTHONPATH=. python tests/test_torch_scene_cli.py test_ransac_clutter

VARIANT is one of REFERENCE_VARIANTS.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu_torch.cli import serve, test_ransac
from dsac_tpu_torch.data.seven_scenes import parse_pose_file
from dsac_tpu_torch.geometry.loss import is_correct, pose_errors
from dsac_tpu_torch.geometry.pose import Pose
from torch_problems import one_torch_thread  # noqa: F401

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
FRAMES = 2
CLUTTER = ["--weights", str(ARTIFACTS / "coord_e2e_clutter.npz"),
           "--score-weights", str(ARTIFACTS / "score_e2e_clutter.npz")]
# seed 99's keys of the frames the archetype weights were judged on
CLUTTER_FRAMES = ["--scene", "clutter", "--seed", "99"]
NOISE_DRAWS = 4  # test_ransac_noisy: the frame's own draw and 3 others
# the keys of the other noise draws of frame i: OTHER_NOISE_KEY * d + i
OTHER_NOISE_KEY = 1000003


def reference_test_ransac(argv: list[str], out: Path) -> dict:
    """The reference's own test_ransac (dsac_tpu/cli/test_ransac.py),
    with no frame cache, its log in ``out``.  The weights of -omodel and
    -smodel are linked into ``out`` and named there, as the reference's
    tag takes the name."""
    from dsac_tpu.cli import test_ransac as jax_test_ransac
    os.environ["DSAC_TPU_FRAME_CACHE"] = ""
    out.mkdir(parents=True, exist_ok=True)
    argv = list(argv)
    for i, tok in enumerate(argv[:-1]):
        if tok in ("-omodel", "-smodel"):
            src = Path(argv[i + 1])
            if not (out / src.name).exists():
                (out / src.name).symlink_to(src)
            argv[i + 1] = src.name
    return jax_test_ransac.main(argv + ["--out", str(out)])


def reference_export(out: Path, train: int, test: int) -> None:
    from dsac_tpu.cli import export_synthetic as jax_export
    jax_export.main(["--out", str(out), "--train-frames", str(train),
                     "--test-frames", str(test)])


def npz(name: str) -> str:
    return str(ARTIFACTS / name)


def reference_forward(variant_kw: dict, coord: str, score: str | None):
    """A jitted forward pass of the reference with the committed weights:
    (key, image) -> FrameResult."""
    from dsac_tpu.cli.common import soft_inlier_score_fn
    from dsac_tpu.config import Camera, DSACConfig, PoseConfig
    from dsac_tpu.models.coord_net import DenseCoordNet, gather_dense_coords
    from dsac_tpu.models.score_net import ScoreNet
    from dsac_tpu.pipeline.forward import process_frame
    from dsac_tpu.utils.params_io import load_params_npz

    cfg = DSACConfig(pose=PoseConfig(num_hypotheses=256, random_draw=False))
    coord_net, score_net = DenseCoordNet(), ScoreNet()
    cp = load_params_npz(coord, coord_net.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 480, 640, 3))))
    if score is None:
        score_fn = soft_inlier_score_fn(cfg)
    else:
        sp = load_params_npz(score, score_net.init(
            jax.random.PRNGKey(2), jnp.zeros((1, 40, 40))))

        def score_fn(dm):
            return score_net.apply(sp, dm)

    def coord_fn(img, pix):
        return gather_dense_coords(coord_net.apply(cp, img[None])[0], pix,
                                   stride=8)

    return jax.jit(lambda key, image: process_frame(
        key, image, coord_fn, score_fn, Camera.make(), cfg, **variant_kw))


# the serve path of cli/serve.py (bench.py's defaults)
SERVE_KW = dict(refine_all=False, fused_refine="fused",
                fused_sampling="two_phase", verify_topk=4)
# cli/test_ransac.py --fused-refine: the pool refined
TEST_RANSAC_KW = dict(refine_all=True, fused_refine=True)


def noisy_accuracy(frames: int = 24) -> dict:
    """The reference's test_ransac forward pass (--fused-refine -rdraw 0,
    the noisy weights) on the poses of seed 99's noisy frames under
    NOISE_DRAWS noise draws each: the frame's own (SyntheticScene.frame)
    and renders of its pose at keys OTHER_NOISE_KEY * d + i.  Frame i
    draws its hypotheses with PRNGKey(99 * 131 + i), as test_ransac
    keys it."""
    from dsac_tpu.data.synthetic import make_scene
    from dsac_tpu.geometry.loss import is_correct as jax_correct
    run = reference_forward(dict(TEST_RANSAC_KW, scoring="cnn"),
                            npz("coord_e2e_noisy.npz"),
                            npz("score_e2e_noisy.npz"))
    scene = make_scene("noisy")
    hits = np.zeros((NOISE_DRAWS, frames), bool)
    for i in range(frames):
        pose, rgb, _, _ = scene.frame(jax.random.PRNGKey(
            99 * 100003 + i))
        for d in range(NOISE_DRAWS):
            if d:
                rgb = scene.render(pose, jax.random.PRNGKey(
                    OTHER_NOISE_KEY * d + i))[0]
            res = run(jax.random.PRNGKey(99 * 131 + i), rgb)
            hits[d, i] = bool(jax_correct(res.final, pose))
        print(i, hits[:, i].tolist(), flush=True)
    acc = hits.mean(axis=1)
    return {"accuracy_by_draw": acc.tolist(),
            "accuracy_5cm5deg": float(acc.min())}


def repeat_accuracy(frames: int = 24) -> dict:
    """The reference's test_ransac forward pass (--fused-refine -rdraw 0
    --fused-scoring, coord_e2e_repeat_t10b.npz and the soft-inlier head)
    on seed 99's repeat frames in two renders: its jitted frame (what its
    test_ransac reads) and its eager render of the same pose.  The walls
    lie at multiples of the texture's period, so f32 rounding picks each
    wall pixel's side of the wrap, and the two renders differ on about
    half the pixels (tests/test_torch_scenes.py), as the port's render on
    the card differs from both.  Frame i draws its hypotheses with
    PRNGKey(99 * 131 + i)."""
    from dsac_tpu.data.synthetic import make_scene
    from dsac_tpu.geometry.loss import is_correct as jax_correct
    run = reference_forward(dict(TEST_RANSAC_KW, scoring="fused_soft"),
                            npz("coord_e2e_repeat_t10b.npz"), None)
    scene = make_scene("repeat")
    hits = np.zeros((2, frames), bool)
    for i in range(frames):
        pose, rgb, _, _ = scene.frame(jax.random.PRNGKey(99 * 100003 + i))
        for r, image in enumerate((rgb, scene.render(pose)[0])):
            res = run(jax.random.PRNGKey(99 * 131 + i), image)
            hits[r, i] = bool(jax_correct(res.final, pose))
        print(i, hits[:, i].tolist(), flush=True)
    acc = hits.mean(axis=1)
    return {"accuracy_by_render": acc.tolist(),
            "accuracy_5cm5deg": float(acc.min())}


def serve_accuracy(scoring: str, frames: int = 24) -> dict:
    """The reference's serve path (two-phase sampling, the top 4 refined)
    with the clutter weights on seed 99's clutter frames."""
    from dsac_tpu.data.synthetic import make_scene
    from dsac_tpu.geometry.loss import is_correct as jax_correct
    run = reference_forward(dict(SERVE_KW, scoring=scoring),
                            npz("coord_e2e_clutter.npz"),
                            npz("score_e2e_clutter.npz"))
    scene = make_scene("clutter")
    hits = []
    for i in range(frames):
        pose, rgb, _, _ = scene.frame(jax.random.PRNGKey(99 * 100003 + i))
        hits.append(bool(jax_correct(run(jax.random.PRNGKey(i), rgb).final,
                                     pose)))
        print(i, hits[-1], flush=True)
    return {"accuracy_5cm5deg": float(np.mean(hits))}


def reference_accuracy(variant: str) -> dict:
    """The reference's accuracy of a phase of chip_smoke.py."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        eval_args = ["--synthetic", "24", "--seed", "99", "--fused-refine",
                     "-rdraw", "0"]
        if variant == "test_ransac_clutter":
            args = eval_args + ["--scene", "clutter", "-omodel",
                                npz("coord_e2e_clutter.npz"), "-smodel",
                                npz("score_e2e_clutter.npz")]
            score = reference_test_ransac(args, tmp)
            inlier = reference_test_ransac(args + ["--select", "inlier"],
                                           tmp)
            return {"accuracy_5cm5deg": score["accuracy_5cm5deg"],
                    "accuracy_select_inlier": inlier["accuracy_5cm5deg"]}
        if variant == "test_ransac_noisy":
            return noisy_accuracy()
        if variant == "test_ransac_repeat":
            cli = reference_test_ransac(
                eval_args + ["--scene", "repeat", "--fused-scoring",
                             "-omodel", npz("coord_e2e_repeat_t10b.npz")],
                tmp)["accuracy_5cm5deg"]
            return {"test_ransac_accuracy": cli, **repeat_accuracy()}
        if variant == "serve_scene":
            return {"accuracy_5cm5deg": serve_accuracy("fused_soft")[
                "accuracy_5cm5deg"],
                "accuracy_score_cnn": serve_accuracy("cnn")[
                    "accuracy_5cm5deg"]}
        if variant == "data_7scenes":
            reference_export(tmp / "scene", 8, 16)
            return {"accuracy_5cm5deg": reference_test_ransac(
                ["--data", str(tmp / "scene" / "test" / "synth"), "-c",
                 str(tmp / "scene" / "default.config"), "--fused-refine",
                 "-rdraw", "0", "-omodel", npz("coord_e2e.npz"), "-smodel",
                 npz("score_e2e.npz")], tmp)["accuracy_5cm5deg"]}
    raise ValueError(f"unknown variant {variant!r}; choose from "
                     f"{REFERENCE_VARIANTS}")


REFERENCE_VARIANTS = ("test_ransac_clutter", "test_ransac_noisy",
                      "test_ransac_repeat", "serve_scene", "data_7scenes")


# ---- the entry points against the reference ----

def read_poses(pose_dir: Path, n: int, translation=None) -> Pose:
    R, t = zip(*(parse_pose_file(pose_dir / f"frame-{i:06d}.pose.txt",
                                 translation) for i in range(n)))
    return Pose(torch.tensor(np.stack(R), dtype=torch.float32),
                torch.tensor(np.stack(t) * 1000.0, dtype=torch.float32))


def hold(ours: Pose, theirs: Pose, gt: Pose) -> None:
    """The port's served poses against the reference's: right on the
    same frames, and within 5 cm / 5 deg of each other."""
    assert is_correct(ours, gt).tolist() == is_correct(theirs, gt).tolist()
    rot, trans = pose_errors(ours, theirs)
    assert (rot < 5.0).all() and (trans < 50.0).all(), (rot, trans)


@pytest.fixture(scope="module")
def clutter_reference(tmp_path_factory):
    """The reference's test_ransac on the first 2 clutter frames of seed
    99 with the clutter weights: its exported poses and the frames'
    ground truth."""
    tmp = tmp_path_factory.mktemp("clutter_ref")
    reference_test_ransac(
        ["--scene", "clutter", "--synthetic", str(FRAMES), "--seed", "99",
         "--fused-refine", "-rdraw", "0", "--fused-scoring", "-omodel",
         npz("coord_e2e_clutter.npz"), "--export-poses", str(tmp / "poses")],
        tmp)
    from dsac_tpu.data.synthetic import make_scene
    scene = make_scene("clutter")
    gt = [scene.frame(jax.random.PRNGKey(99 * 100003 + i))[0]
          for i in range(FRAMES)]
    return (read_poses(tmp / "poses", FRAMES),
            Pose(torch.tensor(np.stack([np.asarray(p.R) for p in gt])),
                 torch.tensor(np.stack([np.asarray(p.t) for p in gt]))))


def test_serve_and_test_ransac_on_clutter(tmp_path, clutter_reference):
    theirs, gt = clutter_reference
    res = serve.main(["--synthetic", str(FRAMES), "--batch", "1",
                      "--queue", str(FRAMES), "--reps", "1", "--device",
                      "cpu", "--export-poses", str(tmp_path / "serve")]
                     + CLUTTER_FRAMES + CLUTTER[:2])
    assert (res["scene"], res["frame_set"]) == ("clutter", "reference")
    assert res["poses_finite"] and res["scores_finite"]
    hold(read_poses(tmp_path / "serve", FRAMES), theirs, gt)
    res = test_ransac.main(["--synthetic", str(FRAMES), "--device", "cpu",
                            "--fused-refine", "-rdraw", "0",
                            "--fused-scoring"] + CLUTTER_FRAMES
                           + CLUTTER[:2])
    assert (res["scene"], res["frame_set"], res["rdraw"]) == (
        "clutter", "reference", 0)
    assert res["tag"] == ("dsac_dense_coord_e2e_clutter_rdraw0_"
                          "fusedscore_h256")
    hold(res["final"], theirs, gt)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The port's export of 1 training and 2 test frames, and the
    reference's test_ransac on its test split with the room weights (its
    poses exported with the scene's offset re-added)."""
    from dsac_tpu_torch.cli import export_synthetic
    out = tmp_path_factory.mktemp("export") / "scene"
    export_synthetic.main(["--out", str(out), "--train-frames", "1",
                           "--test-frames", str(FRAMES), "--device", "cpu"])
    ref = out.parent / "ref"
    reference_test_ransac(
        ["--data", str(out / "test" / "synth"), "-c",
         str(out / "default.config"), "--fused-refine", "-rdraw", "0",
         "--fused-scoring", "-omodel", npz("coord_e2e.npz"),
         "--export-poses", str(ref / "poses")], ref)
    return out, ref / "poses"


def test_serve_and_test_ransac_on_data(tmp_path, exported):
    from dsac_tpu_torch.data.seven_scenes import read_translation
    out, ref_poses = exported
    data = ["--data", str(out / "test" / "synth"), "-c",
            str(out / "default.config")]
    offset = read_translation(out / "translation.txt")
    theirs = read_poses(ref_poses, FRAMES, offset)
    gt = read_poses_gt(out / "test" / "synth", offset)
    res = test_ransac.main(data + ["--device", "cpu", "--fused-refine",
                                   "-rdraw", "0", "--fused-scoring",
                                   "--export-poses", str(tmp_path / "t")])
    assert (res["scene"], res["frame_set"], res["frames"]) == (
        "data", "dataset", FRAMES)
    hold(res["final"], theirs, gt)
    hold(read_poses(tmp_path / "t", FRAMES, offset), theirs, gt)
    res = serve.main(data + ["--batch", "1", "--queue", str(FRAMES),
                             "--reps", "1", "--device", "cpu"])
    assert (res["scene"], res["frame_set"]) == ("data", "dataset")
    assert res["accuracy_5cm5deg"] == float(is_correct(theirs, gt).float()
                                            .mean())


def read_poses_gt(split: Path, offset) -> Pose:
    R, t = zip(*(parse_pose_file(p, offset)
                 for p in sorted((split / "poses").glob("*.txt"))))
    return Pose(torch.tensor(np.stack(R), dtype=torch.float32),
                torch.tensor(np.stack(t) * 1000.0, dtype=torch.float32))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({"variant": sys.argv[1],
                      **reference_accuracy(sys.argv[1])}))
