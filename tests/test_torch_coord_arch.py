"""The port's coordinate-net archs (``--arch dense_s2d|dense_ctx|patch``)
against the Flax reference: models/coord_net.py (DenseCoordNet with the
s2d stem or the context stack, PatchCoordNet, extract_patches), the
carry-over of utils/params_io.py, one frame per arch through
process_frames_batched, and the entry points' ``--arch`` on the CPU.

Tolerances.  The nets: those of tests/test_torch_coord_net.py (atol
0.03 m, mean under 5 mm): both sides run bf16 layers with an f32 last
layer and round in different places.  extract_patches: exact.  The
carry-over: exact (OIHW of HWIO, (out, in) of (in, out)).  One frame per
arch runs both nets in f32 (the reference's ``dtype``, the port's
``dtype``): coordinates to 0.1 mm (accumulation order only; 3.2e-3 mm
measured), the served pose at the refine bars of
tests/test_gn_pallas.py:79-83 (2 mm, 1e-4).  In bf16 the nets' own
rounding (0.3 mm on average) moved the served pose of the s2d frame by
2e-4 in R, past the refine bar, on both sides equally right.

Run as a script, it prints the reference's accuracy at 5 cm / 5 deg of a
configuration of chip_smoke.py's arch phases on the first fixture frames
(the REF_* bars there; 1-2 s a frame for the patch net on the CPU):

    PYTHONPATH=. python tests/test_torch_coord_arch.py serve_patch 64
"""

import argparse
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from dsac_tpu.config import DataConfig as JData
from dsac_tpu.config import DSACConfig as JCfg
from dsac_tpu.config import NetConfig as JNet
from dsac_tpu.config import PoseConfig as JPoseCfg
from dsac_tpu.data.synthetic import SyntheticScene as JScene
from dsac_tpu.models.coord_net import DenseCoordNet as FlaxDense
from dsac_tpu.models.coord_net import PatchCoordNet as FlaxPatch
from dsac_tpu.models.coord_net import extract_patches as jax_patches
from dsac_tpu.pipeline.forward import process_frames_batched as jax_serve
from dsac_tpu.utils.params_io import load_params_npz as jax_load_npz
from dsac_tpu_torch.cli import common, serve, test_ransac, train_ransac
from dsac_tpu_torch.cli.profile_serve import coord_net_flops
from dsac_tpu_torch.config import Camera, DataConfig, DSACConfig, NetConfig
from dsac_tpu_torch.config import PoseConfig
from dsac_tpu_torch.models import coord_net_for_state
from dsac_tpu_torch.models.coord_net import (DenseCoordNet, PatchCoordNet,
                                             extract_patches)
from dsac_tpu_torch.pipeline import FrameDraws, process_frames_batched
from dsac_tpu_torch.utils import checkpoint as ckpt
from dsac_tpu_torch.utils.params_io import (coord_net_from_flax,
                                            load_coord_net_npz,
                                            load_params_npz, save_params_npz,
                                            to_flax_flat)
from test_torch_pipeline import reference_draws
from torch_problems import one_torch_thread  # noqa: F401

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"

# variant -> (arch, process_frame options, score-net suffix or None for
# the soft-inlier head); chip_smoke.py's phases of the same names
REFERENCE_VARIANTS = {
    # cli/serve.py --arch ARCH: two-phase sampling, fused soft scoring,
    # the refine kernel on the top 4
    "serve_s2d": ("dense_s2d", dict(refine_all=False, fused_refine="fused",
                                    fused_sampling="two_phase",
                                    scoring="fused_soft", verify_topk=4),
                  None),
    "serve_patch": ("patch", dict(refine_all=False, fused_refine="fused",
                                  fused_sampling="two_phase",
                                  scoring="fused_soft", verify_topk=4), None),
    # --no-fused-scoring: the diff-maps and the score CNN
    "serve_patch_cnn": ("patch", dict(refine_all=False,
                                      fused_refine="fused",
                                      fused_sampling="two_phase",
                                      scoring="cnn", verify_topk=4),
                        "_patch"),
    # cli/test_ransac.py --arch patch --fused-refine --rdraw 0: unfused
    # fixed-T sampling, the score CNN, the refine kernel on the pool
    "test_ransac_patch": ("patch", dict(refine_all=True, fused_refine=True,
                                        scoring="cnn"), "_patch"),
}


def flax_tree(flat):
    """The f32 parameter tree of a Flax-layout flat dict."""
    params = {}
    for key, arr in flat.items():
        *path, leaf = key.split("|")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr, jnp.float32)
    return params


def reference_coord_fn(arch: str, params, patch_size: int = 42,
                       dtype=jnp.bfloat16):
    """The reference's coord_apply of ``arch`` (dsac_tpu/cli/common.py:
    254-273) bound to ``params``: (image (H, W, 3), pix (N, 2)) -> (N, 3)."""
    from dsac_tpu.models.coord_net import (DenseCoordNet, PatchCoordNet,
                                           extract_patches,
                                           gather_dense_coords)
    if arch == "patch":
        net = PatchCoordNet(dtype=dtype)
        return lambda img, pix: net.apply(
            params, extract_patches(img, pix, patch_size))
    net = DenseCoordNet(width=params["params"]["Conv_0"]["kernel"].shape[-1],
                        s2d=arch == "dense_s2d", context=arch == "dense_ctx",
                        dtype=dtype)
    return lambda img, pix: gather_dense_coords(
        net.apply(params, img[None])[0], pix, stride=8)


def reference_accuracy(variant: str, frames: int) -> dict:
    """The reference's forward pass of ``variant`` (REFERENCE_VARIANTS)
    with the committed weights on the first ``frames`` fixture frames,
    H = 256, T = 16, argmax, frame i keyed PRNGKey(i); the accuracy at
    5 cm / 5 deg."""
    from dsac_tpu.config import DSACConfig, PoseConfig
    from dsac_tpu.data.synthetic import SyntheticScene
    from dsac_tpu.geometry.loss import is_correct
    from dsac_tpu.geometry.pose import Pose
    from dsac_tpu.models.score_net import ScoreNet
    from dsac_tpu.ops.diffmap import soft_inlier_scores
    from dsac_tpu.pipeline.forward import process_frame
    from dsac_tpu.utils.params_io import load_params_npz

    arch, kw, score_suffix = REFERENCE_VARIANTS[variant]
    scene = SyntheticScene()
    cfg = DSACConfig(pose=PoseConfig(num_hypotheses=256, random_draw=False))
    coord_fn = reference_coord_fn(arch, flax_tree(dict(np.load(
        ARTIFACTS / f"coord_e2e{common.ART_SUFFIX[arch]}.npz"))))
    if score_suffix is None:
        def score_fn(dm):
            return soft_inlier_scores(dm.reshape(dm.shape[0], -1),
                                      cfg.pose.inlier_threshold_2d,
                                      cfg.pose.score_beta)
    else:
        score_net = ScoreNet()
        sp = load_params_npz(ARTIFACTS / f"score_e2e{score_suffix}.npz",
                             score_net.init(jax.random.PRNGKey(2),
                                            jnp.zeros((1, 40, 40))))

        def score_fn(dm):
            return score_net.apply(sp, dm)

    @jax.jit
    def run(key, image, gt_R, gt_t):
        res = process_frame(key, image, coord_fn, score_fn, scene.camera,
                            cfg, **kw)
        return is_correct(res.final, Pose(gt_R, gt_t))

    hits = []
    for i in range(frames):
        pose, rgb, _depth, _coords = scene.frame(jax.random.PRNGKey(9000 + i))
        hits.append(bool(run(jax.random.PRNGKey(i), rgb, pose.R, pose.t)))
        print(i, hits[-1], flush=True)
    return {"variant": variant, "frames": frames,
            "accuracy_5cm5deg": float(np.mean(hits))}


# ---- the nets against the Flax reference ----

def flat_of(params) -> dict[str, np.ndarray]:
    """The Flax-layout flat dict (``params|Conv_0|kernel``) of a tree."""
    return {"|".join(k): np.array(v, np.float32)
            for k, v in flatten_dict(params).items()}


def textured(h, w, seed):
    """Smooth structure plus texture, like the synthetic room's frames."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 127 + 80 * np.sin(x[..., None] * [0.11, 0.07, 0.05]
                             + y[..., None] * [0.03, 0.09, 0.06])
    return (base + rng.normal(size=base.shape) * 10).clip(0, 255).astype(
        np.float32)[None]


def assert_coords_close(got, ref):
    np.testing.assert_allclose(got, ref, atol=0.03)
    assert np.abs(got - ref).mean() < 0.005


def test_s2d_trained_weights_match_flax_apply():
    """The s2d stem's 12 channels are (dy, dx, c), as the reference's
    reshape and transpose order them: a (c, dy, dx) order would miss."""
    flat = load_params_npz(ARTIFACTS / "coord_e2e_s2d.npz")
    net = coord_net_from_flax(flat, "dense_s2d")
    assert net.convs[0].weight.shape == (64, 12, 3, 3) and len(net.convs) == 9
    image = textured(96, 128, 1305)
    with torch.no_grad():
        got = net(torch.from_numpy(image)).numpy()
    ref = np.asarray(jax.jit(FlaxDense(width=64, s2d=True).apply)(
        flax_tree(flat), jnp.asarray(image)))
    assert got.shape == ref.shape == (1, 12, 16, 3)
    assert_coords_close(got, ref)


def test_patch_trained_weights_match_flax_apply():
    """32 patches of a frame, border centres included, through the full
    patch net (convs 64 .. 512, dense 4096) with the trained weights."""
    flat = load_params_npz(ARTIFACTS / "coord_e2e_patch.npz")
    net = coord_net_from_flax(flat, "patch")
    assert net.dense[0].weight.shape == (4096, 2048)
    image = textured(120, 160, 7)
    pix = np.random.default_rng(3).integers(0, [160, 120], size=(1, 32, 2))
    pix[0, :4] = [[0, 0], [159, 119], [20, 100], [150, 3]]
    patches = extract_patches(torch.from_numpy(image), torch.from_numpy(pix),
                              42)
    with torch.no_grad():
        got = net(patches).numpy()
    ref = np.asarray(jax.jit(FlaxPatch().apply)(
        flax_tree(flat), jnp.asarray(patches.numpy())))
    assert got.shape == ref.shape == (32, 3)
    assert_coords_close(got, ref)


@pytest.fixture(scope="module")
def ctx_flax():
    """Flax's init of the context net at width 16 on a 256x256 input, its
    last conv scaled by 0.1 so that the coordinates are of the trained
    nets' metre scale, where the nets' tolerance is stated (at Flax's
    init scale, |x| up to ~22, bf16 rounding alone reaches 0.15)."""
    fn = FlaxDense(width=16, context=True)
    params = jax.jit(fn.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 256, 256, 3)))
    flat = flat_of(params)
    for leaf in ("kernel", "bias"):
        flat[f"params|Conv_13|{leaf}"] *= 0.1
    return fn, flat


def test_context_net_matches_flax_apply(ctx_flax):
    """The stride-8 map is 32x32, so the dilation-16 conv reads real
    pixels; the dilated stack moves the output by far more than the
    tolerance, so a wrong dilation or padding would miss."""
    fn, flat = ctx_flax
    net = coord_net_from_flax(flat, "dense_ctx")
    assert [c.weight.shape[-1] for c in net.convs] == [3] * 11 + [1] * 3
    image = textured(256, 256, 3)
    with torch.no_grad():
        got = net(torch.from_numpy(image)).numpy()
        for conv in net.convs[7:11]:
            conv.weight.zero_()
        without = net(torch.from_numpy(image)).numpy()
    ref = np.asarray(jax.jit(fn.apply)(flax_tree(flat), jnp.asarray(image)))
    assert got.shape == ref.shape == (1, 32, 32, 3)
    assert_coords_close(got, ref)
    assert np.abs(without - ref).mean() > 0.1


def test_extract_patches_match_reference():
    """Exact, corners clipped into the image at every border."""
    rng = np.random.default_rng(5)
    images = rng.random((2, 60, 80, 3)).astype(np.float32) * 255
    pix = rng.integers(0, [80, 60], size=(2, 40, 2))
    pix[0, :6] = [[0, 0], [79, 59], [0, 59], [79, 0], [21, 21], [58, 38]]
    got = extract_patches(torch.from_numpy(images), torch.from_numpy(pix),
                          42).numpy()
    assert got.shape == (80, 42, 42, 3)
    for b in range(2):
        ref = np.asarray(jax_patches(jnp.asarray(images[b]),
                                     jnp.asarray(pix[b]), 42))
        np.testing.assert_array_equal(got[40 * b:40 * (b + 1)], ref)


# ---- carrying weights across ----

@functools.cache
def _flax_init(arch: str):
    """Flax's init of ``arch`` at the smallest width (0.125)."""
    if arch == "patch":
        params = jax.jit(FlaxPatch(width_mult=0.125, dense_mult=0.125).init)(
            jax.random.PRNGKey(1), jnp.zeros((1, 42, 42, 3)))
    else:
        params = jax.jit(FlaxDense(width=8, s2d=arch == "dense_s2d",
                                   context=arch == "dense_ctx").init)(
            jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
    return params


def flax_init_flat(arch: str) -> tuple[dict, object]:
    """Flax's init of ``arch`` at the smallest width (0.125), as a flat
    dict, and the reference's template tree."""
    params = _flax_init(arch)
    return flat_of(params), params


@pytest.mark.parametrize("arch", ["dense", "dense_s2d", "dense_ctx",
                                  "patch"])
def test_weights_carry_across_per_arch(tmp_path, arch):
    """A Flax init becomes a net of its arch, found from its keys; the
    port's npz reads back in the reference with the same keys, shapes and
    values (f16 as stored); a file of another arch, or one short of a
    layer, raises and loads nothing."""
    flat, template = flax_init_flat(arch)
    net = coord_net_from_flax(flat)
    assert net.arch == arch
    assert coord_net_from_flax(flat, arch).arch == arch
    back = to_flax_flat(net)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    save_params_npz(tmp_path / "w.npz", net)
    ref = flat_of(jax_load_npz(tmp_path / "w.npz", template))
    assert ref.keys() == flat.keys()
    for k in flat:
        assert ref[k].shape == flat[k].shape
        np.testing.assert_array_equal(ref[k],
                                      flat[k].astype(np.float16))
    assert load_coord_net_npz(tmp_path / "w.npz", "cpu", arch).arch == arch
    other = "dense" if arch != "dense" else "dense_s2d"
    with pytest.raises(ValueError, match="not " + other):
        coord_net_from_flax(flat, other)
    last = max(k for k in flat if "Conv_" in k)  # no half a net
    short = {k: v for k, v in flat.items()
             if not k.startswith(last.rsplit("|", 1)[0] + "|")}
    with pytest.raises(ValueError):
        coord_net_from_flax(short)


def test_mismatched_files_raise():
    """The committed s2d artifact is not a dense net; a patch file with a
    dense layer of the wrong width, or a dense net with a stray layer,
    fits no net."""
    with pytest.raises(ValueError, match="dense_s2d"):
        load_coord_net_npz(ARTIFACTS / "coord_e2e_s2d.npz", "cpu", "dense")
    flat, _ = flax_init_flat("patch")
    flat["params|Dense_1|kernel"] = flat["params|Dense_1|kernel"][:, :-1]
    with pytest.raises(ValueError):
        coord_net_from_flax(flat)
    flat, _ = flax_init_flat("dense")
    flat["params|Conv_10|kernel"] = flat["params|Conv_9|kernel"]
    flat["params|Conv_10|bias"] = flat["params|Conv_9|bias"]
    with pytest.raises(ValueError):
        coord_net_from_flax(flat)


def test_flops_per_arch():
    """profile_serve's FLOP count of a 640x480 frame: the dense net's
    57.07 GFLOP (PERF.md section 5), the s2d stem's, and the patch net's
    1,600 patches of ~0.576 GFLOP each."""
    dense = coord_net_flops(DenseCoordNet(), 480, 640, 1600)
    s2d = coord_net_flops(DenseCoordNet(s2d=True), 480, 640, 1600)
    ctx = coord_net_flops(DenseCoordNet(context=True), 480, 640, 1600)
    patch = coord_net_flops(PatchCoordNet(), 480, 640, 1600)
    assert round(dense / 1e9, 2) == 57.07
    # the s2d stem drops the full-resolution 3 -> 64 conv and the
    # stride-2 64 -> 64 conv for one 12 -> 64 conv at half resolution
    assert dense - s2d == 2 * 9 * (480 * 640 * 3 * 64 + 240 * 320 * 64 * 64
                                   - 240 * 320 * 12 * 64)
    assert ctx - dense == 4 * 2 * 9 * 60 * 80 * 512 * 512
    assert abs(patch / 1600 / 1e9 - 0.576) < 0.005


# ---- one frame per arch through the serve path ----

G, NH, T, TOPK = 12, 64, 4, 4  # test_torch_pipeline.py's draws


def arch_weights(arch: str) -> dict[str, np.ndarray]:
    """Full-width weights: the committed artifact of the arch; for the
    context net, which has none, the trained dense net with the four
    dilated convs inserted at 0.01 x Flax's init scale, so that their
    residuals are real but the frame stays localisable (at 0.05 x, 19 of
    144 inliers were left)."""
    if arch != "dense_ctx":
        return load_params_npz(ARTIFACTS /
                               f"coord_e2e{common.ART_SUFFIX[arch]}.npz")
    dense = load_params_npz(ARTIFACTS / "coord_e2e.npz")
    rng = np.random.default_rng(12)
    flat = {}
    for i in range(14):
        src = i if i < 7 else i - 4
        for leaf in ("kernel", "bias"):
            if 7 <= i < 11:
                shape = (3, 3, 512, 512) if leaf == "kernel" else (512,)
                std = np.sqrt(1.0 / (9 * 512)) * 0.01
                a = (rng.normal(size=shape) * std if leaf == "kernel"
                     else np.zeros(shape))
            else:
                a = dense[f"params|Conv_{src}|{leaf}"]
            flat[f"params|Conv_{i}|{leaf}"] = a.astype(np.float32)
    return flat


@functools.cache
def reference_serve():
    """The reference's serve path on a map of coordinates (metres) at full
    resolution, read at the sampled pixels: two-phase sampling of 64
    hypotheses on a 12x12 grid, fused soft scoring, the top 4 refined.
    Compiled once for every arch."""
    jcfg = JCfg(pose=JPoseCfg(num_hypotheses=NH, sample_attempts=T,
                              random_draw=False), net=JNet(subsample_size=G))

    def lookup(cmap, pix):
        return cmap[pix[:, 1], pix[:, 0]]

    return jcfg, jax.jit(lambda k, cmaps: jax_serve(
        k, cmaps, lookup, None, JScene().camera, jcfg, refine_all=False,
        fused_refine="fused", scoring="fused_soft",
        fused_sampling="two_phase", verify_topk=TOPK))


@pytest.fixture(scope="module", params=["dense_s2d", "dense_ctx", "patch"])
def served_arch(request):
    """One fixture frame (640x480) served by the reference and the port
    with the arch's full-width net in f32, the reference's draws
    injected.  The reference's coord_apply reads the frame at the port's
    sampled pixels, and its serve path reads those coordinates where its
    own sampler puts them (equal pixels, held below)."""
    arch = request.param
    flat = arch_weights(arch)
    _pose, rgb, _depth, _coords = JScene().frame(jax.random.PRNGKey(9003))
    jcfg, serve_ref = reference_serve()
    key = jax.random.PRNGKey(11)
    jitter, idx1, idx2 = reference_draws(key, jcfg)
    draws = FrameDraws(torch.tensor(np.asarray(jitter))[None],
                       torch.tensor(np.asarray(idx1)).long()[None],
                       torch.tensor(np.asarray(idx2)).long()[None])
    cfg = DSACConfig(pose=PoseConfig(num_hypotheses=NH, sample_attempts=T,
                                     random_draw=False),
                     net=NetConfig(subsample_size=G))
    net = coord_net_from_flax(flat, arch)
    net.dtype = torch.float32
    with torch.no_grad():
        got = process_frames_batched(
            torch.tensor(np.asarray(rgb))[None],
            common.coord_fn_for(net, cfg), DataConfig().camera(), cfg,
            verify_topk=TOPK, draws=draws)
    pix = got.sampling.reshape(-1, 2).numpy()
    coords = np.asarray(jax.jit(reference_coord_fn(
        arch, flax_tree(flat), dtype=jnp.float32))(rgb, jnp.asarray(pix)))
    cmap = np.zeros((*rgb.shape[:2], 3), np.float32)
    cmap[pix[:, 1], pix[:, 0]] = coords
    ref = jax.tree.map(np.asarray, serve_ref(key[None],
                                             jnp.asarray(cmap)[None]))
    return arch, got, ref


def test_arch_frame_coordinates_and_served_pose(served_arch):
    arch, got, ref = served_arch
    np.testing.assert_array_equal(got.sampling.numpy(), ref.sampling)
    np.testing.assert_allclose(got.coords.numpy(), ref.coords, atol=0.1)
    np.testing.assert_allclose(got.final.t.numpy(), ref.final.t, atol=2.0)
    np.testing.assert_allclose(got.final.R.numpy(), ref.final.R, atol=1e-4)


# ---- the entry points' --arch on the CPU ----

SMALL = ["--width-mult", "0.125", "--device", "cpu"]


@pytest.mark.parametrize("arch", ["dense", "dense_s2d", "dense_ctx",
                                  "patch"])
def test_arch_rehearsals(tmp_path, arch):
    """One round of train_ransac --arch at the smallest width; its
    end-to-end snapshot, read back by test_ransac --model endtoend --out
    (the tag names the arch) and refused under another --arch; serve
    --arch from an empty run directory (a fresh init and the soft-inlier
    head)."""
    out = tmp_path / "run"
    res = train_ransac.main(["--rounds", "1", "--hypotheses", "16",
                             "--synthetic", "2", "--out", str(out),
                             "--arch", arch] + SMALL)
    assert res["arch"] == arch and res["rounds"][0]["grad_finite"]
    snap = ckpt.restore(out, ckpt.OBJ_E2E)["params"]
    assert coord_net_for_state(snap, arch).arch == arch
    ev = test_ransac.main(["--synthetic", "1", "--rdraw", "0", "--out",
                           str(out), "--arch", arch] + SMALL)
    assert ev["tag"] == f"dsac_{arch}_obj_model_endtoend_rdraw0"
    assert ev["arch"] == arch and ev["all_finite"]
    assert (out / f"ransac_summary_{ev['tag']}.txt").exists()
    other = "patch" if arch != "patch" else "dense"
    with pytest.raises(ValueError, match=f"not {other}"):
        test_ransac.main(["--synthetic", "1", "--out", str(out), "--arch",
                          other] + SMALL)
    empty = tmp_path / "empty"
    empty.mkdir()
    sv = serve.main(["--synthetic", "1", "--batch", "1", "--queue", "1",
                     "--reps", "1", "--arch", arch, "--out", str(empty)]
                    + SMALL)
    assert sv["arch"] == arch and sv["poses_finite"] and sv["scores_finite"]


def test_eval_models_load_the_arch_artifacts():
    """Without --out, --arch picks coord_e2e_{s2d,patch}.npz and its score
    twin; dense_ctx has none committed, which is an error."""
    args = argparse.Namespace(model="endtoend", out=None, weights=None,
                              score_weights=None, arch="dense_s2d",
                              width_mult=1.0)
    m = common.load_eval_models(args, DSACConfig(), torch.device("cpu"),
                                False)
    assert (m.coord_src, m.score_src) == ("coord_e2e_s2d", "score_e2e_s2d")
    assert m.coord_net.arch == "dense_s2d"
    args.arch = "dense_ctx"
    with pytest.raises(FileNotFoundError):
        common.load_eval_models(args, DSACConfig(), torch.device("cpu"),
                                False)
    args.arch, args.weights = "patch", str(ARTIFACTS / "coord_e2e_s2d.npz")
    with pytest.raises(ValueError):
        common.load_eval_models(args, DSACConfig(), torch.device("cpu"),
                                False, score_cnn=False)


if __name__ == "__main__":
    import json
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(reference_accuracy(
        sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 64)))
