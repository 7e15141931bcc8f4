"""Shared plumbing of the entry points (port of dsac_tpu/cli/common.py:
the frame sources, Frame, SyntheticSource, SevenScenesSource and
frame_source, :25-118 and :202-210; soft_inlier_score_fn, :213-224; and
the model selection of load_eval_params, :330-402).

Frames come from ``--data`` (a 7-Scenes-layout split, decoded on the host
and moved to the device) or else ``--synthetic N`` frames of the
archetype ``--scene`` (data/synthetic.py), rendered on the device, of the
frame set of ``--seed``: seed 0 gives bench.py's frames (keys 9000 + i,
the 64 the port has always served), any other seed S SyntheticSource's
keys S * 100003 + i, the reference's frames where scene_frames.json holds
them (seeds 3 and 99) and frames drawn from the reference's distributions
elsewhere.  A source says which (``frame_set``: "reference", "drawn",
"reference+drawn" or "dataset").  ``--data`` wins over ``--synthetic``,
as in the reference.  The reference's short flags and ``-c`` config file
(flags.py) set the intrinsics, image size and ``rd`` of a dataset.

``--model`` picks the nets that ``serve`` and ``test_ransac`` evaluate:

  endtoend  with ``--out``: the end-to-end snapshots (``obj_model_
            [softam_]endtoend``), else ``obj_model_init``; without it: the
            committed artifacts ``coord_e2e[_softam].npz`` and
            ``score_e2e[_softam].npz``, and a missing file is an error;
  best      with ``--out``: the validation-selected ``*_best`` snapshots,
            then the end-to-end ones, then the init ones;
  init      with ``--out``: ``obj_model_init`` and ``score_model_init``;
  none      no score CNN: the soft-inlier head scores the diff-maps; the
            coordinate net is the one ``--out`` gives for none (a fresh
            init, as in the reference) or, without ``--out``, the
            committed artifact.

``--arch`` picks the coordinate net (models/coord_net.py): the artifacts
are ``coord_e2e{_s2d|_patch}[_softam].npz`` and their ``score_e2e``
twins, as bench.py names them (``dense_ctx`` has none committed); a file
or snapshot of another arch is an error.  ``--width-mult`` sizes a
freshly initialised net; loaded nets take their widths from their files.

With ``--out``, the reference's order of fallbacks holds: a coordinate
net found in no snapshot is a fresh init (seed 1), and a score net found
in none is the soft-inlier head.  ``--weights`` and ``--score-weights``
(or the reference's ``-omodel`` and ``-smodel``) name npz artifacts, or
with ``-omodel``/``-smodel`` snapshots in ``--out``, that win over
``--model``.  Snapshots are those of ``utils/checkpoint.py``
(``{"params": state_dict, ...}``), as ``train_ransac`` writes them.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from dsac_tpu_torch.config import DataConfig, DSACConfig
from dsac_tpu_torch.data.seven_scenes import SevenScenesDataset
from dsac_tpu_torch.data.synthetic import (ARCHETYPES, SyntheticScene,
                                           frame_set, make_scene,
                                           render_frames)
from dsac_tpu_torch.flags import apply_string_flags
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.models import (ScoreNet, coord_net_for_state,
                                   init_like_flax)
from dsac_tpu_torch.models.coord_net import (ARCHS, coord_apply,
                                             make_coord_net)
from dsac_tpu_torch.ops.diffmap import soft_inlier_scores
from dsac_tpu_torch.pipeline.forward import CoordFn, ScoreFn
from dsac_tpu_torch.utils import checkpoint as ckpt
from dsac_tpu_torch.utils.logging import blue
from dsac_tpu_torch.utils.params_io import (load_coord_net_npz,
                                            load_score_net_npz)

REPO = Path(__file__).resolve().parents[2]
MODELS = ("endtoend", "best", "init", "none")
# the artifacts' file suffix per arch (bench.py:41-43)
ART_SUFFIX = {"dense": "", "dense_s2d": "_s2d", "dense_ctx": "_ctx",
              "patch": "_patch"}


class Frame(NamedTuple):
    """One frame on the device (dsac_tpu/cli/common.py:25-30)."""

    rgb: torch.Tensor  # (H, W, 3) float32 in [0, 255]
    pose: Pose  # R (3, 3), t (3,): scene -> eye, mm; the ground truth
    obj: torch.Tensor  # (H, W, 3) scene coordinates, mm; 0 invalid
    depth: torch.Tensor  # (H, W) mm


class SyntheticSource:
    """``n`` frames of a scene's frame set of ``seed``
    (data/synthetic.py:frame_set), rendered on the scene's device when
    asked for; a frame renders the same each time, noise included.
    ``name`` is the archetype's; a synthetic scene has no ``translation``
    (the offset that pose files add)."""

    translation = None

    def __init__(self, n: int, seed: int, scene: SyntheticScene):
        self.scene, self.n, self.seed = scene, n, seed
        self.name = scene.name
        self.frames = frame_set(scene, seed, n)
        self.frame_set = self.frames.origin
        self.poses = self.frames.poses  # (n,)

    def __len__(self) -> int:
        return self.n

    def batch(self, idx: list[int]) -> tuple[torch.Tensor, Pose]:
        """Frames ``idx``: RGB (B, H, W, 3) and their poses (B,)."""
        rgb, _depth, _coords, pose = render_frames(self.scene, self.frames,
                                                   idx)
        return rgb, pose

    def get(self, i: int) -> Frame:
        rgb, depth, coords, pose = render_frames(self.scene, self.frames,
                                                 [i])
        return Frame(rgb[0], Pose(pose.R[0], pose.t[0]), coords[0],
                     depth[0])


class SevenScenesSource:
    """The frames of a 7-Scenes-layout split, decoded on the host when
    asked for and moved to ``device`` (dsac_tpu/cli/common.py:92-117).
    Its ``name`` is ``"data"``; ``translation`` is the scene's offset in
    metres, which exported pose files add back."""

    frame_set = "dataset"
    name = "data"

    def __init__(self, root: str | Path, config: DataConfig,
                 device: torch.device):
        self.ds = SevenScenesDataset(root, config=config)
        self.translation = self.ds.translation
        self.device = device
        R, t = zip(*(self.ds.get_pose(i) for i in range(len(self.ds))))
        self.poses = Pose(torch.tensor(np.stack(R), dtype=torch.float32,
                                       device=device),
                          torch.tensor(np.stack(t), dtype=torch.float32,
                                       device=device))

    def __len__(self) -> int:
        return len(self.ds)

    def _rgb(self, i: int) -> torch.Tensor:
        return torch.from_numpy(self.ds.get_rgb(i).astype(np.float32)).to(
            self.device)

    def batch(self, idx: list[int]) -> tuple[torch.Tensor, Pose]:
        """Frames ``idx``: RGB (B, H, W, 3) and their poses (B,)."""
        return (torch.stack([self._rgb(i) for i in idx]),
                Pose(self.poses.R[idx], self.poses.t[idx]))

    def get(self, i: int) -> Frame:
        obj = torch.from_numpy(self.ds.get_obj(i)).to(self.device)
        depth = torch.from_numpy(self.ds.get_depth(i).astype(
            np.float32)).to(self.device)
        return Frame(self._rgb(i), Pose(self.poses.R[i], self.poses.t[i]),
                     obj, depth)


def add_data_args(ap: argparse.ArgumentParser, synthetic: int,
                  seed: int) -> None:
    """``--data``, ``--synthetic``, ``--scene`` and ``--seed``
    (dsac_tpu/cli/common.py:120-151), with an entry point's defaults."""
    ap.add_argument("--data", default=None,
                    help="7-Scenes-layout directory (a training or test "
                         "split); wins over --synthetic")
    ap.add_argument("--synthetic", type=int, default=synthetic,
                    help="use N procedural frames of --scene instead of "
                         "--data")
    ap.add_argument("--scene", choices=sorted(ARCHETYPES), default="room",
                    help="synthetic scene archetype (data/synthetic.py): "
                         "room (default), repeat, bare, noisy, clutter, "
                         "hard")
    ap.add_argument("--seed", type=int, default=seed,
                    help="the synthetic frame set: 0 is bench.py's frames, "
                         "S the reference's SyntheticSource keys "
                         "S * 100003 + i")


def frame_source(args: argparse.Namespace, cfg: DSACConfig,
                 device: torch.device):
    """The frames of ``--data`` or ``--synthetic``/``--scene``/``--seed``
    (dsac_tpu/cli/common.py:202-210); the synthetic scene takes the
    config's image size and focal length."""
    if args.data:
        return SevenScenesSource(args.data, cfg.data, device)
    if args.synthetic < 1:
        raise SystemExit("--synthetic must be at least 1")
    d = cfg.data
    scene = make_scene(args.scene, d.image_width, d.image_height,
                       d.focal_length, device)
    return SyntheticSource(args.synthetic, args.seed, scene)


def add_arch_args(ap: argparse.ArgumentParser) -> None:
    """``--arch`` and ``--width-mult`` (dsac_tpu/cli/common.py:132-141)."""
    ap.add_argument("--arch", choices=ARCHS, default="dense",
                    help="coordinate net: dense FCN (flagship), dense FCN "
                         "with space-to-depth stem, dense FCN + dilated "
                         "long-range-context stack (~530 px RF for "
                         "period-ambiguous scenes), or reference-parity "
                         "patch net")
    ap.add_argument("--width-mult", type=float, default=1.0,
                    help="width multiplier of freshly initialised nets "
                         "(loaded nets keep their widths)")


def coord_fn_for(net: torch.nn.Module, cfg: DSACConfig) -> CoordFn:
    """The coordinate stage of a net, (images, pix) -> (B, N, 3) metres:
    the dense archs' stride-8 map gathered at the pixels, or the patch
    net on ``cfg.net.rgb_patch_size`` patches centred there."""
    size = cfg.net.rgb_patch_size
    return lambda images, pix: coord_apply(net, images, pix, size)


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """``--model``, ``--out``, ``--weights`` and ``--score-weights``."""
    ap.add_argument("--model", choices=MODELS, default="endtoend",
                    help="the nets to evaluate (cli/common.py): endtoend, "
                         "the validation-selected best, init, or none (the "
                         "soft-inlier head, no score CNN)")
    ap.add_argument("--out", default=None,
                    help="directory of train_ransac's snapshots, which "
                         "--model selects from; test_ransac writes its "
                         "per-frame log there.  Without it, --model "
                         "endtoend and none load the committed artifacts")
    ap.add_argument("--weights", default=None,
                    help="coordinate-net npz artifact; wins over --model")
    ap.add_argument("--score-weights", default=None,
                    help="score-net npz artifact; wins over --model")


def soft_inlier_score_fn(cfg: DSACConfig) -> ScoreFn:
    """The parameter-free scoring head: the soft inlier count of each
    (G, G) diff-map, (M, G, G) -> (M,) (common.py:213-224)."""
    p = cfg.pose

    def fn(dm: torch.Tensor) -> torch.Tensor:
        return soft_inlier_scores(dm.reshape(dm.shape[0], -1),
                                  p.inlier_threshold_2d, p.score_beta)

    return fn


class EvalModels(NamedTuple):
    coord_net: torch.nn.Module  # of --arch
    coord_src: str  # the snapshot or artifact it came from, or "random"
    score_net: ScoreNet | None  # None: the soft-inlier head, or no scoring
    score_fn: ScoreFn | None  # the score CNN or the soft-inlier head
    score_src: str  # the snapshot or artifact, "soft_inlier_head" or "none"


def _coord_from_snapshot(out: str, name: str, arch: str,
                         device) -> torch.nn.Module:
    """The snapshot's coordinate net, rebuilt from its parameters' names
    and shapes; one of another arch than ``arch`` raises ValueError."""
    params = ckpt.restore(out, name)["params"]
    return coord_net_for_state(params, arch).to(device).eval()


def _score_from_snapshot(out: str, name: str, device) -> ScoreNet:
    params = ckpt.restore(out, name)["params"]
    net = ScoreNet(width_mult=params["convs.9.weight"].shape[0] / 512)
    net.load_state_dict(params)
    return net.to(device).eval()


def apply_model_flags(args: argparse.Namespace, strings: dict) -> None:
    """The reference's -omodel and -smodel (flags.apply_string_flags) onto
    ``args``: an npz artifact (a path, else a file in ``--out``) becomes
    ``--weights`` or ``--score-weights`` unless those are given; a
    snapshot name in ``--out`` becomes ``args.coord_name`` or
    ``args.score_name``, which ``load_eval_models`` loads or fails on."""
    for flag, name, weights, attr in zip(
            ("-omodel", "-smodel"), apply_string_flags(strings),
            ("weights", "score_weights"), ("coord_name", "score_name")):
        setattr(args, attr, None)
        if name is None or getattr(args, weights):
            continue
        if name.endswith(".npz"):
            path = Path(name)
            if not path.exists() and args.out:
                path = Path(args.out) / name
            setattr(args, weights, str(path))
        elif not args.out:
            raise SystemExit(f"{flag} {name!r} names a snapshot: it needs "
                             "--out")
        else:
            setattr(args, attr, name)


def load_eval_models(args: argparse.Namespace, cfg: DSACConfig,
                     device: torch.device, softam: bool,
                     score_cnn: bool = True) -> EvalModels:
    """The nets of ``--model``, ``--out``, ``--weights`` and
    ``--score-weights`` (module docstring).  ``score_cnn=False`` (fused
    scoring) loads no score net."""
    suffix = ART_SUFFIX[args.arch] + ("_softam" if softam else "")
    obj_e2e = ckpt.OBJ_SOFTAM if softam else ckpt.OBJ_E2E
    score_e2e = ckpt.SCORE_SOFTAM if softam else ckpt.SCORE_E2E
    if args.model in ("init", "best") and not args.out:
        raise SystemExit(f"--model {args.model} needs --out (the directory "
                         "of train_ransac's snapshots)")

    if args.weights or not args.out:
        path = args.weights or REPO / "artifacts" / f"coord_e2e{suffix}.npz"
        coord_net, coord_src = load_coord_net_npz(path, device,
                                                  args.arch), Path(path).stem
    else:
        named = getattr(args, "coord_name", None)
        names = [named] if named else {
            "endtoend": [obj_e2e, ckpt.OBJ_INIT],
            "best": [obj_e2e + "_best", obj_e2e, ckpt.OBJ_INIT],
            "init": [ckpt.OBJ_INIT], "none": []}[args.model]
        coord_net, coord_src = None, "random"
        for name in names:
            try:
                coord_net, coord_src = _coord_from_snapshot(
                    args.out, name, args.arch, device), name
                print(blue(f"Loaded {name}."))
                break
            except FileNotFoundError:
                continue
        if coord_net is None and named:
            raise SystemExit(f"-omodel {named!r} could not be loaded from "
                             f"{args.out}")
        if coord_net is None:
            print(blue("Using freshly initialised coordinate net."))
            coord_net = init_like_flax(
                make_coord_net(args.arch, args.width_mult),
                torch.Generator().manual_seed(1)).to(device).eval()

    if not score_cnn:
        return EvalModels(coord_net, coord_src, None, None, "none")
    score_net, score_src = None, "soft_inlier_head"
    if args.score_weights or (not args.out and args.model != "none"):
        path = (args.score_weights
                or REPO / "artifacts" / f"score_e2e{suffix}.npz")
        score_net, score_src = load_score_net_npz(path, device), \
            Path(path).stem
    elif args.model != "none" or getattr(args, "score_name", None):
        named = getattr(args, "score_name", None)
        names = [named] if named else {
            "endtoend": [score_e2e],
            "best": [score_e2e + "_best", score_e2e, ckpt.SCORE_INIT],
            "init": [ckpt.SCORE_INIT]}[args.model]
        for name in names:
            try:
                score_net, score_src = _score_from_snapshot(
                    args.out, name, device), name
                break
            except FileNotFoundError:
                continue
        if score_net is None and named:
            raise SystemExit(f"-smodel {named!r} could not be loaded from "
                             f"{args.out}")
    if score_net is None:
        print(blue("Scoring with the soft-inlier head."))
        return EvalModels(coord_net, coord_src, None,
                          soft_inlier_score_fn(cfg), score_src)
    return EvalModels(coord_net, coord_src, score_net, score_net, score_src)
