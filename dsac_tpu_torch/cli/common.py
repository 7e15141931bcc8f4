"""Shared plumbing of the evaluation entry points (port of
dsac_tpu/cli/common.py: soft_inlier_score_fn, :213-224, and the model
selection of load_eval_params, :330-402).

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
name npz artifacts that win over ``--model``.  Snapshots are those of
``utils/checkpoint.py`` (``{"params": state_dict, ...}``), as
``train_ransac`` writes them.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import NamedTuple

import torch

from dsac_tpu_torch.config import DSACConfig
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
        names = {"endtoend": [obj_e2e, ckpt.OBJ_INIT],
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
    elif args.model != "none":
        names = {"endtoend": [score_e2e],
                 "best": [score_e2e + "_best", score_e2e, ckpt.SCORE_INIT],
                 "init": [ckpt.SCORE_INIT]}[args.model]
        for name in names:
            try:
                score_net, score_src = _score_from_snapshot(
                    args.out, name, device), name
                break
            except FileNotFoundError:
                continue
    if score_net is None:
        print(blue("Scoring with the soft-inlier head."))
        return EvalModels(coord_net, coord_src, None,
                          soft_inlier_score_fn(cfg), score_src)
    return EvalModels(coord_net, coord_src, score_net, score_net, score_src)
