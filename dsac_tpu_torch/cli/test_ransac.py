"""Evaluation over the fixture frames (port of dsac_tpu/cli/test_ransac.py
and test_ransac_softam.py, single device, without ``--mesh``).

Takes the frames of ``--data`` (a 7-Scenes-layout split; its intrinsics
and ``rd`` from ``-c DIR/default.config`` and the reference's short
flags: -rI, -rdraw, ...) or ``--synthetic N`` frames of the archetype
``--scene`` of the frame set of ``--seed`` (cli/common.py; seed 0, the
default, is the bench poses of data/room_default.json) and runs the
reference's test_ransac forward pass on each frame: the coordinate net of ``--arch``
(cli/serve.py) -> fixed-T sampling
of 256 hypotheses with 16 attempts, every attempt polished by the PyTorch
P3P solver -> the diff-map kernel and the score CNN (or, with
``--model none``, the soft-inlier head; with ``--fused-scoring``, the
score kernel and no score CNN) -> refinement of the whole pool (one
launch of the refine kernel with ``--fused-refine``, else the PyTorch
IRLS; with ``--refine-variant hard``, the hard-threshold ablation in
PyTorch) -> the winner: drawn from the score softmax (``--rdraw 1``) or
its argmax (``--rdraw 0``), or with ``--select inlier`` the refined
hypothesis with the largest inlier count.  ``--rdraw`` and the
reference's ``-rdraw`` are one setting; the long option wins.  ``--softam`` (or
``test_ransac_softam``) evaluates the soft-argmax variant instead: the
softmax average of the pool, refined alone; as in the reference it
ignores ``--fused-scoring``, ``--refine-variant hard`` and ``--select
inlier``.  Frame i draws from a generator seeded with
``--seed * 131 + i``, as the reference keys it.

The nets come from ``--model`` (cli/common.py): without ``--out``, the
committed artifacts; ``-omodel``/``-smodel`` name others.  With
``--out``, the per-frame log and the summary (utils/logging.py:TestLog)
are written there, under the reference's tag.  ``--export-poses DIR``
writes each served pose as a 7-Scenes pose file; poses of a dataset are
written with its translation.txt offset re-added, as the reference
writes them.

``--check-refine`` (with ``--fused-refine``, DSAC, soft refinement) also
refines each pool with ``refine_pose_fused_steps`` (one launch of the
IRLS-statistics kernel per step) and reports, over the frames, the
largest gap to the single-launch refine kernel at the served hypothesis.

Prints one JSON line: the reference's summary (accuracy at 5 cm / 5 deg,
median errors, mean and spread of the expected loss and of the entropy),
the variant and tag, the scene (``"data"`` with ``--data``) and which
frames were evaluated (``frame_set``), each kernel's launch count, and
the seconds the frames took (rendering or decoding included, the model's
loading not).  ``main``
returns that line's dict and, under ``"final"``, the served poses.

    python -m dsac_tpu_torch.cli.test_ransac --synthetic 64 --fused-refine
    python -m dsac_tpu_torch.cli.test_ransac_softam --fused-refine
    python -m dsac_tpu_torch.cli.test_ransac --arch patch --fused-refine
    python -m dsac_tpu_torch.cli.test_ransac --scene clutter --synthetic 24 \
        --seed 99 --fused-refine -rdraw 0 \
        --weights artifacts/coord_e2e_clutter.npz \
        --score-weights artifacts/score_e2e_clutter.npz
    python -m dsac_tpu_torch.cli.test_ransac --data DIR/test/synth \
        -c DIR/default.config --fused-refine -rdraw 0
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from dsac_tpu_torch import resolve_device
from dsac_tpu_torch.cli.common import (add_arch_args, add_data_args,
                                       add_model_args, apply_model_flags,
                                       coord_fn_for, frame_source,
                                       load_eval_models)
from dsac_tpu_torch.cli.serve import KERNELS
from dsac_tpu_torch.config import DSACConfig, PoseConfig
from dsac_tpu_torch.data.seven_scenes import (pose_to_7scenes_vec6,
                                              write_pose_file)
from dsac_tpu_torch.flags import parse_with_flags
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.ops.gn_cuda import refine_pose_fused_steps
from dsac_tpu_torch.pipeline import (evaluate_frame, process_frames_batched,
                                     summarize, verified_selection)
from dsac_tpu_torch.utils.logging import TestLog, green, red


def parse_args(argv=None, softam: bool = False) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_data_args(ap, synthetic=64, seed=0)
    ap.add_argument("--softam", action="store_true", default=softam,
                    help="the soft-argmax variant (test_ransac_softam); "
                         "ignores --fused-scoring, --refine-variant hard "
                         "and --select inlier, as the reference does")
    ap.add_argument("--fused-refine", action="store_true",
                    help="refine with the fused refine kernel (one launch "
                         "a frame); default: the PyTorch IRLS")
    ap.add_argument("--refine-variant", choices=["soft", "hard"],
                    default="soft",
                    help="hard: the reference's hard-threshold refinement "
                         "with the rB = 100 cap and the abort below 50 "
                         "inliers, in PyTorch (core/cnn.h:1186-1204)")
    ap.add_argument("--fused-scoring", action="store_true",
                    help="score with the fused soft-inlier kernel (no "
                         "score CNN, no diff-maps)")
    ap.add_argument("--select", choices=["score", "inlier"], default="score",
                    help="winner: the pre-refinement score draw or argmax, "
                         "or the largest post-refinement inlier count")
    ap.add_argument("--rdraw", type=int, choices=[0, 1], default=None,
                    help="1: draw the winner from the score softmax; "
                         "0: argmax (PoseConfig.random_draw); default: "
                         "the reference's -rdraw, else 1")
    ap.add_argument("--check-refine", action="store_true",
                    help="with --fused-refine: also refine each pool "
                         "stepwise and report the gap")
    ap.add_argument("--export-poses", default=None,
                    help="write each served pose as a 7-Scenes pose file "
                         "frame-NNNNNN.pose.txt under this directory")
    ap.add_argument("--device", default="cuda")
    add_arch_args(ap)
    add_model_args(ap)
    args, cfg, strings = parse_with_flags(ap, argv)
    if args.rdraw is None:
        args.rdraw = int(cfg.pose.random_draw)
    args.cfg = DSACConfig(data=cfg.data, pose=dataclasses.replace(
        cfg.pose, random_draw=bool(args.rdraw)))
    apply_model_flags(args, strings)
    return args


def eval_tag(args: argparse.Namespace, coord_src: str, H: int) -> str:
    """The reference's file tag (test_ransac.py:95-103)."""
    variant = "softam" if args.softam else "dsac"
    tag = f"{variant}_{args.arch}_{coord_src}_rdraw{args.rdraw}"
    if not args.softam:
        if args.select == "inlier":
            tag += "_selinlier"
        if args.refine_variant == "hard":
            tag += "_hardref"
        if args.fused_scoring:
            tag += f"_fusedscore_h{H}"
    return tag


def check_refine(res, cam, p: PoseConfig) -> tuple[float, float]:
    """The stepwise refiner against the refine kernel on one frame's pool:
    |dt| mm and |dR| at the served hypothesis."""
    steps, _ = refine_pose_fused_steps(
        res.hyps, res.coords, res.sampling.reshape(1, -1, 2).float(), cam,
        steps=p.refinement_steps * p.gn_inner_steps,
        threshold=p.inlier_threshold_2d, beta=p.inlier_beta,
        min_inliers=p.min_inliers, damping=p.gn_damping,
        max_error=p.max_reprojection_error)
    c = int(res.chosen[0])
    return (float((steps.t - res.refined.t)[0, c].abs().max()),
            float((steps.R - res.refined.R)[0, c].abs().max()))


def main(argv=None, softam: bool = False) -> dict:
    args = parse_args(argv, softam)
    dsac = not args.softam
    hard = dsac and args.refine_variant == "hard"
    fused_scoring = dsac and args.fused_scoring
    if args.check_refine and not (args.fused_refine and dsac and not hard):
        raise SystemExit("--check-refine needs --fused-refine, DSAC and "
                         "--refine-variant soft")
    device = resolve_device(args.device)
    cfg = args.cfg
    cam = cfg.data.camera()
    p = cfg.pose
    source = frame_source(args, cfg, device)
    models = load_eval_models(args, cfg, device, args.softam,
                              score_cnn=not fused_scoring)
    coord_fn = coord_fn_for(models.coord_net, cfg)
    tag = eval_tag(args, models.coord_src, p.num_hypotheses)
    log = TestLog(args.out, tag) if args.out else None
    if args.export_poses:
        pose_dir = Path(args.export_poses)
        pose_dir.mkdir(parents=True, exist_ok=True)

    rots, trans, exps, ents, winners, checks = [], [], [], [], [], []
    served = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(len(source)):
            image, gt = source.batch([i])
            gen = torch.Generator(device=device).manual_seed(
                args.seed * 131 + i)
            res = process_frames_batched(
                image, coord_fn, cam, cfg, generator=gen,
                scoring="fused_soft" if fused_scoring else "cnn",
                score_fn=models.score_fn, sampling=False, refine_all=True,
                fused_refine="hard" if hard else args.fused_refine,
                softam=args.softam)
            if dsac and args.select == "inlier":
                res = verified_selection(res)
            ev = evaluate_frame(res, gt)
            rot, te = float(ev.rot_err_deg[0]), float(ev.trans_err_mm[0])
            rots.append(rot)
            trans.append(te)
            exps.append(float(ev.expected_loss[0]))
            ents.append(float(ev.entropy[0]))
            winners.append(float(ev.losses[0, int(res.chosen[0])]))
            served.append(Pose(res.final.R[0].cpu(), res.final.t[0].cpu()))
            R, t = served[-1].R.numpy(), served[-1].t.numpy()
            if log is not None:
                log.frame(exps[-1], ents[-1], winners[-1], te, rot,
                          pose_to_7scenes_vec6(R, t, source.translation))
            if args.export_poses:
                write_pose_file(pose_dir / f"frame-{i:06d}.pose.txt", R, t,
                                source.translation)
            if args.check_refine:
                checks.append(check_refine(res, cam, p))
            colour = green if (rot < 5.0 and te < 50.0) else red
            print(colour(f"frame {i}: rot {rot:.2f} deg, trans {te:.1f} mm"))

    seconds = time.perf_counter() - t0  # each frame ends in a host read
    stats = summarize(np.asarray(rots), np.asarray(trans), np.asarray(exps),
                      np.asarray(ents))
    if log is not None:
        log.summary(stats)
        log.close()
    result = {
        "metric": "test_ransac",
        **stats,
        "mean_winner_loss": float(np.mean(winners)),
        "all_finite": bool(np.isfinite([rots, trans, exps, ents]).all()),
        "variant": "softam" if args.softam else "dsac", "tag": tag,
        "arch": args.arch,
        "scene": source.name,
        "frame_set": source.frame_set,
        "model": args.model, "coord_src": models.coord_src,
        "score_src": models.score_src,
        "scoring": "fused_soft" if fused_scoring else "cnn",
        "refine_variant": "hard" if hard else "soft",
        "select": args.select if dsac else "softam_average",
        "rdraw": args.rdraw, "fused_refine": args.fused_refine,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "launches": {name: fn.launches for name, fn in KERNELS.items()},
        "seconds": seconds,
    }
    if args.check_refine:
        result["refine_check"] = {
            "served_max_abs_dt_mm": max(c[0] for c in checks),
            "served_max_abs_dR": max(c[1] for c in checks)}
    if args.export_poses:
        result["exported_poses"] = str(pose_dir)
    print(json.dumps(result), flush=True)
    # returned beside the printed line: the served poses (N,)
    result["final"] = Pose(torch.stack([x.R for x in served]),
                           torch.stack([x.t for x in served]))
    return result


if __name__ == "__main__":
    main()
