"""Relocalisation serving on one GPU (port of dsac_tpu/cli/serve.py's
single-chip path).

Takes the frames of ``--data`` (a 7-Scenes-layout split; its intrinsics
and ``rd`` from ``-c DIR/default.config`` and the reference's short
flags) or ``--synthetic N`` frames of the archetype ``--scene`` of the
frame set of ``--seed`` (cli/common.py; seed 0, the default, is the
bench poses of data/room_default.json, the ground truth), stages a queue
of ``--queue`` batches of ``--batch`` frames on the device, cycling
through the frames, and serves them:
the coordinate net of ``--arch`` (the stride-8 map of a dense net
gathered at the 40x40 sampled pixels, or the patch net on the 1,600
patches centred there) -> P3P sampling of 256 hypotheses with ``--attempts``
attempts (two-phase, re-solving ``--two-phase-budget`` of the pool in
phase 2, or fixed-T through the P3P kernel with ``--no-two-phase``) ->
scores (the fused soft-inlier kernel, or with ``--no-fused-scoring`` the
diff-map kernel and the score CNN, or the soft-inlier head with ``--model
none``) -> argmax -> refinement of the top ``--verify-topk`` (the fused
refine kernel, or the PyTorch IRLS with ``--no-fused-refine``).
``--softam`` serves the soft-argmax variant instead, with the same
kernels: the softmax average of the pool, refined alone (``--verify-topk``
does not apply).  The nets come from ``--model`` (cli/common.py): without
``--out``, the committed artifacts (``*_softam.npz`` with ``--softam``).
One warm-up pass over the queue, then ``--reps`` timed passes;
``--export-poses DIR`` writes the last pass's pose of each distinct frame
as a 7-Scenes pose file.

The defaults are bench.py's, not the reference serve's: fused scoring,
two-phase sampling, ``--verify-topk 4`` and argmax here, where
dsac_tpu/cli/serve.py defaults to the score CNN, fixed-T sampling, the
winner alone and PoseConfig.random_draw.  ``--two-phase-sampling`` is
the reference's name of ``--two-phase``.

Prints one JSON line: throughput, accuracy at 5 cm / 5 deg of the last
pass's poses, median errors, whether every pose and score of the last
pass is finite, the arch, the scene (``"data"`` with ``--data``) and
which frames were served (``frame_set``: "reference", "drawn" or
"dataset"), and each kernel's launch count; with ``--softam`` also
``"variant": "softam"``.

    python -m dsac_tpu_torch.cli.serve --synthetic 64 --queue 8 --batch 8
    python -m dsac_tpu_torch.cli.serve --no-fused-scoring
    python -m dsac_tpu_torch.cli.serve --softam
    python -m dsac_tpu_torch.cli.serve --arch patch
    python -m dsac_tpu_torch.cli.serve --scene clutter --synthetic 24 \
        --seed 99 --weights artifacts/coord_e2e_clutter.npz
    python -m dsac_tpu_torch.cli.serve --data DIR/test/synth \
        -c DIR/default.config
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from dsac_tpu_torch import resolve_device
from dsac_tpu_torch.cli.common import (add_arch_args, add_data_args,
                                       add_model_args, apply_model_flags,
                                       coord_fn_for, frame_source,
                                       load_eval_models)
from dsac_tpu_torch.config import DSACConfig
from dsac_tpu_torch.data.seven_scenes import write_pose_file
from dsac_tpu_torch.flags import parse_with_flags
from dsac_tpu_torch.geometry.loss import is_correct, pose_errors
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.models.score_net import ScoreNet
from dsac_tpu_torch.ops.diffmap_cuda import diffmaps, soft_inlier_scores
from dsac_tpu_torch.ops.gn_cuda import (InitSensitiveRefine, irls_stats,
                                        refine_pose_fused)
from dsac_tpu_torch.ops.p3p_cuda import p3p_solve
from dsac_tpu_torch.pipeline.forward import (FrameResult,
                                             process_frames_batched)
from dsac_tpu_torch.utils.logging import blue

# name -> wrapper, each with its count of launches; the last is the refine
# kernel's launches from the init-pose backward (training)
KERNELS = {"p3p": p3p_solve, "soft_inlier_score": soft_inlier_scores,
           "refine_irls": refine_pose_fused, "diffmap": diffmaps,
           "irls_stats": irls_stats,
           "refine_init_backward": InitSensitiveRefine}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_data_args(ap, synthetic=64, seed=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--queue", type=int, default=8)
    ap.add_argument("--softam", action="store_true",
                    help="serve the soft-argmax variant (the softmax "
                         "average of the pool, refined alone; "
                         "cnn_softam.h:960-1180) with the same kernels")
    ap.add_argument("--verify-topk", type=int, default=None,
                    help="refine the K best-scored hypotheses and serve "
                         "the one with the most inliers (default 4; 0 "
                         "with --softam, where it does not apply)")
    ap.add_argument("--attempts", type=int, default=16)
    ap.add_argument("--two-phase-budget", type=float, default=None,
                    help="share of the pool re-solved at full depth in "
                         "phase 2 (PoseConfig.two_phase_budget, 0.125)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    add_arch_args(ap)
    add_model_args(ap)
    ap.add_argument("--fused-scoring", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="score with the fused soft-inlier kernel; off: "
                         "the diff-map kernel and the score CNN")
    ap.add_argument("--two-phase", "--two-phase-sampling",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="two-phase sampling; off: fixed-T sampling "
                         "through the P3P kernel")
    ap.add_argument("--fused-refine", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="refine with the fused refine kernel; off: the "
                         "PyTorch IRLS")
    ap.add_argument("--export-poses", default=None,
                    help="write the served pose of each distinct frame as "
                         "a 7-Scenes pose file frame-NNNNNN.pose.txt here")
    args, args.cfg, strings = parse_with_flags(ap, argv)
    apply_model_flags(args, strings)
    if args.softam and args.verify_topk:
        print(blue("NOTE: --verify-topk is a no-op with --softam (the "
                   "soft-argmax average IS the served pose; there is no "
                   "pool selection to verify)."))
    if args.verify_topk is None or args.softam:
        args.verify_topk = 0 if args.softam else 4
    return args


class Staged(NamedTuple):
    """A frame queue staged on the device and the function serving it."""

    device: torch.device
    images: torch.Tensor  # (Q, B, H, W, 3) RGB in [0, 255]
    gt: Pose  # (Q * B,) ground-truth scene -> eye poses
    source: object  # the frame source (cli/common.py)
    net: torch.nn.Module  # the coordinate net of --arch
    coord_fn: Callable  # (images, pix) -> (B, N, 3) metres
    score_net: ScoreNet | None  # with --no-fused-scoring and a score CNN
    serve_batch: Callable[[torch.Tensor], FrameResult]


def stage(args: argparse.Namespace) -> Staged:
    """Render the queue, load the weights, and bind the serve config:
    the flags' config with argmax selection (unless -rdraw is given) and
    ``--attempts`` attempts."""
    device = resolve_device(args.device)
    pose = dataclasses.replace(
        args.cfg.pose, sample_attempts=args.attempts,
        random_draw="rdraw" in args.flags_given
        and args.cfg.pose.random_draw)
    if args.two_phase_budget is not None:
        pose = dataclasses.replace(pose,
                                   two_phase_budget=args.two_phase_budget)
    cfg = DSACConfig(data=args.cfg.data, pose=pose)
    cam = cfg.data.camera()
    source = frame_source(args, cfg, device)
    models = load_eval_models(args, cfg, device, args.softam,
                              score_cnn=not args.fused_scoring)
    net = models.coord_net

    B, Q = args.batch, args.queue
    frame = [i % len(source) for i in range(B * Q)]
    gt = Pose(source.poses.R[frame], source.poses.t[frame])
    with torch.no_grad():
        images = torch.stack([source.batch(frame[q * B:(q + 1) * B])[0]
                              for q in range(Q)])

    coord_fn = coord_fn_for(net, cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def serve_batch(imgs: torch.Tensor) -> FrameResult:
        return process_frames_batched(
            imgs, coord_fn, cam, cfg, verify_topk=args.verify_topk,
            generator=gen,
            scoring="fused_soft" if args.fused_scoring else "cnn",
            score_fn=models.score_fn,
            sampling="two_phase" if args.two_phase else True,
            fused_refine=args.fused_refine, softam=args.softam)

    return Staged(device, images, gt, source, net, coord_fn,
                  models.score_net, serve_batch)


def main(argv=None) -> dict:
    args = parse_args(argv)
    st = stage(args)
    device, B, Q = st.device, args.batch, args.queue

    def serve_queue():
        res = [st.serve_batch(st.images[q]) for q in range(Q)]
        return (Pose(torch.cat([r.final.R for r in res]),
                     torch.cat([r.final.t for r in res])),
                [r.scores for r in res])

    with torch.no_grad():
        serve_queue()  # warm-up: cuDNN algorithm choice, allocator
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                out, scores = serve_queue()
            end.record()
            torch.cuda.synchronize(device)
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                out, scores = serve_queue()
            seconds = time.perf_counter() - t0

    if args.export_poses:
        pose_dir = Path(args.export_poses)
        pose_dir.mkdir(parents=True, exist_ok=True)
        translation = st.source.translation
        for i in range(min(len(st.source), Q * B)):  # the distinct frames
            write_pose_file(pose_dir / f"frame-{i:06d}.pose.txt",
                            out.R[i].cpu().numpy(), out.t[i].cpu().numpy(),
                            translation)
    rot, trans = pose_errors(out, st.gt)
    correct = is_correct(out, st.gt)
    result = {
        "metric": "serve_relocalizations_per_s",
        "reloc_per_s": args.reps * Q * B / seconds,
        "accuracy_5cm5deg": float(correct.float().mean()),
        "median_rot_deg": float(rot.median()),
        "median_trans_mm": float(trans.median()),
        "poses_finite": bool(torch.isfinite(out.R).all()
                             and torch.isfinite(out.t).all()),
        "scores_finite": all(bool(torch.isfinite(x).all()) for x in scores),
        **({"variant": "softam"} if args.softam else {}),
        "arch": args.arch,
        "model": args.model,
        "scoring": "fused_soft" if args.fused_scoring else "cnn",
        "sampling": "two_phase" if args.two_phase else "fixed_t_fused",
        "batch": B, "queue": Q, "verify_topk": args.verify_topk,
        "fused_refine": args.fused_refine,
        "attempts": args.attempts, "reps": args.reps,
        "frames": len(st.source),
        "scene": st.source.name,
        "frame_set": st.source.frame_set,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "launches": {name: fn.launches for name, fn in KERNELS.items()},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
