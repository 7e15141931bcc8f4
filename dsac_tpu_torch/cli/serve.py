"""Relocalisation serving on one GPU (port of dsac_tpu/cli/serve.py's
single-chip path).

Renders ``--synthetic N`` frames of the default room at the bench poses
(data/room_default.json, the ground truth), stages a queue of
``--queue`` batches of ``--batch`` frames on the device, and serves them:
DenseCoordNet (weights from ``--weights``) -> P3P sampling of 256
hypotheses with ``--attempts`` attempts (two-phase, or fixed-T through
the P3P kernel with ``--no-two-phase``) -> scores (the fused soft-inlier
kernel, or with ``--no-fused-scoring`` the diff-map kernel and the score
CNN of ``--score-weights``) -> argmax -> fused IRLS refinement of the top
``--verify-topk``.  One warm-up pass over the queue, then ``--reps`` timed
passes.

Prints one JSON line: throughput, accuracy at 5 cm / 5 deg of the last
pass's poses, median errors, and each kernel's launch count.

    python -m dsac_tpu_torch.cli.serve --synthetic 64 --queue 8 --batch 8
    python -m dsac_tpu_torch.cli.serve --no-fused-scoring
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from dsac_tpu_torch import resolve_device
from dsac_tpu_torch.config import DataConfig, DSACConfig, PoseConfig
from dsac_tpu_torch.data.synthetic import SyntheticScene
from dsac_tpu_torch.geometry.loss import is_correct, pose_errors
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.models.coord_net import DenseCoordNet, gather_dense_coords
from dsac_tpu_torch.models.score_net import ScoreNet
from dsac_tpu_torch.ops.diffmap_cuda import diffmaps, soft_inlier_scores
from dsac_tpu_torch.ops.gn_cuda import (InitSensitiveRefine, irls_stats,
                                        refine_pose_fused)
from dsac_tpu_torch.ops.p3p_cuda import p3p_solve
from dsac_tpu_torch.pipeline.forward import (FrameResult,
                                             process_frames_batched)
from dsac_tpu_torch.utils.params_io import (load_coord_net_npz,
                                            load_score_net_npz)

REPO = Path(__file__).resolve().parents[2]
# name -> wrapper, each with its count of launches; the last is the refine
# kernel's launches from the init-pose backward (training)
KERNELS = {"p3p": p3p_solve, "soft_inlier_score": soft_inlier_scores,
           "refine_irls": refine_pose_fused, "diffmap": diffmaps,
           "irls_stats": irls_stats,
           "refine_init_backward": InitSensitiveRefine}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic", type=int, default=64,
                    help="distinct fixture frames to serve (at most 64)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--queue", type=int, default=8)
    ap.add_argument("--verify-topk", type=int, default=4)
    ap.add_argument("--attempts", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weights", default=str(REPO / "artifacts" /
                                             "coord_e2e.npz"))
    ap.add_argument("--score-weights", default=str(REPO / "artifacts" /
                                                   "score_e2e.npz"),
                    help="score CNN weights (with --no-fused-scoring)")
    ap.add_argument("--fused-scoring", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="score with the fused soft-inlier kernel; off: "
                         "the diff-map kernel and the score CNN")
    ap.add_argument("--two-phase", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="two-phase sampling; off: fixed-T sampling "
                         "through the P3P kernel")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


class Staged(NamedTuple):
    """A frame queue staged on the device and the function serving it."""

    device: torch.device
    images: torch.Tensor  # (Q, B, H, W, 3) RGB in [0, 255]
    gt: Pose  # (Q * B,) ground-truth scene -> eye poses
    net: DenseCoordNet
    score_net: ScoreNet | None  # with --no-fused-scoring
    serve_batch: Callable[[torch.Tensor], FrameResult]


def stage(args: argparse.Namespace) -> Staged:
    """Render the queue, load the weights, and bind the serve config."""
    device = resolve_device(args.device)
    data = DataConfig()
    scene = SyntheticScene(data.image_width, data.image_height,
                           data.focal_length, device=device)
    n_poses = scene.bench_poses.t.shape[0]
    if not 1 <= args.synthetic <= n_poses:
        raise SystemExit(f"--synthetic must be in 1..{n_poses}")
    cam = data.camera()
    cfg = DSACConfig(data=data, pose=PoseConfig(
        num_hypotheses=256, random_draw=False,
        sample_attempts=args.attempts))
    net = load_coord_net_npz(args.weights, device)
    score_net = (None if args.fused_scoring
                 else load_score_net_npz(args.score_weights, device))

    B, Q = args.batch, args.queue
    frame = torch.arange(B * Q, device=device) % args.synthetic
    gt = Pose(scene.bench_poses.R[frame], scene.bench_poses.t[frame])
    with torch.no_grad():
        images = torch.stack([
            scene.render(Pose(gt.R[q * B:(q + 1) * B],
                              gt.t[q * B:(q + 1) * B]))[0]
            for q in range(Q)])

    def coord_fn(imgs, pix):
        return gather_dense_coords(net(imgs), pix, stride=8)

    gen = torch.Generator(device=device).manual_seed(args.seed)

    def serve_batch(imgs: torch.Tensor) -> FrameResult:
        return process_frames_batched(
            imgs, coord_fn, cam, cfg, verify_topk=args.verify_topk,
            generator=gen,
            scoring="fused_soft" if args.fused_scoring else "cnn",
            score_fn=score_net,
            sampling="two_phase" if args.two_phase else True)

    return Staged(device, images, gt, net, score_net, serve_batch)


def main(argv=None) -> dict:
    args = parse_args(argv)
    st = stage(args)
    device, B, Q = st.device, args.batch, args.queue

    def serve_queue():
        res = [st.serve_batch(st.images[q]) for q in range(Q)]
        return Pose(torch.cat([r.final.R for r in res]),
                    torch.cat([r.final.t for r in res]))

    with torch.no_grad():
        serve_queue()  # warm-up: cuDNN algorithm choice, allocator
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                out = serve_queue()
            end.record()
            torch.cuda.synchronize(device)
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                out = serve_queue()
            seconds = time.perf_counter() - t0

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
        "scoring": "fused_soft" if args.fused_scoring else "cnn",
        "sampling": "two_phase" if args.two_phase else "fixed_t_fused",
        "batch": B, "queue": Q, "verify_topk": args.verify_topk,
        "attempts": args.attempts, "reps": args.reps,
        "frames": args.synthetic,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "launches": {name: fn.launches for name, fn in KERNELS.items()},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
