"""Evaluation over the fixture frames (port of dsac_tpu/cli/test_ransac.py,
single device, without ``--mesh``).

Renders ``--synthetic N`` frames of the default room at the bench poses
(data/room_default.json, the ground truth) and runs the reference's
test_ransac forward pass on each frame: DenseCoordNet (``--weights``) ->
fixed-T sampling of 256 hypotheses with 16 attempts, every attempt
polished by the PyTorch P3P solver -> the diff-map kernel and the
score CNN (``--score-weights``) -> refinement of the whole pool (one
launch of the refine kernel with ``--fused-refine``, else the PyTorch
IRLS) -> the winner: drawn from the score softmax (``--rdraw 1``) or its
argmax (``--rdraw 0``), or with ``--select inlier`` the refined
hypothesis with the largest inlier count.  Frame i draws from a generator
seeded with ``--seed * 131 + i``, as the reference keys it.

``--check-refine`` (with ``--fused-refine``) also refines each pool with
``refine_pose_fused_steps`` (one launch of the IRLS-statistics kernel per
step) and reports, over the frames, the largest gap to the single-launch
refine kernel at the served hypothesis.

Prints one JSON line: the reference's summary (accuracy at 5 cm / 5 deg,
median errors, mean and spread of the expected loss and of the entropy),
each kernel's launch count, and the seconds the frames took (rendering
included, the model's loading not).

    python -m dsac_tpu_torch.cli.test_ransac --synthetic 64 --fused-refine
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from dsac_tpu_torch import resolve_device
from dsac_tpu_torch.cli.serve import KERNELS
from dsac_tpu_torch.config import DataConfig, DSACConfig, PoseConfig
from dsac_tpu_torch.data.synthetic import SyntheticScene
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.models.coord_net import gather_dense_coords
from dsac_tpu_torch.ops.gn_cuda import refine_pose_fused_steps
from dsac_tpu_torch.pipeline import (evaluate_frame, process_frames_batched,
                                     summarize, verified_selection)
from dsac_tpu_torch.utils.params_io import (load_coord_net_npz,
                                            load_score_net_npz)

REPO = Path(__file__).resolve().parents[2]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic", type=int, default=64,
                    help="fixture frames to evaluate (at most 64)")
    ap.add_argument("--fused-refine", action="store_true",
                    help="refine the pool with the fused refine kernel "
                         "(one launch a frame); default: the PyTorch IRLS")
    ap.add_argument("--select", choices=["score", "inlier"], default="score",
                    help="winner: the pre-refinement score draw or argmax, "
                         "or the largest post-refinement inlier count")
    ap.add_argument("--rdraw", type=int, choices=[0, 1], default=1,
                    help="1: draw the winner from the score softmax; "
                         "0: argmax (PoseConfig.random_draw)")
    ap.add_argument("--check-refine", action="store_true",
                    help="with --fused-refine: also refine each pool "
                         "stepwise and report the gap")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weights", default=str(REPO / "artifacts" /
                                             "coord_e2e.npz"))
    ap.add_argument("--score-weights", default=str(REPO / "artifacts" /
                                                   "score_e2e.npz"))
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


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


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.check_refine and not args.fused_refine:
        raise SystemExit("--check-refine needs --fused-refine")
    device = resolve_device(args.device)
    data = DataConfig()
    scene = SyntheticScene(data.image_width, data.image_height,
                           data.focal_length, device=device)
    n_poses = scene.bench_poses.t.shape[0]
    if not 1 <= args.synthetic <= n_poses:
        raise SystemExit(f"--synthetic must be in 1..{n_poses}")
    cam = data.camera()
    cfg = DSACConfig(data=data, pose=PoseConfig(
        num_hypotheses=256, random_draw=bool(args.rdraw)))
    p = cfg.pose
    net = load_coord_net_npz(args.weights, device)
    score_net = load_score_net_npz(args.score_weights, device)

    def coord_fn(imgs, pix):
        return gather_dense_coords(net(imgs), pix, stride=8)

    rots, trans, exps, ents, winners, checks = [], [], [], [], [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(args.synthetic):
            gt = Pose(scene.bench_poses.R[i:i + 1],
                      scene.bench_poses.t[i:i + 1])
            image = scene.render(gt)[0]
            gen = torch.Generator(device=device).manual_seed(
                args.seed * 131 + i)
            res = process_frames_batched(
                image, coord_fn, cam, cfg, generator=gen, scoring="cnn",
                score_fn=score_net, sampling=False, refine_all=True,
                fused_refine=args.fused_refine)
            if args.select == "inlier":
                res = verified_selection(res)
            ev = evaluate_frame(res, gt)
            rots.append(float(ev.rot_err_deg[0]))
            trans.append(float(ev.trans_err_mm[0]))
            exps.append(float(ev.expected_loss[0]))
            ents.append(float(ev.entropy[0]))
            winners.append(float(ev.losses[0, int(res.chosen[0])]))
            if args.check_refine:
                checks.append(check_refine(res, cam, p))

    seconds = time.perf_counter() - t0  # each frame ends in a host read
    stats = summarize(np.asarray(rots), np.asarray(trans), np.asarray(exps),
                      np.asarray(ents))
    result = {
        "metric": "test_ransac",
        **stats,
        "mean_winner_loss": float(np.mean(winners)),
        "all_finite": bool(np.isfinite([rots, trans, exps, ents]).all()),
        "select": args.select, "rdraw": args.rdraw,
        "fused_refine": args.fused_refine,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "launches": {name: fn.launches for name, fn in KERNELS.items()},
        "seconds": seconds,
    }
    if args.check_refine:
        result["refine_check"] = {
            "served_max_abs_dt_mm": max(c[0] for c in checks),
            "served_max_abs_dR": max(c[1] for c in checks)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
