"""Where the time goes on the card: for one serve batch of 8 frames at
the bench configuration (256 hypotheses, 16 attempts, verify_topk 4, or
with ``--softam`` the soft-argmax average refined), with fused
soft-inlier scoring or, with ``--no-fused-scoring``, the diff-map kernel
and the score CNN; or, with ``--train dsac|softam``, for
one end-to-end training round of ``train_ransac`` at the reference's
configuration (the coordinate net on 640x480, ScoreNet 1.0, 256
hypotheses of 16 attempts, refine mode ``implicit``) from the trained
weights of ``artifacts/``, on frame 0.  The frames are those of the
serve entry point: ``--scene``, ``--seed`` and ``--data`` (with the
reference's short flags and ``-c``) pick them, by default the bench
frames of the room (cli/common.py).  ``--arch`` picks the
coordinate net and its artifacts (cli/common.py); an arch without
committed weights (``dense_ctx``) runs a fresh init at ``--width-mult``
and, for serving, the soft-inlier head instead of a score CNN; for every
other arch a missing weight file is an error.

Measures, after two warm-up batches (rounds):

* the batch (round) time, CUDA events over ``--steps`` of them;
* serving: the coordinate stage alone on the same batch, the net and the
  gather at (or the patch extraction around) its 1,600 sampled pixels a
  frame (CUDA events), with its achieved rate from the net's FLOP count
  (a dense net's convolutions on the frames; the patch net's on the
  12,800 patches); with ``--no-fused-scoring`` the
  score CNN alone on the batch's (8 x 256, 40, 40) maps, likewise;
  training: the forward alone (the objective without its backward);
* a ``torch.profiler`` window over ``--steps`` of them: device time by
  kernel, the CUDA kernels' device time, device kernels launched per
  batch (round), and the device's idle share: of the batch (round) time,
  and of the profiled window's host wall time (which the profiler
  lengthens).

Prints one JSON line (and writes it to ``--out`` when given).

    python -m dsac_tpu_torch.cli.profile_serve --steps 8
    python -m dsac_tpu_torch.cli.profile_serve --steps 8 --no-fused-scoring
    python -m dsac_tpu_torch.cli.profile_serve --steps 8 --softam
    python -m dsac_tpu_torch.cli.profile_serve --steps 4 --train softam
    python -m dsac_tpu_torch.cli.profile_serve --steps 8 --arch patch
    python -m dsac_tpu_torch.cli.profile_serve --steps 8 --scene clutter
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from dsac_tpu_torch.cli import common, serve
from dsac_tpu_torch.flags import parse_with_flags
from dsac_tpu_torch.models.coord_net import PatchCoordNet
from dsac_tpu_torch.utils.timing import (device_us, events_ms,
                                        is_device_event, profile)

REPO = Path(__file__).resolve().parents[2]
BATCH = 8  # frames per batch at the bench config
KERNEL_NAMES = {"p3p": "p3p_kernel", "soft_inlier_score": "score_kernel",
                "refine_irls": "refine_kernel", "diffmap": "diffmap_kernel",
                "irls_stats": "irls_stats_kernel"}  # name -> CUDA symbol
UNTRAINED = "dense_ctx"  # the one arch without committed weights


def coord_net_flops(net, height: int, width: int, points: int) -> int:
    """Multiply-adds x 2 of a coordinate net on one frame: a dense net's
    convolutions on the (height, width) frame, or the patch net on the
    ``points`` patches."""
    if isinstance(net, PatchCoordNet):
        return net.flops_per_patch() * points
    return net.flops_per_frame(height, width)


def breakdown(fn, steps: int, unit: str, unit_ms: float) -> dict:
    """A torch.profiler window over ``steps`` calls of ``fn``, one
    ``unit`` (batch or round) each of ``unit_ms``: the CUDA kernels'
    device time, device busy time, kernels launched, idle shares and the
    top device kernels, per unit."""
    prof, wall_us = profile(fn, steps)
    rows = [e for e in prof.key_averages()
            if is_device_event(e) and device_us(e) > 0]
    rows.sort(key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in rows)
    return {
        "kernel_ms": {k: sum(device_us(e) for e in rows if v in e.key)
                      / steps / 1e3 for k, v in KERNEL_NAMES.items()},
        f"device_busy_ms_per_{unit}": busy_us / steps / 1e3,
        f"host_wall_ms_per_{unit}": wall_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / steps / 1e3 / unit_ms,
        "device_idle_share_profiled": 1.0 - busy_us / wall_us,
        f"device_kernels_per_{unit}": sum(e.count for e in rows) / steps,
        f"top_device_ms_per_{unit}": [
            [e.key[:80], device_us(e) / steps / 1e3, e.count // steps]
            for e in rows[:15]],
    }


def train_round(objective: str, steps: int, arch: str,
                width_mult: float, args) -> dict:
    """The breakdown of one training round (``--train``) on frame 0 of
    the frames of ``args`` (``--scene``, ``--seed``, ``--data`` and the
    short flags)."""
    from dsac_tpu_torch.models import ScoreNet, init_like_flax
    from dsac_tpu_torch.models.coord_net import make_coord_net
    from dsac_tpu_torch.pipeline.train import (e2e_expected_loss, e2e_step,
                                               make_e2e_state)
    from dsac_tpu_torch.utils.params_io import (load_coord_net_npz,
                                                load_score_net_npz)

    dev = torch.device("cuda")
    cfg = args.cfg
    cam = cfg.data.camera()
    source = common.frame_source(args, cfg, dev)
    image, gt = source.batch([0])
    suffix = common.ART_SUFFIX[arch]
    if arch == UNTRAINED:
        gen = torch.Generator().manual_seed(1)
        nets = (init_like_flax(make_coord_net(arch, width_mult), gen),
                init_like_flax(ScoreNet(width_mult), gen))
    else:
        nets = (load_coord_net_npz(REPO / "artifacts" /
                                   f"coord_e2e{suffix}.npz", dev, arch),
                load_score_net_npz(REPO / "artifacts" /
                                   f"score_e2e{suffix}.npz", dev))
    state = make_e2e_state(*(n.to(dev) for n in nets))
    gen = torch.Generator(device=dev).manual_seed(7)
    softam = objective == "softam"

    def round_():
        e2e_step(state, image, gt, cam, cfg, softam=softam,
                 refine_mode="implicit", generator=gen)

    def forward():
        with torch.no_grad():
            e2e_expected_loss(
                common.coord_fn_for(state.coord_net, cfg), state.score_net,
                image, gt, cam, cfg, softam=softam, refine_mode="implicit",
                generator=gen)

    for _ in range(2):
        round_()
    torch.cuda.synchronize()
    round_ms = events_ms(round_, steps)
    return {"metric": "train_round_breakdown", "objective": objective,
            "scene": source.name,
            "arch": arch, "coord_weights": "random" if arch == UNTRAINED
            else f"coord_e2e{suffix}",
            "round_ms": round_ms, "forward_ms": events_ms(forward, steps),
            **breakdown(round_, steps, "round", round_ms)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8,
                    help="batches (rounds) timed, and profiled")
    ap.add_argument("--out", default=None, help="also write the line here")
    ap.add_argument("--fused-scoring", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--softam", action="store_true",
                    help="serve the soft-argmax variant (its artifacts)")
    ap.add_argument("--train", choices=("dsac", "softam"), default=None,
                    help="profile a training round of this objective")
    common.add_arch_args(ap)
    common.add_data_args(ap, synthetic=BATCH, seed=0)
    args, args.cfg, _strings = parse_with_flags(ap, argv)
    if args.train:
        result = {"device": torch.cuda.get_device_name(0),
                  "steps": args.steps, **train_round(
                      args.train, args.steps, args.arch, args.width_mult,
                      args)}
    else:
        result = serve_batch(args)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return result


def serve_batch(args) -> dict:
    """The breakdown of one serve batch of the frames of ``args``."""
    fresh = args.arch == UNTRAINED
    if fresh:  # an empty run directory: a fresh init, the soft head
        empty = REPO / "runs" / "profile_serve_fresh"
        empty.mkdir(parents=True, exist_ok=True)
    st = serve.stage(serve.parse_args([
        "--synthetic", str(args.synthetic), "--batch", str(BATCH),
        "--queue", "1",
        "--device", "cuda", "--arch", args.arch,
        "--width-mult", str(args.width_mult), "--scene", args.scene,
        "--seed", str(args.seed)]
        + (["--data", args.data] if args.data else []) + args.flag_argv
        + ([] if args.fused_scoring else ["--no-fused-scoring"])
        + (["--softam"] if args.softam else [])
        + (["--out", str(empty)] if fresh else [])))
    imgs = st.images[0]
    B, H, W = imgs.shape[:3]

    with torch.no_grad():
        for _ in range(2):
            res = st.serve_batch(imgs)
        torch.cuda.synchronize()
        batch_ms = events_ms(lambda: st.serve_batch(imgs), args.steps)
        pix = res.sampling.reshape(B, -1, 2)
        cnn_ms = events_ms(lambda: st.coord_fn(imgs, pix), args.steps)
        score = {}
        if st.score_net is not None:
            maps = res.dmaps.reshape(-1, *res.dmaps.shape[2:]).contiguous()
            score_ms = events_ms(lambda: st.score_net(maps), args.steps)
            score_flops = st.score_net.flops_per_map(maps.shape[-1]) * \
                maps.shape[0]
            score = {"score_cnn_ms": score_ms,
                     "score_cnn_tflop_per_s": score_flops / score_ms / 1e9,
                     "score_cnn_gflop_per_batch": score_flops / 1e9,
                     "score_cnn_maps": maps.shape[0]}

        prof = breakdown(lambda: st.serve_batch(imgs), args.steps, "batch",
                         batch_ms)

    flops = coord_net_flops(st.net, H, W, pix.shape[1]) * B
    return {
        "metric": "serve_batch_breakdown",
        "device": torch.cuda.get_device_name(0),
        "scoring": "fused_soft" if args.fused_scoring else "cnn",
        "variant": "softam" if args.softam else "dsac",
        "scene": st.source.name,
        "frame_set": st.source.frame_set,
        "arch": args.arch, "coord_weights": "random" if fresh else
        f"coord_e2e{common.ART_SUFFIX[args.arch]}",
        "batch": B, "steps": args.steps,
        "batch_ms": batch_ms,
        "reloc_per_s": B / batch_ms * 1e3,
        "cnn_ms": cnn_ms,
        "cnn_tflop_per_s": flops / cnn_ms / 1e9,
        "cnn_gflop_per_frame": flops / B / 1e9,
        **score,
        **prof,
    }


if __name__ == "__main__":
    main()
