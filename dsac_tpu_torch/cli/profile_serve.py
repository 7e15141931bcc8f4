"""Where the serve time goes on the card, for one batch of 8 frames at
the bench configuration (256 hypotheses, 16 attempts, verify_topk 4).

Measures, after two warm-up batches:

* the batch time (CUDA events over ``--steps`` batches),
* the coordinate CNN alone on the same batch (CUDA events), with its
  achieved rate from its FLOP count,
* a ``torch.profiler`` window over ``--steps`` batches: device time by
  kernel, the three CUDA kernels' share, device kernels launched per
  batch, and the device's idle share: of the batch time, and of the
  profiled window's host wall time (which the profiler lengthens).

Prints one JSON line (and writes it to ``--out`` when given).

    python -m dsac_tpu_torch.cli.profile_serve --steps 8
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from dsac_tpu_torch.cli import serve
from dsac_tpu_torch.utils.timing import (device_us, events_ms,
                                        is_device_event, profile)

BATCH = 8  # frames per batch at the bench config
KERNEL_NAMES = {"p3p": "p3p_kernel", "soft_inlier_score": "score_kernel",
                "refine_irls": "refine_kernel"}  # name -> CUDA symbol


def coord_net_flops(height: int, width: int, spec) -> int:
    """Multiply-adds x 2 of DenseCoordNet's convolutions at one frame."""
    flops, cin, h, w = 0, 3, height, width
    for cout, k, s in spec:
        h, w = -(-h // s), -(-w // s)
        flops += 2 * h * w * k * k * cin * cout
        cin = cout
    return flops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8,
                    help="batches timed, and batches profiled")
    ap.add_argument("--out", default=None, help="also write the line here")
    args = ap.parse_args(argv)
    st = serve.stage(serve.parse_args([
        "--synthetic", str(BATCH), "--batch", str(BATCH), "--queue", "1",
        "--device", "cuda"]))
    imgs = st.images[0]
    B, H, W = imgs.shape[:3]

    with torch.no_grad():
        for _ in range(2):
            st.serve_batch(imgs)
        torch.cuda.synchronize()
        batch_ms = events_ms(lambda: st.serve_batch(imgs), args.steps)
        cnn_ms = events_ms(lambda: st.net(imgs), args.steps)

        prof, wall_us = profile(lambda: st.serve_batch(imgs), args.steps)

    rows = [e for e in prof.key_averages()
            if is_device_event(e) and device_us(e) > 0]
    rows.sort(key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in rows)
    ours = {k: sum(device_us(e) for e in rows if v in e.key) / args.steps
            / 1e3 for k, v in KERNEL_NAMES.items()}
    flops = coord_net_flops(H, W, st.net.spec) * B
    result = {
        "metric": "serve_batch_breakdown",
        "device": torch.cuda.get_device_name(0),
        "batch": B, "steps": args.steps,
        "batch_ms": batch_ms,
        "reloc_per_s": B / batch_ms * 1e3,
        "cnn_ms": cnn_ms,
        "cnn_tflop_per_s": flops / cnn_ms / 1e9,
        "cnn_gflop_per_frame": flops / B / 1e9,
        "kernel_ms": ours,
        "device_busy_ms_per_batch": busy_us / args.steps / 1e3,
        "host_wall_ms_per_batch": wall_us / args.steps / 1e3,
        "device_idle_share": 1.0 - busy_us / args.steps / 1e3 / batch_ms,
        "device_idle_share_profiled": 1.0 - busy_us / wall_us,
        "device_kernels_per_batch": sum(e.count for e in rows) / args.steps,
        "top_device_ms_per_batch": [
            [e.key[:80], device_us(e) / args.steps / 1e3, e.count
             // args.steps] for e in rows[:15]],
    }
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return result


if __name__ == "__main__":
    main()
