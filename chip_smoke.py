#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dsac_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (flushed, so a run that is cut shows where it
stopped):

1. device   the card, and its name and power limit from nvidia-smi;
2. build    nvcc builds dsac_tpu_torch/csrc/*.cu into one library;
3. kernels  each CUDA kernel against its plain PyTorch version on the
            card, at the serve shapes of a batch of 8 frames, with its
            bar; `ms` and `plain_ms` are medians of 20 CUDA-event timings
            (of 10 back-to-back kernel calls, of 1 plain call),
            `device_ms` the kernel's own device time from torch.profiler;
4. serve    dsac_tpu_torch.cli.serve.main on the 64 fixture frames
            (queue 8 x batch 8, verify_topk 4, 16 attempts) with the
            trained weights of artifacts/coord_e2e.npz; the kernels'
            launch counters are set to 0 just before and read just after.

Then nvidia-smi's line, one JSON line of per-kernel numbers, and the last
line {"ok": true, "device": {...}}.  Any failed bar or error exits
non-zero before that last line.  Without a CUDA device, or without the
repository around this file, it fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# Peaks of one H100 SXM (NVIDIA data sheet): device memory rate and f32
# rate outside the tensor cores.  All three kernels do f32 arithmetic.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# f32 operations (add, mul, div, sqrt, compare, select, transcendental:
# one each) counted from the kernels' sources; the head of each
# dsac_tpu_torch/csrc/*.cu states the same count with its breakdown.
P3P_OPS_PER_LANE = 1500
SCORE_OPS_PER_PAIR = 42
REFINE_OPS_PER_PIXEL_STEP = 194
REFINE_OPS_PER_SOLVE = 400

SAMPLES = 20  # CUDA-event timings per median

B, H, N, K, T, TOPK = 8, 256, 1600, 32, 16, 4  # serve shapes per batch


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_problem(dev, gen):
    """B frames of N scene coordinates seen from known poses: 4 mm noise
    and 30% uniform outliers, pixels where the true points project."""
    import torch
    from dsac_tpu_torch.config import Camera
    from dsac_tpu_torch.geometry.pose import Pose, invert, transform
    from dsac_tpu_torch.geometry.projection import project
    from dsac_tpu_torch.geometry.rotation import so3_exp

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    cam = Camera.make(525.0, 640, 480)
    gt = Pose(so3_exp(randn(B, 3) * 0.4),
              randn(B, 3) * 200.0 + torch.tensor([0.0, 0.0, -2500.0],
                                                 device=dev))
    eye = torch.stack([(rand(B, N) * 2 - 1) * 1200, (rand(B, N) * 2 - 1) * 900,
                       -(1500 + rand(B, N) * 2000)], dim=-1)
    ident = Pose(torch.eye(3, device=dev).expand(B, 3, 3),
                 torch.zeros(B, 3, device=dev))
    pix = project(ident, eye, cam).contiguous()
    coords = transform(invert(gt), eye) + randn(B, N, 3) * 4.0
    outlier = rand(B, N) < 0.3
    coords = torch.where(outlier[..., None],
                         (rand(B, N, 3) * 2 - 1) * 3000.0, coords)
    return cam, gt, coords.contiguous(), pix


def check_kernels(dev) -> tuple[list[dict], list[str]]:
    import torch
    from dsac_tpu_torch.utils.timing import events_ms, profiled_ms
    from dsac_tpu_torch.geometry.pose import Pose
    from dsac_tpu_torch.geometry.rotation import so3_exp
    from dsac_tpu_torch.ops.diffmap_cuda import (soft_inlier_scores,
                                                 soft_inlier_scores_ref)
    from dsac_tpu_torch.ops.gn_cuda import refine_pose_fused, refine_pose_ref
    from dsac_tpu_torch.ops.p3p_cuda import p3p_solve, p3p_solve_ref
    from dsac_tpu_torch.ops.sampling import gather_rows

    gen = torch.Generator(device=dev).manual_seed(1305)
    cam, gt, coords, pix = make_problem(dev, gen)
    rows, failures = [], []

    # ---- P3P at both sampling shapes: B*H (phase 1), B*K*(T-1) ----
    agree, dR_med, dR_max = [], [], []
    ms = plain_ms = n_bytes = n_ops = 0.0
    dev_times = []
    pools = {}
    for lanes in (H, K * (T - 1)):
        idx = torch.randint(0, N, (B, lanes, 4), generator=gen, device=dev)
        obj = gather_rows(coords, idx).reshape(-1, 4, 3).contiguous()
        img = gather_rows(pix, idx).reshape(-1, 4, 2).contiguous()
        kp, kv, kw = p3p_solve(obj, img, cam)
        rp, rv, rw = p3p_solve_ref(obj, img, cam)
        kc, rc = kv & (kw < 10.0), rv & (rw < 10.0)
        both = kc & rc
        dR = (kp.R - rp.R).abs().flatten(1).amax(1)[both]
        agree.append(float((kc == rc).float().mean()))
        dR_med.append(float(dR.median()) if dR.numel() else 0.0)
        dR_max.append(float(dR.max()) if dR.numel() else 0.0)
        finite = all(bool(torch.isfinite(x).all()) for x in (kp.R, kp.t, kw))
        if not finite:
            failures.append(f"p3p: non-finite output at {lanes} lanes")
        if float(kc.float().mean()) < 0.05 or bool(kc.all()):
            failures.append(f"p3p: pool of {lanes} lanes lacks valid and "
                            "invalid lanes")
        ms += events_ms(lambda: p3p_solve(obj, img, cam), 10, SAMPLES)
        dev_times.append(profiled_ms(lambda: p3p_solve(obj, img, cam), 20,
                             "p3p_kernel"))
        plain_ms += events_ms(lambda: p3p_solve_ref(obj, img, cam), 1,
                              SAMPLES)
        M = obj.shape[0]
        n_bytes += M * ((12 + 8) * 4 + (9 + 3 + 1) * 4 + 1)
        n_ops += M * P3P_OPS_PER_LANE
        pools[lanes] = (kp, kv & (kw < 10.0))
    if min(agree) < 0.98:
        failures.append(f"p3p: decision agreement {min(agree)} < 0.98")
    if max(dR_med) >= 1e-3:
        failures.append(f"p3p: median |dR| {max(dR_med)} >= 1e-3")
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    rows.append({"name": "p3p", "route": "cuda",
                 "source": "dsac_tpu_torch/csrc/p3p.cu",
                 "replaces": "dsac_tpu/ops/p3p_pallas.py:61",
                 "max_abs_err": max(dR_max), "decision_agreement": min(agree),
                 "median_abs_dR": max(dR_med),
                 "bar": "decision agreement >= 0.98, median |dR| < 1e-3",
                 "shapes": f"{B * H} + {B * K * (T - 1)} lanes",
                 "ms": ms, "device_ms": (None if None in dev_times
                               else sum(dev_times)),
                 "plain_ms": plain_ms,
                 "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None})

    # ---- score: the phase-1 pool, B x H hypotheses x N pixels ----
    hyp = pools[H][0]
    R = hyp.R.reshape(B, H, 3, 3).contiguous()
    t = hyp.t.reshape(B, H, 3).contiguous()
    def score():
        return soft_inlier_scores(R, t, coords, pix, cam)

    ks = score()
    rs = soft_inlier_scores_ref(R, t, coords, pix, cam)
    err = float((ks - rs).abs().max())
    if not err <= 1e-3:
        failures.append(f"score: max abs error {err} > 1e-3")
    b_ms, b_by = bound_ms(B * H * 12 * 4 + B * N * 5 * 4 + B * H * 4,
                          B * H * N * SCORE_OPS_PER_PAIR)
    rows.append({"name": "soft_inlier_score", "route": "cuda",
                 "source": "dsac_tpu_torch/csrc/score.cu",
                 "replaces": "dsac_tpu/ops/diffmap_pallas.py:107",
                 "max_abs_err": err, "bar": "max abs error <= 1e-3",
                 "shapes": f"B={B} H={H} N={N}",
                 "ms": events_ms(score, 10, SAMPLES),
                 "device_ms": profiled_ms(score, 20, "score_kernel"),
                 "plain_ms": events_ms(lambda: soft_inlier_scores_ref(
                     R, t, coords, pix, cam), 1, SAMPLES),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # ---- refine: TOPK poses per frame near the known pose ----
    pert = so3_exp(torch.randn(B, TOPK, 3, generator=gen, device=dev) * 0.005)
    poses = Pose((pert @ gt.R[:, None]).contiguous(),
                 (gt.t[:, None] + torch.randn(B, TOPK, 3, generator=gen,
                                              device=dev) * 15.0).contiguous())
    def refine():
        return refine_pose_fused(poses, coords, pix, cam)

    kr, kn = refine()
    rr, rn = refine_pose_ref(poses, coords, pix, cam)
    dt = float((kr.t - rr.t).abs().max())
    dRr = float((kr.R - rr.R).abs().max())
    dn = float((kn - rn).abs().max())
    if not (dt <= 2.0 and dRr <= 1e-4 and dn <= 0.5):
        failures.append(f"refine: |dt| {dt} (bar 2 mm), |dR| {dRr} "
                        f"(bar 1e-4), |dn_in| {dn} (bar 0.5)")
    steps = 16
    b_ms, b_by = bound_ms(
        B * TOPK * 12 * 4 + B * N * 5 * 4 + B * TOPK * 13 * 4,
        B * TOPK * steps * (N * REFINE_OPS_PER_PIXEL_STEP
                            + REFINE_OPS_PER_SOLVE))
    rows.append({"name": "refine_irls", "route": "cuda",
                 "source": "dsac_tpu_torch/csrc/refine.cu",
                 "replaces": "dsac_tpu/ops/gn_pallas.py:236",
                 "max_abs_err": dt, "max_abs_dR": dRr, "max_abs_dn_in": dn,
                 "bar": "|dt| <= 2 mm, |dR| <= 1e-4, |dn_in| <= 0.5",
                 "shapes": f"B={B} P={TOPK} N={N} steps={steps}",
                 "ms": events_ms(refine, 10, SAMPLES),
                 "device_ms": profiled_ms(refine, 20, "refine_kernel"),
                 "plain_ms": events_ms(lambda: refine_pose_ref(
                     poses, coords, pix, cam), 1, SAMPLES),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return rows, failures


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port; absent when this file stands alone
    from dsac_tpu_torch.cli import serve
    from dsac_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    path, seconds = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": seconds, "library": path.name})

    t0 = time.perf_counter()
    rows, failures = check_kernels(dev)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "kernels": rows, "failures": failures,
          "check_launches": {name: fn.launches
                             for name, fn in serve.KERNELS.items()}})
    if failures:
        print("chip_smoke: kernel check failed: " + "; ".join(failures),
              file=sys.stderr)
        return 1

    for fn in serve.KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = serve.main(["--synthetic", "64", "--queue", "8", "--batch", "8",
                      "--verify-topk", "4", "--attempts", "16", "--reps", "3",
                      "--device", "cuda"])
    launches = {name: fn.launches for name, fn in serve.KERNELS.items()}
    emit({"phase": "serve", "seconds": time.perf_counter() - t0,
          "launches": launches})
    problems = [f"{name} kernel never launched" for name, n in
                launches.items() if n == 0]
    if not res["accuracy_5cm5deg"] >= 0.95:
        problems.append(f"accuracy {res['accuracy_5cm5deg']} < 0.95")
    if not res["poses_finite"]:
        problems.append("non-finite served pose")
    if problems:
        print("chip_smoke: serve failed: " + "; ".join(problems),
              file=sys.stderr)
        return 1

    for row in rows:
        row["launches"] = launches[row["name"]]
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
