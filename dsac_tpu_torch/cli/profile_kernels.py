"""Device time of the refine, P3P, score, diff-map and IRLS-stats kernels
at every shape the main path gives them (utils/kernel_problems.py:
REFINE_REGIMES, P3P_SHAPES, SCORE_SHAPES, DIFFMAP_SHAPES,
IRLS_STATS_SHAPES), through the wrappers the main path calls
(``refine_pose_fused``, ``p3p_solve``, ``soft_inlier_scores``,
``diffmaps``, ``irls_stats``), so in the layouts that
``ops/gn_cuda.py:refine_layout`` / ``irls_stats_layout``,
``ops/p3p_cuda.py:p3p_layout`` and ``ops/diffmap_cuda.py:score_layout`` /
``diffmap_layout`` choose; with ``--sweep``, in every legal layout too,
each held against the plain version.

    python -m dsac_tpu_torch.cli.profile_kernels
    python -m dsac_tpu_torch.cli.profile_kernels --sweep --kernels irls_stats

Without ``--sweep`` it uses nothing but those wrappers, the problem
generators and the timers, so it times an older checkout of the port the
same way once this file, ``utils/kernel_problems.py`` and
``utils/timing.py`` are copied into it.

Refine regimes, 16 IRLS steps against N = 1,600 pixels a frame:

  softam_forward   B=1 P=1    SoftAM's averaged pose
  softam_backward  B=1 P=12   the 12 probes of its init-pose backward
  serve_top4       B=8 P=4    the verified top 4 of a serve batch
  test_ransac      B=1 P=256  refine-all of one frame; a DSAC round
  refine_all       B=8 P=256  refine-all of 8 frames

P3P shapes: 2,048 lanes (a serve batch's first sampling phase, 8 x 256),
3,840 (its second phase, 8 x 32 x 15) and 32,768 (fixed-T sampling of a
serve batch, 8 x 256 x 16).

Score shapes, P3P hypotheses against N = 1,600 pixels a frame: B=8 H=256
(a fused-soft serve batch) and B=8 H=4,096 (the large-H regime).
Diff-map shapes: B=8 H=256 (a score-CNN or fixed-T serve batch) and B=1
H=256 (a test_ransac frame).  IRLS-stats shapes, P3P hypotheses against
N = 1,600 pixels a frame: B=1 P=256 (a pass of the stepwise refiner,
which test_ransac --check-refine runs 16 times a frame; its row also
times that refiner, 16 passes and their PyTorch solves, as
``stepwise_refiner_ms``: host-bound, and slowed by an earlier
torch.profiler session in the process, so it is comparable between runs
of ``--kernels irls_stats`` alone) and B=8 P=256.

Times: ``queued_ms`` (CUDA events around 20 calls queued behind a sleep
kernel, median of 5) and ``device_ms`` (torch.profiler, the kernel's own
time).  Prints one JSON line per regime and shape, and writes them all to
``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.ops.diffmap_cuda import diffmaps, soft_inlier_scores
from dsac_tpu_torch.ops.gn_cuda import (irls_stats, refine_pose_fused,
                                        refine_pose_fused_steps)
from dsac_tpu_torch.ops.p3p_cuda import p3p_solve
from dsac_tpu_torch.utils.kernel_problems import (DIFFMAP_SHAPES, FRAMES,
                                                  HYPS, IRLS_BARS,
                                                  IRLS_STATS_SHAPES, N,
                                                  P3P_SHAPES,
                                                  REFINE_REGIMES,
                                                  SCORE_SHAPES, STEPS,
                                                  attempt_sets,
                                                  hypothesis_pool,
                                                  make_problem, regime_poses)
from dsac_tpu_torch.utils.timing import events_ms, profiled_ms, queued_ms

# refine_pose_fused's defaults (the serve config), for launch_refine
REFINE_KW = dict(threshold=10.0, beta=1.0, min_inliers=50.0, damping=1e-4,
                 max_error=100.0)


def sweep_refine_layouts() -> list:
    """Every cluster (up to 8) with one pose a CTA, and every power-of-two
    split of 8 warps, or fewer, into poses and warps without a cluster."""
    from dsac_tpu_torch.ops.gn_cuda import RefineLayout
    out = [RefineLayout(c, 1, w) for c in (2, 4, 8) for w in (2, 4, 8)]
    out += [RefineLayout(1, g, w) for g in (1, 2, 4, 8) for w in (1, 2, 4, 8)
            if g * w <= 8]
    return out


def refine_errors(got, n_got, want, n_want) -> dict:
    return {"max_abs_dt_mm": float((got.t - want.t).abs().max()),
            "max_abs_dR": float((got.R - want.R).abs().max()),
            "max_abs_dn_in": float((n_got - n_want).abs().max())}


def sweep_refine(dev, poses: Pose, coords, pix, cam) -> dict:
    """The layout refine_layout picks for this regime, and every legal
    layout timed and held against the plain version, fastest first."""
    from dsac_tpu_torch.ops import _build
    from dsac_tpu_torch.ops.gn_cuda import (check_refine_layout,
                                            launch_refine, refine_layout,
                                            refine_pose_fused_ref)
    B, P = poses.t.shape[:2]
    want, n_want = refine_pose_fused_ref(poses, coords, pix, cam)

    def run(lay):
        return launch_refine(poses.R, poses.t, coords, pix, cam, STEPS,
                             layout=lay, **REFINE_KW)

    cands = []
    for lay in sweep_refine_layouts():
        try:
            check_refine_layout(lay, N)
        except ValueError:
            continue
        cands.append({"layout": list(lay),
                      "queued_ms": queued_ms(lambda: run(lay)),
                      **refine_errors(*run(lay), want, n_want)})
    return {"layout": list(refine_layout(B * P, P, N, _build.sm_count(dev))),
            "candidates": sorted(cands, key=lambda r: r["queued_ms"])}


def sweep_p3p(dev, obj, img, cam) -> dict:
    """The layout p3p_layout picks for this shape, and every threads-a-lane
    and block size timed and held against the plain version, fastest
    first."""
    from dsac_tpu_torch.ops import _build
    from dsac_tpu_torch.ops.p3p_cuda import (P3PLayout, launch_p3p,
                                             p3p_layout, p3p_solve_ref)
    rp, rv, rw = p3p_solve_ref(obj, img, cam)
    rc = rv & (rw < 10.0)
    cands = []
    for tpl in (1, 4):
        for block in (32, 64, 128, 256):
            lay = P3PLayout(tpl, block)
            kp, kv, kw = launch_p3p(obj, img, cam, lay)
            kc = kv & (kw < 10.0)
            dR = (kp.R - rp.R).abs().flatten(1).amax(1)[kc & rc]
            cands.append({
                "layout": list(lay),
                "queued_ms": queued_ms(lambda: launch_p3p(obj, img, cam,
                                                          lay)),
                "decision_agreement": float((kc == rc).float().mean()),
                "median_abs_dR": float(dR.median()),
                "finite": bool(torch.isfinite(kp.R).all()
                               and torch.isfinite(kw).all())})
    return {"layout": list(p3p_layout(obj.shape[0], _build.sm_count(dev))),
            "candidates": sorted(cands, key=lambda r: r["queued_ms"])}


def sweep_score_layouts(N: int) -> list:
    """Every power-of-two split of 4 to 32 warps into hypotheses and warps
    (at most 8) a hypothesis, with the whole frame staged at once and in
    tiles of 256 pixels."""
    from dsac_tpu_torch.ops.diffmap_cuda import SCORE_TILES, ScoreLayout
    return [ScoreLayout(g, w, tile) for tile in SCORE_TILES
            for g in (1, 2, 4, 8, 16, 32) for w in (1, 2, 4, 8)
            if 4 <= g * w <= 32]


def sweep_diffmap_layouts(N: int) -> list:
    """Every power of two from 1 to 16 hypotheses a CTA, CTAs of 64 to 512
    threads, 4 pixels a thread (where N % 4 == 0) and 1."""
    from dsac_tpu_torch.ops.diffmap_cuda import DiffmapLayout
    return [DiffmapLayout(g, threads, vec)
            for vec in ((4, 1) if N % 4 == 0 else (1,))
            for g in (1, 2, 4, 8, 16) for threads in (64, 128, 256, 512)]


def sweep_score(dev, poses: Pose, coords, pix, cam) -> dict:
    """The layout score_layout picks for this shape, and every layout of
    the sweep timed and held against the plain version (max abs error;
    two launches bit-identical), fastest first."""
    from dsac_tpu_torch.ops import _build
    from dsac_tpu_torch.ops.diffmap_cuda import (launch_score, score_layout,
                                                 soft_inlier_scores_ref)
    B, H = poses.t.shape[:2]
    want = soft_inlier_scores_ref(poses.R, poses.t, coords, pix, cam)

    def run(lay):
        return launch_score(poses.R, poses.t, coords, pix, cam, layout=lay)

    cands = []
    for lay in sweep_score_layouts(N):
        got = run(lay)
        cands.append({"layout": list(lay),
                      "queued_ms": queued_ms(lambda: run(lay)),
                      "max_abs_err": float((got - want).abs().max()),
                      "deterministic": bool(torch.equal(got, run(lay)))})
    return {"layout": list(score_layout(B, H, N, _build.sm_count(dev))),
            "candidates": sorted(cands, key=lambda r: r["queued_ms"])}


def sweep_diffmap(dev, poses: Pose, coords, pix, cam) -> dict:
    """The layout diffmap_layout picks for this shape, and every layout of
    the sweep timed and held against the plain version: its max abs error
    and the elements on which it and the plain version miss rtol 1e-4,
    atol 1e-2 against the plain version in f64; fastest first."""
    from dsac_tpu_torch.ops import _build
    from dsac_tpu_torch.ops.diffmap_cuda import (diffmap_layout,
                                                 diffmaps_ref,
                                                 launch_diffmap)
    B, H = poses.t.shape[:2]
    args = (poses.R, poses.t, coords, pix)
    want = diffmaps_ref(*args, cam)
    want64 = diffmaps_ref(*(a.double() for a in args), cam)

    def misses(x):
        return int(((x.double() - want64).abs()
                    > 1e-2 + 1e-4 * want64.abs()).sum())

    cands = []
    for lay in sweep_diffmap_layouts(N):
        got = launch_diffmap(*args, cam, layout=lay)
        cands.append({"layout": list(lay),
                      "queued_ms": queued_ms(
                          lambda: launch_diffmap(*args, cam, layout=lay)),
                      "max_abs_err": float((got - want).abs().max()),
                      "misses_vs_f64": misses(got)})
    return {"layout": list(diffmap_layout(B, H, N, _build.sm_count(dev))),
            "plain_misses_vs_f64": misses(want),
            "candidates": sorted(cands, key=lambda r: r["queued_ms"])}


def sweep_irls_stats(dev, poses: Pose, coords, pix, cam) -> dict:
    """The layout irls_stats_layout picks for this shape, and every legal
    layout of the refine sweep timed and held against the plain version:
    per part its max abs error and the elements on which it and the plain
    version miss the part's bar against the plain version in f64; two
    launches bit-identical; and the refine kernel's n_in after one step in
    the same layout equal to the pass's inlier mass bit for bit; fastest
    first."""
    from dsac_tpu_torch.ops import _build
    from dsac_tpu_torch.ops.gn_cuda import (check_irls_stats_layout,
                                            irls_stats_layout, irls_stats_ref,
                                            launch_irls_stats, launch_refine,
                                            unpack_stats)
    B, P = poses.t.shape[:2]
    args = (poses.R, poses.t, coords, pix)
    want = unpack_stats(irls_stats_ref(*args, cam))
    want64 = unpack_stats(irls_stats_ref(*(a.double() for a in args), cam))

    def compare(stats) -> dict:
        got = unpack_stats(stats)
        out = {}
        for (q, rtol, atol), g, w, w64 in zip(IRLS_BARS, got, want, want64):
            out[f"{q}_max_abs_err"] = float((g - w).abs().max())
            out[f"{q}_misses_vs_f64"] = int(
                ((g.double() - w64).abs() > atol + rtol * w64.abs()).sum())
        return out

    def run(lay):
        return launch_irls_stats(*args, cam, layout=lay)

    cands = []
    for lay in sweep_refine_layouts():
        try:
            check_irls_stats_layout(lay, N)
        except ValueError:
            continue
        got = run(lay)
        _, n_one = launch_refine(*args, cam, 1, layout=lay, **REFINE_KW)
        cands.append({"layout": list(lay),
                      "queued_ms": queued_ms(lambda: run(lay)),
                      **compare(got),
                      "bit_identical_relaunch": bool(torch.equal(
                          got, run(lay))),
                      "refine_step_n_in_identical": bool(torch.equal(
                          n_one, got[..., 27]))})
    plain = compare(irls_stats_ref(*args, cam))
    return {"layout": list(irls_stats_layout(B * P, P, N,
                                             _build.sm_count(dev))),
            "plain_misses_vs_f64": {k: v for k, v in plain.items()
                                    if "misses" in k},
            "candidates": sorted(cands, key=lambda r: r["queued_ms"])}


def irls_stats_shapes(dev, gen, cam, coords, pix, pool, args) -> list:
    """Each shape (frames, poses a frame) of the IRLS-stats kernel, on the
    first frames of the P3P pool: ``irls_stats`` timed, at one frame the
    stepwise refiner too, and with ``--sweep`` every layout."""
    rows = []
    for name, (B, P) in IRLS_STATS_SHAPES.items():
        poses = Pose(pool.R[:B, :P].contiguous(), pool.t[:B, :P].contiguous())
        c, x = coords[:B].contiguous(), pix[:B].contiguous()

        def call():
            return irls_stats(poses.R, poses.t, c, x, cam)

        row = {"shape": name, "B": B, "P": P, "N": N}
        if B == 1:  # host-bound: timed before the profiler runs here
            row["stepwise_refiner_ms"] = events_ms(
                lambda: refine_pose_fused_steps(poses, c, x, cam,
                                                steps=STEPS), 1, 10)
        row.update(queued_ms=queued_ms(call),
                   device_ms=profiled_ms(call, 20, "irls_stats_kernel"))
        if args.sweep:
            row.update(sweep_irls_stats(dev, poses, c, x, cam))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def scoring_shapes(shapes: dict, wrapper, symbol: str, sweep, dev, gen,
                   cam, coords, pix, args) -> list:
    """Each shape (frames, hypotheses) of the score or diff-map kernel, on
    a pool of P3P hypotheses: ``wrapper`` timed, and with ``--sweep`` every
    layout (``sweep``)."""
    rows = []
    for name, (B, H) in shapes.items():
        c, x = coords[:B].contiguous(), pix[:B].contiguous()
        poses = hypothesis_pool(c, x, H, cam, gen)

        def call():
            return wrapper(poses.R, poses.t, c, x, cam)

        row = {"shape": name, "B": B, "H": H, "N": N,
               "queued_ms": queued_ms(call),
               "device_ms": profiled_ms(call, 20, symbol)}
        if args.sweep:
            row.update(sweep(dev, poses, c, x, cam))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def refine_regimes(dev, gen, cam, gt, coords, pix, pool, args) -> list:
    rows = []
    for name, (B, P) in REFINE_REGIMES.items():
        poses = regime_poses(name, gt, pool, gen)
        c, x = coords[:B].contiguous(), pix[:B].contiguous()

        def refine():
            return refine_pose_fused(poses, c, x, cam)

        row = {"regime": name, "B": B, "P": P, "N": N, "steps": STEPS,
               "queued_ms": queued_ms(refine),
               "device_ms": profiled_ms(refine, 20, "refine_kernel")}
        if args.sweep:
            row.update(sweep_refine(dev, poses, c, x, cam))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def p3p_shapes(dev, gen, cam, coords, pix, args) -> list:
    rows = []
    for name, lanes in P3P_SHAPES.items():
        obj, img = attempt_sets(coords, pix, lanes, gen)

        def solve():
            return p3p_solve(obj, img, cam)

        row = {"shape": name, "lanes": obj.shape[0],
               "queued_ms": queued_ms(solve),
               "device_ms": profiled_ms(solve, 20, "p3p_kernel")}
        if args.sweep:
            row.update(sweep_p3p(dev, obj, img, cam))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time (and check) every legal layout")
    ap.add_argument("--kernels",
                    default="refine,p3p,score,diffmap,irls_stats",
                    help="comma-separated kernels to time (default: all)")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1305)
    cam, gt, coords, pix = make_problem(FRAMES, N, dev, gen)
    pool = hypothesis_pool(coords, pix, HYPS, cam, gen)
    result = {"device": torch.cuda.get_device_name(0)}
    if "refine" in kernels:
        result["refine"] = refine_regimes(dev, gen, cam, gt, coords, pix,
                                          pool, args)
    if "p3p" in kernels:
        result["p3p"] = p3p_shapes(dev, gen, cam, coords, pix, args)
    if "score" in kernels:
        result["score"] = scoring_shapes(
            SCORE_SHAPES, soft_inlier_scores, "score_kernel", sweep_score,
            dev, gen, cam, coords, pix, args)
    if "diffmap" in kernels:
        result["diffmap"] = scoring_shapes(
            DIFFMAP_SHAPES, diffmaps, "diffmap_kernel", sweep_diffmap, dev,
            gen, cam, coords, pix, args)
    if "irls_stats" in kernels:
        result["irls_stats"] = irls_stats_shapes(dev, gen, cam, coords, pix,
                                                 pool, args)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
