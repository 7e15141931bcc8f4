#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dsac_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (flushed, so a run that is cut shows where it
stopped):

1. device         the card, and its name and power limit from nvidia-smi;
2. build          nvcc builds dsac_tpu_torch/csrc/*.cu into one library,
                  with ptxas's registers, shared memory and spills per
                  kernel;
3. kernels        each CUDA kernel against its plain PyTorch version on the
                  card, at the shapes of a batch of 8 frames, with its bar;
                  the P3P kernel at each sampling shape (two-phase
                  sampling's two phases and fixed-T sampling, `by_shape`),
                  the score kernel at a serve batch and at H = 4,096 and
                  the diff-map kernel at a serve batch and a test_ransac
                  frame (`by_shape`; the score's two launches must be
                  bit-identical, and at H = 4,096, where f32 cannot meet
                  its bar in either version, it is held against the
                  plain version in f64, within a multiple of the plain
                  f32 version's own gap), the IRLS-stats kernel at a
                  test_ransac frame and a refine-all batch (`by_shape`;
                  two launches bit-identical, and the refine kernel's
                  n_in after one step in the same layout equal to the
                  inlier mass bit for bit), and the refine kernel at each
                  regime of the main path (utils/kernel_problems.py:
                  REFINE_REGIMES, `regimes`), each with the layout that
                  its layout function (ops/p3p_cuda.py:p3p_layout,
                  ops/diffmap_cuda.py:score_layout and diffmap_layout,
                  ops/gn_cuda.py:refine_layout and irls_stats_layout)
                  picks for it, its times and its bound;
                  `ms` and `plain_ms` are medians of 20 CUDA-event timings
                  (of 10 back-to-back kernel calls, of 1 plain call; the
                  plain refinement of 8 x 256 poses is timed once),
                  `device_ms` the kernel's own device time from
                  torch.profiler; and the stepwise refiner (one IRLS-stats
                  launch per step) against the refine kernel at the
                  refine-all shape (256 poses a frame), at the bars of
                  tests/test_gn_pallas.py:112-115;
4. serve          dsac_tpu_torch.cli.serve.main on the 64 fixture frames
                  (queue 8 x batch 8, verify_topk 4, 16 attempts,
                  two-phase sampling, fused soft-inlier scoring) with the
                  trained weights of artifacts/coord_e2e.npz;
5. serve_cnn      the same with --no-fused-scoring: the diff-map kernel
                  and the score CNN of artifacts/score_e2e.npz;
6. serve_fixed_t  --no-fused-scoring --no-two-phase, queue 2, one pass:
                  fixed-T sampling through the P3P kernel;
7. test_ransac    dsac_tpu_torch.cli.test_ransac on the 64 fixture frames
                  (--fused-refine --rdraw 0 --check-refine: the refine
                  kernel on all 256 hypotheses of each frame, and the
                  stepwise refiner beside it, which must agree with it at
                  the served hypothesis to 1e-2 mm and 1e-5), then once
                  more with --select inlier;
8. serve_softam   serve --softam on the 64 fixture frames, one timed pass:
                  the soft-argmax average of each frame's pool (two-phase
                  sampling, fused soft-inlier scoring) refined by one
                  launch of the refine kernel per batch (8 frames x 1
                  pose), with artifacts/coord_e2e_softam.npz;
9. serve_softam_cnn  the same with --no-fused-scoring: the diff-map
                  kernel and artifacts/score_e2e_softam.npz;
10. test_ransac_softam  test_ransac_softam on the 64 fixture frames
                  (--fused-refine --rdraw 0);
11. test_ransac_variants  test_ransac --fused-refine --rdraw 0 on 16
                  frames with --model none (the soft-inlier head on the
                  diff-maps), --refine-variant hard (refinement in
                  PyTorch) and --fused-scoring (the score kernel), each
                  with its counters set to 0; the last also exports its
                  poses, which are parsed back and held to the served
                  ones (1e-6, 1e-6 m);
12. train_grad    one rendered frame at full width (DenseCoordNet 64,
                  ScoreNet 1.0, H = 256, T = 16) with the trained weights
                  and the same draws: the DSAC objective's gradients in
                  refine mode "implicit" (the refine kernel) against
                  "unroll" (autograd through the PyTorch IRLS), and
                  SoftAM's "implicit" (with the kernel's init-pose
                  backward) against "implicit_jnp", at the bars of
                  tests/test_implicit_grad.py:224-260 and
                  tests/test_train.py:257-282 (DSAC's score gradient on
                  each of frames 0-3 where f32 resolves it, which its
                  f64 twin tells: train_grad says how); and the init-pose
                  backward against its plain version at SoftAM's
                  averaged pose of fixture frames 0-7, 16 steps
                  (softam_average_backward);
13. train_ransac  dsac_tpu_torch.cli.train_ransac, 8 rounds of end-to-end
                  DSAC training in refine mode "implicit" from the trained
                  weights, written as the port's obj_model_init and
                  score_model_init snapshots into a fresh runs/ directory;
14. train_ransac_softam  the same with the SoftAM objective;
15. serve_s2d     serve --arch dense_s2d on the 64 fixture frames (queue 8
                  x batch 8, fused soft, two-phase, verify_topk 4, one
                  timed pass) with artifacts/coord_e2e_s2d.npz;
16. serve_patch   the same with --arch patch: the patch net of
                  artifacts/coord_e2e_patch.npz on the 12,800 patches of a
                  batch;
17. serve_patch_cnn  --arch patch --no-fused-scoring: the diff-map kernel
                  and artifacts/score_e2e_patch.npz;
18. test_ransac_patch  test_ransac --arch patch --fused-refine --rdraw 0
                  on 16 frames: the diff-map and refine kernels once a
                  frame;
19. serve_ctx     serve --arch dense_ctx on 16 frames (queue 2 x batch 8)
                  with --out on an empty run directory: a fresh init of
                  width 64 (no weights are committed), so no accuracy bar:
                  every pose and score must be finite;
20. train_arch    2 rounds each of train_ransac --arch patch and --arch
                  dense_s2d (DSAC, refine mode "implicit"), from the
                  committed weights written as init snapshots: a finite
                  objective and gradient, one refine launch a round, and
                  the snapshots read back as nets of their arch;
21. scenes        each archetype of data/synthetic.py (room, repeat, bare,
                  noisy, clutter, hard) rendered on the card, the first 8
                  frames of seed 99 at full size: finite, RGB in [0, 255],
                  depth > 0 (but the reference's own degenerate rays), and
                  mean RGB, mean depth, the occluded and the gray share
                  against the reference's (data/scene_frames.json);
22. test_ransac_clutter  test_ransac --scene clutter --synthetic 24 --seed
                  99 --fused-refine --rdraw 0 with the committed clutter
                  weights, then with --select inlier;
23. test_ransac_noisy  the same with --scene noisy and the noisy weights;
24. test_ransac_repeat  --scene repeat --fused-scoring with
                  coord_e2e_repeat_t10b.npz and the soft-inlier head;
25. serve_scene   serve --scene clutter --synthetic 24 --seed 99 --queue 3
                  --batch 8 with the clutter weights (fused soft,
                  two-phase, verify_topk 4), and --no-fused-scoring;
26. data_7scenes  export_synthetic (8 training and 16 test frames of the
                  room) into a fresh runs/ directory, test_ransac --data
                  on its test split with -c DIR/default.config and the
                  room's weights, SevenScenesDataset.get_obj of 2 frames
                  against the render's coordinates, and the PNG decoder
                  that ran;
27. train_scene   2 rounds of train_ransac --scene clutter (DSAC, refine
                  mode "implicit") and of train_ransac_softam --scene
                  noisy, from the archetypes' weights as init snapshots.

The accuracy bars of phases 8-11 and 15-18 are the reference's accuracy
on the CPU on the same frames (REF_* below) less 2 of 64 frames or 1 of
16; those of phases 22-26 less 1 frame (REF_SCENE_ACCURACY).

The kernels phase also holds the refine kernel's init-pose backward
(ops/gn_cuda.py:InitSensitiveRefine, one launch on B x 12 probe poses)
against its plain version and against autograd through the truncated
PyTorch unroll, at the training shape (B = 1) and at B = 8.

Before each of phases 4-27 (each variant of phase 11, each arch of phase
20, each run of phases 22-27) the kernels' launch counters are set to 0,
and they are read just after it, with the phase's peak device memory;
each phase fails if a kernel of its path was never launched.  Then
nvidia-smi's line, one JSON line of per-kernel numbers (launches summed
over phases 4-27, by phase, and the kernels phase's check launches
apart),
and the last line
{"ok": true, "device": {...}}.  Any failed bar or error exits non-zero
before that last line.  Without a CUDA device, or without the repository
around this file, it fails.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

# Peaks of one H100 SXM (NVIDIA data sheet): device memory rate and f32
# rate outside the tensor cores.  All five kernels do f32 arithmetic.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# f32 operations (add, mul, div, sqrt, compare, select, transcendental:
# one each) that each function needs, counted from the kernels' sources;
# the head of each dsac_tpu_torch/csrc/*.cu (and irls_stats.cuh) states
# the same count with its breakdown.  IRLS_OPS_PER_PIXEL is the IRLS
# statistics of one pose at one pixel: one step of the refine kernel, one
# pass of the IRLS-stats kernel.
P3P_OPS_PER_LANE = 1500
SCORE_OPS_PER_PAIR = 42
DIFFMAP_OPS_PER_PAIR = 36
IRLS_OPS_PER_PIXEL = 165
REFINE_OPS_PER_SOLVE = 400

SAMPLES = 20  # CUDA-event timings per median

B, H, N, K, T = 8, 256, 1600, 32, 16  # serve shapes per batch
STEPS = 16  # IRLS steps of a refinement (8 reweightings x 2 GN steps)

# Accuracy at 5 cm / 5 deg of the reference's test_ransac forward pass
# (dsac_tpu process_frame, refine_all, score CNN, unfused fixed-T
# sampling, fused refine, argmax) on the 64 fixture frames, on a CPU:
# `PYTHONPATH=. python tests/test_torch_pipeline_cnn.py 64`.  The port's
# test_ransac phase may lose at most 2 of the 64 frames against it.
REF_TEST_RANSAC_ACCURACY = 0.96875
TEST_RANSAC_SLACK = 2 / 64

# The same for the phases of the SoftAM and test_ransac-variant paths: the
# reference's accuracy on the CPU with the committed weights (argmax, frame
# i keyed PRNGKey(i)), printed by
# `PYTHONPATH=. python tests/test_torch_eval_cli.py VARIANT FRAMES`; each
# phase may lose at most 2 of 64 frames (1 of 16) against it.
# serve --softam: two-phase sampling, fused soft scoring, the refine kernel
# on the average (serve_softam, 64 frames)
REF_SERVE_SOFTAM_ACCURACY = 1.0
# serve --softam --no-fused-scoring: the score CNN (serve_softam_cnn, 64
# frames; on the first 16, the reference gives 1.0 and the port 15 of 16
# on the H100, which a 16-frame bar would hold with no frame to spare)
REF_SERVE_SOFTAM_CNN_ACCURACY = 0.96875
# test_ransac --softam --fused-refine (test_ransac_softam, 64 frames)
REF_TEST_RANSAC_SOFTAM_ACCURACY = 0.9375
# test_ransac --fused-refine variants on 16 frames: --model none
# (model_none), --refine-variant hard (refine_hard), --fused-scoring
# (fused_scoring)
REF_VARIANT_ACCURACY = {"model_none": 1.0, "refine_hard": 0.9375,
                        "fused_scoring": 1.0}
VARIANT_FRAMES = 16
# The arch phases (--arch; models/coord_net.py), with the committed s2d and
# patch weights: the reference's accuracy on the CPU on the same frames,
# printed by `PYTHONPATH=. python tests/test_torch_coord_arch.py VARIANT
# FRAMES`; name -> (reference accuracy, frames).  serve_s2d and
# serve_patch: two-phase sampling, fused soft scoring, top 4 refined;
# serve_patch_cnn: the score CNN of artifacts/score_e2e_patch.npz;
# test_ransac_patch: fixed-T sampling, the score CNN, the pool refined.
REF_ARCH_ACCURACY = {"serve_s2d": (1.0, 64), "serve_patch": (1.0, 64),
                     "serve_patch_cnn": (1.0, 64),
                     "test_ransac_patch": (1.0, 16)}
CTX_FRAMES = 16  # serve_ctx: a fresh init, no accuracy bar
TRAIN_ARCHS = ("patch", "dense_s2d")  # train_arch, TRAIN_ARCH_ROUNDS each
TRAIN_ARCH_ROUNDS = 2

# The scene and data phases: the reference's accuracy on the CPU
# on the same frames with the same weights, printed by
# `PYTHONPATH=. python tests/test_torch_scene_cli.py VARIANT`; name ->
# (reference accuracy, frames).  Each run may lose 1 frame against it.
# The frames are the first 24 of SyntheticSource's seed 99 of the
# archetype (the test split that judged the archetype weights): the
# reference's poses and occluders (data/scene_frames.json).  noisy's noise
# is drawn on the card, not the reference's: its bar is the lowest of the
# reference's accuracies over 4 noise draws at the same poses.
REF_SCENE_ACCURACY = {
    # test_ransac --fused-refine -rdraw 0, the clutter weights (score CNN)
    "test_ransac_clutter": (0.75, 24),
    "test_ransac_clutter_select_inlier": (1.0, 24),
    # the noisy weights, over 4 noise draws: 0.708, 0.708, 0.667, 0.667
    "test_ransac_noisy": (0.6666666666666666, 24),
    # --fused-scoring with coord_e2e_repeat_t10b.npz, the soft head, on
    # the reference's frames as its CLI renders them (jitted): 4 of 24.
    # The walls lie at multiples of the texture's 500 mm period, so f32
    # rounding picks each wall pixel's side of the wrap, and no two
    # renders agree there (the reference's eager render of the same
    # poses gives 2 of 24); the bar is still the CLI's, less 1 frame
    "test_ransac_repeat": (0.16666666666666666, 24),
    # serve, two-phase sampling, the top 4 refined, the clutter weights:
    # fused soft scoring, and the score CNN
    "serve_scene": (0.9583333333333334, 24),
    "serve_scene_cnn": (0.9166666666666666, 24),
    # test_ransac --data on the test split of an export of the room (16
    # frames of seed 99) with the room's weights
    "data_7scenes": (1.0, 16),
}
SCENE_FRAMES = 8  # scenes: the first 8 frames of seed 99 per archetype
# scenes: each archetype's statistics against those of the reference that
# data/scene_frames.json records (tests/test_torch_scenes.py); mean RGB of
# 255, mean positive depth in mm, shares of pixels.  Under a texture period
# the walls (at 0, 3000 and 4000 mm, multiples of the 500 mm period) read
# the wrap's either side by f32 rounding, pixel by pixel, so mean RGB gets
# PERIOD_RGB_TOL there (the port on the CPU: 0.49 from the reference).
SCENE_STAT_TOL = {"mean_rgb": 0.1, "mean_depth_mm": 0.1,
                  "occluded_share": 1e-3, "gray_share": 1e-3}
PERIOD_RGB_TOL = 2.0
EXPORT_TRAIN, EXPORT_TEST = 8, 16  # data_7scenes: the export's frames
# data_7scenes: SevenScenesDataset.get_obj of 2 frames against the render's
# coordinates (tests/test_data_io.py:228-240): median and 95% error in mm
OBJ_MEDIAN_MM, OBJ_P95_MM = 10.0, 40.0
# data_7scenes: the port's codec's decode of a 640 x 480 frame in each row
# filter, timed DECODE_REPS times on the host
DECODE_FILTERS = ("none", "sub", "up", "average", "paeth")
DECODE_REPS = 3
TRAIN_SCENE_ROUNDS = 2

# On the serve path's P3P pool a kernel may miss its bar against the
# plain version in f64 on at most this many more elements than the plain
# version's own f32 result does.
MISS_SLACK = 2

# Off the serve shape, where the score kernel misses the plain version by
# more than 1e-3, every score of the kernel must lie within
# SCORE_VS_F64_RATIO x the plain f32 version's largest gap to its f64 twin,
# plus SCORE_VS_F64_ATOL, of that twin.
SCORE_VS_F64_RATIO, SCORE_VS_F64_ATOL = 1.5, 1e-4

# The stepwise refiner against the refine kernel at the hypothesis that
# test_ransac serves, on every frame (tests/test_gn_pallas.py:112-115).
STEPS_VS_FUSED_DT_MM, STEPS_VS_FUSED_DR = 1e-2, 1e-5

# the kernels each phase's path runs
PATHS = {"serve": ("p3p", "soft_inlier_score", "refine_irls"),
         "serve_cnn": ("p3p", "diffmap", "refine_irls"),
         "serve_fixed_t": ("p3p", "diffmap", "refine_irls"),
         "test_ransac": ("diffmap", "refine_irls", "irls_stats"),
         "train_grad": ("refine_irls", "refine_init_backward"),
         "train_ransac": ("refine_irls",),
         "train_ransac_softam": ("refine_irls", "refine_init_backward"),
         "serve_softam": ("p3p", "soft_inlier_score", "refine_irls"),
         "serve_softam_cnn": ("p3p", "diffmap", "refine_irls"),
         "test_ransac_softam": ("diffmap", "refine_irls"),
         "test_ransac_variants": ("diffmap", "refine_irls",
                                  "soft_inlier_score"),
         "serve_s2d": ("p3p", "soft_inlier_score", "refine_irls"),
         "serve_patch": ("p3p", "soft_inlier_score", "refine_irls"),
         "serve_patch_cnn": ("p3p", "diffmap", "refine_irls"),
         "test_ransac_patch": ("diffmap", "refine_irls"),
         "serve_ctx": ("p3p", "soft_inlier_score", "refine_irls"),
         "train_arch": ("refine_irls",),
         "scenes": (),
         "test_ransac_clutter": ("diffmap", "refine_irls"),
         "test_ransac_noisy": ("diffmap", "refine_irls"),
         "test_ransac_repeat": ("soft_inlier_score", "refine_irls"),
         "serve_scene": ("p3p", "soft_inlier_score", "diffmap",
                         "refine_irls"),
         "data_7scenes": ("diffmap", "refine_irls"),
         "train_scene": ("refine_irls", "refine_init_backward")}
# test_ransac_variants: each variant's flags and path, and the kernels it
# must not launch (hard refinement runs in PyTorch)
VARIANTS = {"model_none": (["--model", "none"], ("diffmap", "refine_irls"),
                           ("soft_inlier_score",)),
            "refine_hard": (["--refine-variant", "hard"], ("diffmap",),
                            ("refine_irls", "soft_inlier_score")),
            "fused_scoring": (["--fused-scoring"],
                              ("soft_inlier_score", "refine_irls"),
                              ("diffmap",))}

# The init-pose backward: inits 0.03 rad and 60 mm off, refined for 1
# step, against its plain version, its plain version in f64 and autograd
# through the truncated PyTorch unroll; the timing at the training shape,
# 16 steps.  In the reference's regime (0.15 rad, 300 mm, 4 steps;
# tests/test_implicit_grad.py:89-142) these frames start below
# min_inliers and freeze, and both gradients are the identity's; after 2
# steps from 0.06 rad most have converged, and the f32 central differences
# of the rest are a few percent off their f64 twin.  Here the plain f32
# estimate meets its f64 twin at cosine 1.00000 and ratio 0.998-1.004 on
# the same construction on the CPU.
FD_STEPS = 1
FD_INIT_RAD, FD_INIT_MM = 0.03, 60.0
TRAIN_ROUNDS = 8
# train_grad holds DSAC's score gradient on those of fixture frames
# 0..SCORE_FRAMES-1 where f32 resolves it
SCORE_FRAMES = 4
REPO = Path(__file__).resolve().parent


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


def excess(a, b, rtol: float, atol: float) -> float:
    """max(|a - b| - (atol + rtol |b|)): <= 0 where a is within the bar."""
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def missed(x, plain64, rtol: float, atol: float):
    """Where x misses the bar against the plain version in f64."""
    return (x.double() - plain64).abs() > atol + rtol * plain64.abs()


def stats_f64_with_f32(args, cam, part: str):
    """The IRLS statistics summed in f64 from f64 inputs, but with one
    intermediate taken from the plain version's f32 computation: the
    residuals ``part="r"`` (and the weights computed from them) or the
    Jacobian ``part="J"``.  The elements on which such a result misses the
    bar are those that the f32 rounding of that intermediate alone puts
    out of reach."""
    import torch
    from dsac_tpu_torch.geometry.gn import (_residuals_and_jac,
                                            soft_inlier_weights)
    from dsac_tpu_torch.geometry.pose import Pose
    from dsac_tpu_torch.ops.gn_cuda import _COLS, _ROWS

    def residuals_and_jac(dtype):
        R, t, coords, pix = (a.to(dtype) for a in args)
        r, J = _residuals_and_jac(Pose(R, t), coords[:, None], pix[:, None],
                                  cam)
        return r.double(), J.double()

    r, J = residuals_and_jac(torch.float64)
    r32, J32 = residuals_and_jac(torch.float32)
    if part == "r":
        r = r32
    else:
        J = J32
    err = torch.clamp(torch.sqrt(torch.sum(r * r, dim=-1) + 1e-8), max=100.0)
    w = soft_inlier_weights(err, 10.0, 1.0)
    JtJ = torch.einsum("...n,...nki,...nkj->...ij", w, J, J)
    Jtr = torch.einsum("...n,...nki,...nk->...i", w, J, r)
    return torch.cat([JtJ[..., _ROWS, _COLS], Jtr, w.sum(-1, keepdim=True)],
                     dim=-1)


def check_kernels(dev) -> tuple[list[dict], list[str], dict]:
    import torch
    from dsac_tpu_torch.utils.timing import events_ms, profiled_ms
    from dsac_tpu_torch.geometry.pose import Pose
    from dsac_tpu_torch.ops import _build
    from dsac_tpu_torch.ops.diffmap_cuda import (diffmap_layout,
                                                 diffmap_smem_bytes, diffmaps,
                                                 diffmaps_ref, score_layout,
                                                 score_smem_bytes,
                                                 soft_inlier_scores,
                                                 soft_inlier_scores_ref)
    from dsac_tpu_torch.ops.gn_cuda import (irls_stats, irls_stats_layout,
                                            irls_stats_ref, launch_refine,
                                            refine_layout,
                                            refine_pose_fused,
                                            refine_pose_fused_ref,
                                            refine_pose_fused_steps,
                                            unpack_stats)
    from dsac_tpu_torch.ops.p3p_cuda import (p3p_layout, p3p_solve,
                                             p3p_solve_ref)
    from dsac_tpu_torch.utils.kernel_problems import (DIFFMAP_SHAPES,
                                                      IRLS_BARS,
                                                      IRLS_STATS_SHAPES,
                                                      P3P_SHAPES,
                                                      REFINE_REGIMES,
                                                      SCORE_SHAPES,
                                                      attempt_sets,
                                                      hypothesis_pool,
                                                      make_problem,
                                                      reference_problem,
                                                      regime_poses)

    gen = torch.Generator(device=dev).manual_seed(1305)
    cam, gt, coords, pix = make_problem(B, N, dev, gen)
    rows, failures = [], []
    sms = _build.sm_count(dev)

    # ---- P3P at the three sampling shapes: B*H (two-phase sampling's
    # phase 1), B*K*(T-1) (its phase 2), B*H*T (fixed-T); the row's times
    # and bound are those of the two-phase batch (phases 1 and 2) ----
    by_shape, pools = [], {}
    for lanes in P3P_SHAPES.values():
        obj, img = attempt_sets(coords, pix, lanes, gen)
        M = obj.shape[0]
        kp, kv, kw = p3p_solve(obj, img, cam)
        rp, rv, rw = p3p_solve_ref(obj, img, cam)
        kc, rc = kv & (kw < 10.0), rv & (rw < 10.0)
        both = kc & rc
        dR = (kp.R - rp.R).abs().flatten(1).amax(1)[both]
        shape = {"lanes": M, "layout": list(p3p_layout(M, sms)),
                 "decision_agreement": float((kc == rc).float().mean()),
                 "median_abs_dR": float(dR.median()) if dR.numel() else 0.0,
                 "max_abs_dR": float(dR.max()) if dR.numel() else 0.0}
        finite = all(bool(torch.isfinite(x).all()) for x in (kp.R, kp.t, kw))
        if not finite:
            failures.append(f"p3p: non-finite output at {M} lanes")
        if float(kc.float().mean()) < 0.05 or bool(kc.all()):
            failures.append(f"p3p: pool of {M} lanes lacks valid and "
                            "invalid lanes")
        if shape["decision_agreement"] < 0.98:
            failures.append(f"p3p: decision agreement "
                            f"{shape['decision_agreement']} < 0.98 at {M} "
                            "lanes")
        if shape["median_abs_dR"] >= 1e-3:
            failures.append(f"p3p: median |dR| {shape['median_abs_dR']} >= "
                            f"1e-3 at {M} lanes")
        b_ms, b_by = bound_ms(M * ((12 + 8) * 4 + (9 + 3 + 1) * 4 + 1),
                              M * P3P_OPS_PER_LANE)
        shape.update({
            "ms": events_ms(lambda: p3p_solve(obj, img, cam), 10, SAMPLES),
            "device_ms": profiled_ms(lambda: p3p_solve(obj, img, cam), 20,
                                     "p3p_kernel"),
            "plain_ms": events_ms(lambda: p3p_solve_ref(obj, img, cam), 1,
                                  SAMPLES),
            "bound_ms": b_ms, "bound_by": b_by})
        by_shape.append(shape)
        pools[lanes] = (kp, kv & (kw < 10.0))
    serve_shapes = by_shape[:2]

    def total(key):
        vals = [x[key] for x in serve_shapes]
        return None if None in vals else sum(vals)

    b_ms, b_by = bound_ms(
        sum(x["lanes"] for x in serve_shapes) * ((12 + 8) * 4 + 13 * 4 + 1),
        sum(x["lanes"] for x in serve_shapes) * P3P_OPS_PER_LANE)
    rows.append({"name": "p3p", "route": "cuda",
                 "source": "dsac_tpu_torch/csrc/p3p.cu",
                 "replaces": "dsac_tpu/ops/p3p_pallas.py:61",
                 "max_abs_err": max(x["max_abs_dR"] for x in by_shape),
                 "decision_agreement": min(x["decision_agreement"]
                                           for x in by_shape),
                 "median_abs_dR": max(x["median_abs_dR"] for x in by_shape),
                 "bar": "decision agreement >= 0.98, median |dR| < 1e-3, "
                        "finite, at every shape",
                 "shapes": f"{B * H} + {B * K * (T - 1)} lanes (a two-phase "
                           f"serve batch); by_shape adds {B * H * T} "
                           "(fixed-T)",
                 "ms": total("ms"), "device_ms": total("device_ms"),
                 "plain_ms": total("plain_ms"), "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None,
                 "by_shape": by_shape})

    # ---- score at each shape of SCORE_SHAPES, in the layout score_layout
    # picks: the phase-1 pool (B x H hypotheses x N pixels) at the serve
    # shape, a pool of P3P hypotheses at the large-H one; the row's times
    # and bound are the serve shape's ----
    hyp = pools[H][0]
    R = hyp.R.reshape(B, H, 3, 3).contiguous()
    t = hyp.t.reshape(B, H, 3).contiguous()
    score_shapes = []
    for name, (nb, nh) in SCORE_SHAPES.items():
        c, x = coords[:nb].contiguous(), pix[:nb].contiguous()
        hs = (Pose(R, t) if (nb, nh) == (B, H)
              else hypothesis_pool(c, x, nh, cam, gen))

        def score():
            return soft_inlier_scores(hs.R, hs.t, c, x, cam)

        ks = score()
        same = bool(torch.equal(ks, score()))
        rs = soft_inlier_scores_ref(hs.R, hs.t, c, x, cam)
        err = float((ks - rs).abs().max())
        finite = bool(torch.isfinite(ks).all())
        # At the serve shape the bar is max abs error <= 1e-3 against the
        # plain version.  At H = 4,096 some scores are out of f32's reach
        # in either version (the plain version misses its f64 twin by up
        # to ~1e-3 there, and the parent kernel gives this kernel's
        # result): where the kernel misses the plain version by more than
        # 1e-3, each of its scores must lie within SCORE_VS_F64_RATIO x the
        # plain version's largest gap + SCORE_VS_F64_ATOL of the f64 twin.
        r64 = soft_inlier_scores_ref(hs.R.double(), hs.t.double(),
                                     c.double(), x.double(), cam)
        vs64 = [float((v.double() - r64).abs().max()) for v in (ks, rs)]
        bar64 = SCORE_VS_F64_RATIO * vs64[1] + SCORE_VS_F64_ATOL
        held = err <= 1e-3 or ((nb, nh) != (B, H) and vs64[0] <= bar64)
        if not (held and finite and same):
            failures.append(f"score ({name}, B={nb} H={nh}): max abs error "
                            f"{err} (bar 1e-3), against f64 {vs64} "
                            f"(kernel, plain; bar {bar64} for the kernel), "
                            f"finite {finite}, two launches bit-identical "
                            f"{same}")
        b_ms, b_by = bound_ms(nb * nh * 12 * 4 + nb * N * 5 * 4 + nb * nh * 4,
                              nb * nh * N * SCORE_OPS_PER_PAIR)
        score_shapes.append({
            "shape": name, "shapes": f"B={nb} H={nh} N={N}",
            "layout": list(score_layout(nb, nh, N, sms)),
            "dynamic_smem_bytes": score_smem_bytes(score_layout(nb, nh, N,
                                                                sms)),
            "max_abs_err": err, "bit_identical_relaunch": same,
            "max_abs_err_vs_f64_kernel_plain": vs64,
            "ms": events_ms(score, 10, SAMPLES),
            "device_ms": profiled_ms(score, 20, "score_kernel"),
            "plain_ms": events_ms(lambda: soft_inlier_scores_ref(
                hs.R, hs.t, c, x, cam), 1, SAMPLES),
            "bound_ms": b_ms, "bound_by": b_by})
    top = score_shapes[0]
    rows.append({"name": "soft_inlier_score", "route": "cuda",
                 "source": "dsac_tpu_torch/csrc/score.cu",
                 "replaces": "dsac_tpu/ops/diffmap_pallas.py:107",
                 "max_abs_err": max(x["max_abs_err"] for x in score_shapes),
                 "bar": "max abs error <= 1e-3 at the serve shape; at "
                        "H = 4,096 the same, or max abs error against f64 "
                        f"<= {SCORE_VS_F64_RATIO} x the plain version's + "
                        f"{SCORE_VS_F64_ATOL}; finite, two launches "
                        "bit-identical, at every shape",
                 "shapes": top["shapes"] + " (serve); by_shape lists every "
                           "one",
                 **{k: top[k] for k in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by")},
                 "library_ms": None, "by_shape": score_shapes})

    # ---- refine at every regime of the main path (REFINE_REGIMES), in
    # the layout refine_layout picks; the row's times and bound are those
    # of the serve batch's top 4 ----
    regimes = []
    for name, (nb, P) in REFINE_REGIMES.items():
        poses = regime_poses(name, gt, Pose(R, t), gen)
        c, x = coords[:nb].contiguous(), pix[:nb].contiguous()

        def refine():
            return refine_pose_fused(poses, c, x, cam)

        kr, kn = refine()
        rr, rn = refine_pose_fused_ref(poses, c, x, cam)
        dt = float((kr.t - rr.t).abs().max())
        dRr = float((kr.R - rr.R).abs().max())
        dn = float((kn - rn).abs().max())
        finite = all(bool(torch.isfinite(v).all()) for v in (kr.R, kr.t, kn))
        if not (dt <= 2.0 and dRr <= 1e-4 and dn <= 0.5 and finite):
            failures.append(f"refine ({name}, B={nb} P={P}): |dt| {dt} (bar "
                            f"2 mm), |dR| {dRr} (bar 1e-4), |dn_in| {dn} "
                            f"(bar 0.5), finite {finite}")
        b_ms, b_by = bound_ms(
            nb * P * 12 * 4 + nb * N * 5 * 4 + nb * P * 13 * 4,
            nb * P * STEPS * (N * IRLS_OPS_PER_PIXEL + REFINE_OPS_PER_SOLVE))
        regimes.append({
            "regime": name, "shapes": f"B={nb} P={P} N={N} steps={STEPS}",
            "layout": list(refine_layout(nb * P, P, N, sms)),
            "max_abs_dt_mm": dt, "max_abs_dR": dRr, "max_abs_dn_in": dn,
            "ms": events_ms(refine, 10, SAMPLES),
            "device_ms": profiled_ms(refine, 20, "refine_kernel"),
            # the plain version of the largest regime is timed once
            "plain_ms": events_ms(lambda: refine_pose_fused_ref(
                poses, c, x, cam), 1, 1 if nb * P > H else SAMPLES),
            "bound_ms": b_ms, "bound_by": b_by})
    top = next(r for r in regimes if r["regime"] == "serve_top4")
    rows.append({"name": "refine_irls", "route": "cuda",
                 "source": "dsac_tpu_torch/csrc/refine.cu",
                 "replaces": "dsac_tpu/ops/gn_pallas.py:236",
                 "max_abs_err": max(r["max_abs_dt_mm"] for r in regimes),
                 "max_abs_dR": max(r["max_abs_dR"] for r in regimes),
                 "max_abs_dn_in": max(r["max_abs_dn_in"] for r in regimes),
                 "bar": "|dt| <= 2 mm, |dR| <= 1e-4, |dn_in| <= 0.5, "
                        "finite, at every regime",
                 "shapes": top["shapes"] + " (serve top 4); regimes "
                           "lists every one",
                 **{k: top[k] for k in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by")},
                 "library_ms": None, "regimes": regimes})

    # ---- diffmap at each shape of DIFFMAP_SHAPES, in the layout
    # diffmap_layout picks (and below, irls_stats at each shape of
    # IRLS_STATS_SHAPES): at the bars of the reference's kernel tests on
    # the inputs those tests draw, and on the phase-1 pool of the serve
    # path ----
    Rr, tr, cr, pr = reference_problem(B, H, N, dev, gen)

    # On the pool a few elements are out of f32's reach in either version:
    # there the bar is held against the plain version in f64, and the
    # kernel may miss it on at most MISS_SLACK more elements than the plain
    # version's own f32 result.
    dm_shapes = []
    for shape, (nb, nh) in DIFFMAP_SHAPES.items():
        problems = {"reference": tuple(a[:nb, :nh].contiguous()
                                       for a in (Rr, tr)) + (cr[:nb], pr[:nb]),
                    "pool": tuple(a[:nb, :nh].contiguous() for a in (R, t))
                    + (coords[:nb], pix[:nb])}
        worst = {}
        for name, args in problems.items():
            kd, rd = diffmaps(*args, cam), diffmaps_ref(*args, cam)
            worst[name] = float((kd - rd).abs().max())
            if not bool(torch.isfinite(kd).all()):
                failures.append(f"diffmap ({shape}): non-finite output "
                                f"({name})")
            if name == "reference":
                ex = excess(kd, rd, 1e-4, 1e-2)
                if not ex <= 0.0:
                    failures.append(f"diffmap ({shape}): exceeds atol 1e-2 "
                                    f"+ rtol 1e-4 by {ex}")
            else:
                r64 = diffmaps_ref(*(a.double() for a in args), cam)
                n_k = int(missed(kd, r64, 1e-4, 1e-2).sum())
                n_p = int(missed(rd, r64, 1e-4, 1e-2).sum())
                worst["pool_misses"] = [n_k, n_p]
                if not n_k <= n_p + MISS_SLACK:
                    failures.append(f"diffmap ({shape}, pool): {n_k} "
                                    "elements miss the bar against f64, "
                                    f"the plain version {n_p}")
        args = problems["pool"]

        def diffmap():
            return diffmaps(*args, cam)

        b_ms, b_by = bound_ms(
            nb * nh * 12 * 4 + nb * N * 5 * 4 + nb * nh * N * 4,
            nb * nh * N * DIFFMAP_OPS_PER_PAIR)
        dm_shapes.append({
            "shape": shape, "shapes": f"B={nb} H={nh} N={N}",
            "layout": list(diffmap_layout(nb, nh, N, sms)),
            "dynamic_smem_bytes": diffmap_smem_bytes(
                diffmap_layout(nb, nh, N, sms)),
            "max_abs_err": worst["reference"],
            "pool_max_abs_err": worst["pool"],
            "pool_misses_kernel_plain": worst["pool_misses"],
            "ms": events_ms(diffmap, 10, SAMPLES),
            "device_ms": profiled_ms(diffmap, 20, "diffmap_kernel"),
            "plain_ms": events_ms(lambda: diffmaps_ref(*args, cam), 1,
                                  SAMPLES),
            "bound_ms": b_ms, "bound_by": b_by})
    top = dm_shapes[0]
    rows.append({"name": "diffmap", "route": "cuda",
                 "source": "dsac_tpu_torch/csrc/diffmap.cu",
                 "replaces": "dsac_tpu/ops/diffmap_pallas.py:32",
                 "max_abs_err": max(x["max_abs_err"] for x in dm_shapes),
                 "pool_max_abs_err": max(x["pool_max_abs_err"]
                                         for x in dm_shapes),
                 "pool_misses_kernel_plain": top["pool_misses_kernel_plain"],
                 "bar": "rtol 1e-4, atol 1e-2 on the reference problem; on "
                        "the pool, misses against f64 <= the plain "
                        f"version's + {MISS_SLACK}; finite; at every shape",
                 "shapes": top["shapes"] + " (serve); by_shape lists every "
                           "one",
                 **{k: top[k] for k in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by")},
                 "library_ms": None, "by_shape": dm_shapes})

    # ---- irls_stats at each shape of IRLS_STATS_SHAPES, in the layout
    # irls_stats_layout picks: at the bars of the reference's kernel tests
    # on the inputs those tests draw, and on the phase-1 pool of the serve
    # path against the plain version in f64 (as the diff-map); two launches
    # bit-identical; and the refine kernel's n_in after one step in the
    # same layout equal to the pass's inlier mass bit for bit.  The row's
    # times and bound are the refine-all batch's (B x H) ----
    st_shapes = []
    for shape, (nb, nh) in IRLS_STATS_SHAPES.items():
        problems = {"reference": tuple(a[:nb, :nh].contiguous()
                                       for a in (Rr, tr)) + (cr[:nb], pr[:nb]),
                    "pool": tuple(a[:nb, :nh].contiguous() for a in (R, t))
                    + (coords[:nb], pix[:nb])}
        layout = irls_stats_layout(nb * nh, nh, N, sms)
        gaps = {}
        for name, args in problems.items():
            ks = unpack_stats(irls_stats(*args, cam))
            rs = unpack_stats(irls_stats_ref(*args, cam))
            if not all(bool(torch.isfinite(v).all()) for v in ks):
                failures.append(f"irls_stats ({shape}): non-finite output "
                                f"({name})")
            if name == "pool":
                r64 = unpack_stats(irls_stats_ref(
                    *(a.double() for a in args), cam))
                part32 = {p: unpack_stats(stats_f64_with_f32(args, cam, p))
                          for p in ("r", "J")}
            for i, (q, rtol, atol) in enumerate(IRLS_BARS):
                gaps[f"{name}_{q}"] = float((ks[i] - rs[i]).abs().max())
                if name == "reference":
                    ex = excess(ks[i], rs[i], rtol, atol)
                    if not ex <= 0.0:
                        failures.append(f"irls_stats ({shape}): {q} exceeds "
                                        f"atol {atol} + rtol {rtol} by {ex}")
                else:
                    mk = missed(ks[i], r64[i], rtol, atol)
                    mp = missed(rs[i], r64[i], rtol, atol)
                    n_k, n_p = int(mk.sum()), int(mp.sum())
                    # which f32 intermediate puts the missed elements out
                    # of reach: each count is (misses, of them also the
                    # kernel's)
                    cause = {}
                    for p, label in (("r", "f32_residual"),
                                     ("J", "f32_jacobian")):
                        mv = missed(part32[p][i], r64[i], rtol, atol)
                        cause[label] = [int(mv.sum()), int((mv & mk).sum())]
                    gaps[f"pool_{q}_misses"] = {
                        "kernel": n_k, "plain": n_p,
                        "both": int((mk & mp).sum()), **cause}
                    if not n_k <= n_p + MISS_SLACK:
                        failures.append(f"irls_stats ({shape}, pool): {q}: "
                                        f"{n_k} elements miss the bar "
                                        "against f64, the plain version "
                                        f"{n_p}")
        # the pool's pass twice, and one refine step in the same layout
        args = problems["pool"]
        kstats = irls_stats(*args, cam)
        same = bool(torch.equal(kstats, irls_stats(*args, cam)))
        _, n_one = launch_refine(*args, cam, 1, 10.0, 1.0, 50.0, 1e-4, 100.0,
                                 layout=layout)
        step_same = bool(torch.equal(n_one, kstats[..., 27]))
        if not (same and step_same):
            failures.append(f"irls_stats ({shape}): two launches "
                            f"bit-identical {same}; refine's n_in after one "
                            f"step in layout {tuple(layout)} equal to the "
                            f"inlier mass bit for bit {step_same}")

        def stats():
            return irls_stats(*args, cam)

        b_ms, b_by = bound_ms(
            nb * nh * 12 * 4 + nb * N * 5 * 4 + nb * nh * 28 * 4,
            nb * nh * N * IRLS_OPS_PER_PIXEL)
        st_shapes.append({
            "shape": shape, "shapes": f"B={nb} P={nh} N={N}",
            "layout": list(layout),
            "refine_layout_coincides": layout == refine_layout(
                nb * nh, nh, N, sms),
            **gaps, "bit_identical_relaunch": same,
            "refine_step_n_in_identical": step_same,
            "ms": events_ms(stats, 10, SAMPLES),
            "device_ms": profiled_ms(stats, 20, "irls_stats_kernel"),
            "plain_ms": events_ms(lambda: irls_stats_ref(*args, cam), 1,
                                  SAMPLES),
            "bound_ms": b_ms, "bound_by": b_by})
    top = next(x for x in st_shapes if x["shape"] == "refine_all")
    rows.append({"name": "irls_stats", "route": "cuda",
                 "source": "dsac_tpu_torch/csrc/irls_stats.cu",
                 "replaces": "dsac_tpu/ops/gn_pallas.py:45",
                 "max_abs_err": max(x["reference_n_in"] for x in st_shapes),
                 "bar": "n_in rtol 1e-3 atol 0.05; JtJ, Jtr rtol 2e-3 "
                        "atol 2.0 on the reference problem; on the pool, "
                        "misses against f64 <= the plain version's + "
                        f"{MISS_SLACK}; finite; two launches bit-identical; "
                        "refine's n_in after one step in the same layout "
                        "bit-identical to the inlier mass; at every shape",
                 "shapes": top["shapes"] + " (refine-all); by_shape lists "
                           "every one",
                 **{k: top[k] for k in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by")},
                 "library_ms": None, "by_shape": st_shapes})

    # ---- stepwise refiner vs refine kernel at the refine-all shape ----
    pool = Pose(R, t)
    a, na = refine_pose_fused(pool, coords, pix, cam)
    c, nc = refine_pose_fused_steps(pool, coords, pix, cam, steps=STEPS)
    dt = float((a.t - c.t).abs().max())
    dRr = float((a.R - c.R).abs().max())
    dn = excess(na, nc, 1e-4, 0.0)
    if not (dt <= 1e-2 and dRr <= 1e-5 and dn <= 0.0):
        failures.append(f"refine steps vs fused: |dt| {dt} (bar 1e-2 mm), "
                        f"|dR| {dRr} (bar 1e-5), n_in beyond rtol 1e-4 by "
                        f"{dn}")
    check = {"name": "refine_steps_vs_fused", "shapes": f"B={B} P={H} "
             f"N={N} steps={STEPS}", "max_abs_dt_mm": dt,
             "max_abs_dR": dRr,
             "max_abs_dn_in": float((na - nc).abs().max()),
             "bar": "|dt| <= 1e-2 mm, |dR| <= 1e-5, n_in rtol 1e-4 "
                    "(tests/test_gn_pallas.py:112-115)",
             "refine_all_ms": events_ms(
                 lambda: refine_pose_fused(pool, coords, pix, cam), 10,
                 SAMPLES),
             "refine_all_device_ms": profiled_ms(
                 lambda: refine_pose_fused(pool, coords, pix, cam), 10,
                 "refine_kernel"),
             "steps_ms": events_ms(lambda: refine_pose_fused_steps(
                 pool, coords, pix, cam, steps=STEPS), 1, SAMPLES)}
    rows.append(check_init_backward(dev, gen, cam, gt, coords, pix,
                                    failures))
    return rows, failures, check


def cosine_ratio(a, b) -> tuple[float, float]:
    a, b = a.double().flatten(), b.double().flatten()
    return (float(a @ b / (a.norm() * b.norm() + 1e-30)),
            float(a.norm() / (b.norm() + 1e-30)))


def check_init_backward(dev, gen, cam, gt, coords, pix,
                        failures: list) -> dict:
    """The init-pose backward of the refine kernel against its plain
    version and against autograd through the truncated unroll, per frame,
    at B = 1 and B = 8 (one pose a frame: 12 probes each); its times at
    the training shape (B = 1, 16 steps)."""
    import torch
    from dsac_tpu_torch.geometry.gn import refine_pose
    from dsac_tpu_torch.geometry.pose import Pose, pose_to_vec6
    from dsac_tpu_torch.geometry.rotation import so3_exp
    from dsac_tpu_torch.ops.gn_cuda import (InitSensitiveRefine,
                                            refine_init_sensitive,
                                            refine_pose_fused)
    from dsac_tpu_torch.utils.timing import events_ms, profiled_ms

    R0 = (so3_exp(torch.randn(B, 1, 3, generator=gen, device=dev)
                  * FD_INIT_RAD) @ gt.R[:, None]).contiguous()
    t0 = (gt.t[:, None] + torch.randn(B, 1, 3, generator=gen, device=dev)
          * FD_INIT_MM).contiguous()
    w = torch.randn(B, 1, 6, generator=gen, device=dev)

    def grad(nb, route, dtype=torch.float32):
        v6 = torch.zeros(nb, 1, 6, device=dev, dtype=dtype,
                         requires_grad=True)
        p = Pose(so3_exp(v6[..., :3]) @ R0[:nb].to(dtype),
                 t0[:nb].to(dtype) + v6[..., 3:])
        c, x = coords[:nb].to(dtype), pix[:nb].to(dtype)
        if route == "unroll":
            out = refine_pose(p, c[:, None], x[:, None], cam, steps=FD_STEPS,
                              inner_iters=1)[0]
        elif route == "identity":  # the gradient of a frozen pose
            out = p
        else:
            out = refine_init_sensitive(p, c, x, cam, outer_steps=FD_STEPS,
                                        inner_iters=1,
                                        plain=route == "plain")
        (w[:nb].to(dtype) * pose_to_vec6(out)).sum().backward()
        return v6.grad[:, 0]

    worst = {}
    for nb in (1, B):
        before = InitSensitiveRefine.launches
        gk = grad(nb, "kernel")
        if InitSensitiveRefine.launches != before + 1:
            failures.append("init backward: not one launch per backward")
        gp, gu, gi = grad(nb, "plain"), grad(nb, "unroll"), grad(nb,
                                                                "identity")
        g64 = grad(nb, "plain", torch.float64)
        vs = {name: [cosine_ratio(gk[b], ref[b]) for b in range(nb)]
              for name, ref in (("plain", gp), ("plain_f64", g64),
                                ("unroll", gu))}
        live = sum(cosine_ratio(gu[b], gi[b])[0] < 0.9 for b in range(nb))
        worst[nb] = {f"{k}_{name}": v for name, pairs in vs.items()
                     for k, v in (("min_cos_vs", min(c for c, _ in pairs)),
                                  ("ratios_vs", [r for _, r in pairs]))}
        worst[nb]["frames_neither_frozen_nor_converged"] = live
        worst[nb]["max_abs_err"] = float((gk - gp).abs().max())
        ok = (all(c >= 0.999 and 0.99 <= r <= 1.01
                  for name in ("plain", "plain_f64") for c, r in vs[name])
              and all(c > 0.97 and 0.8 < r < 1.25 for c, r in vs["unroll"])
              and bool(torch.isfinite(gk).all())
              and (nb == 1 or 4 * live >= nb))
        if not ok:
            failures.append(f"init backward at B={nb}: {worst[nb]}")
    with torch.no_grad():
        a = refine_init_sensitive(Pose(R0, t0), coords, pix, cam)
        b, _ = refine_pose_fused(Pose(R0, t0), coords, pix, cam)
    fwd_dR = float((a.R - b.R).abs().max())
    fwd_dt = float((a.t - b.t).abs().max())
    if not (fwd_dR <= 1e-6 and fwd_dt <= 1e-4):
        failures.append(f"init backward forward: |dR| {fwd_dR}, |dt| "
                        f"{fwd_dt} against the refine kernel")

    # times of the backward alone, at the training shape: B = 1, 16 steps
    def backward_call(plain: bool):
        R = R0[:1].clone().requires_grad_()
        t = t0[:1].clone().requires_grad_()
        out = refine_init_sensitive(Pose(R, t), coords[:1], pix[:1], cam,
                                    plain=plain)
        g = (torch.ones_like(out.R), torch.ones_like(out.t))
        return lambda: torch.autograd.grad((out.R, out.t), (R, t), g,
                                           retain_graph=True)

    call = backward_call(False)
    probes = 12
    b_ms, b_by = bound_ms(
        probes * 12 * 4 + N * 5 * 4 + probes * 13 * 4,
        probes * STEPS * (N * IRLS_OPS_PER_PIXEL + REFINE_OPS_PER_SOLVE))
    return {"name": "refine_init_backward", "route": "cuda",
            "source": "dsac_tpu_torch/ops/gn_cuda.py",
            "kernel_source": "dsac_tpu_torch/csrc/refine.cu",
            "replaces": "dsac_tpu/ops/gn_pallas.py:469",
            "max_abs_err": max(v["max_abs_err"] for v in worst.values()),
            "checks": {f"B={nb}": v for nb, v in worst.items()},
            "forward_max_abs_dR": fwd_dR, "forward_max_abs_dt_mm": fwd_dt,
            "bar": "per frame cosine >= 0.999 and norm ratio 0.99-1.01 "
                   "against plain and plain in f64; cosine > 0.97 and "
                   "ratio 0.8-1.25 against autograd through the truncated "
                   f"unroll ({FD_STEPS} step, inits {FD_INIT_RAD} rad and "
                   f"{FD_INIT_MM} mm off); at B=8 a quarter of the frames "
                   "or more neither frozen nor converged; forward against "
                   "the refine kernel to 1e-6 on R, 1e-4 on t",
            "shapes": f"B=1 P=1: 12 probes, N={N} steps={STEPS}",
            "ms": events_ms(call, 10, SAMPLES),
            "device_ms": profiled_ms(call, 20, "refine_kernel"),
            "plain_ms": events_ms(backward_call(True), 1, SAMPLES),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def run_phase(fn, kernels: dict) -> tuple[dict, dict, float, int]:
    """Drive one path with every launch counter set to 0 just before it;
    returns (its result, the counters just after, seconds, peak device
    memory in bytes since the phase began or since the phase last reset
    the peak)."""
    import torch
    for wrapper in kernels.values():
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in kernels.items()}
    return res, launches, seconds, torch.cuda.max_memory_allocated()


def serve_problems(res: dict, launches: dict, path: tuple,
                   batches: int, bar: float = 0.95,
                   bar_note: str = "") -> list[str]:
    problems = [f"{k} kernel never launched" for k in path
                if launches[k] == 0]
    if not res["accuracy_5cm5deg"] >= bar:
        problems.append(f"accuracy {res['accuracy_5cm5deg']} < {bar}"
                        + bar_note)
    if not res["poses_finite"]:
        problems.append("non-finite served pose")
    if not res["scores_finite"]:
        problems.append("non-finite hypothesis score")
    if "diffmap" in path and launches["diffmap"] != batches:
        problems.append(f"diffmap launched {launches['diffmap']} times for "
                        f"{batches} served batches")
    if res.get("variant") == "softam" and launches["refine_irls"] != batches:
        problems.append(f"refine_irls launched {launches['refine_irls']} "
                        f"times for {batches} served batches (one launch "
                        "refines a batch's averages)")
    return problems


def eval_problems(res: dict, launches: dict, path: tuple, absent: tuple,
                  frames: int, ref: float, lose: int) -> list[str]:
    """A test_ransac run of the SoftAM or variant phases: each kernel of
    ``path`` launched once a frame, none of ``absent``, finite results, and
    the accuracy at most ``lose`` frames below the reference's ``ref``."""
    problems = [f"{k} launched {launches[k]} times, not {frames}"
                for k in path if launches[k] != frames]
    problems += [f"{k} launched {launches[k]} times off its path"
                 for k in absent if launches[k]]
    bar = ref - lose / frames
    if not res["accuracy_5cm5deg"] >= bar:
        problems.append(f"accuracy {res['accuracy_5cm5deg']} < {bar} "
                        f"(reference {ref} less {lose} of {frames} frames)")
    if not (res["all_finite"] and all(math.isfinite(res[k]) for k in (
            "mean_expected_loss", "mean_entropy_bits"))):
        problems.append("non-finite per-frame result, expected loss or "
                        "entropy")
    return problems


def exported_pose_problems(res: dict, pose_dir: Path) -> list[str]:
    """Every exported pose file parsed back with parse_pose_file against
    the served pose: 1e-6 on R, 1e-6 m on t."""
    import numpy as np
    from dsac_tpu_torch.data.seven_scenes import parse_pose_file
    R, t = res["final"].R.cpu().double().numpy(), \
        res["final"].t.cpu().double().numpy()
    files = sorted(pose_dir.glob("frame-*.pose.txt"))
    if len(files) != len(R):
        return [f"{len(files)} pose files for {len(R)} frames"]
    worst_R = worst_t = 0.0
    for i, f in enumerate(files):
        if f.name != f"frame-{i:06d}.pose.txt":
            return [f"unexpected pose file {f.name}"]
        pR, pt = parse_pose_file(f)
        worst_R = max(worst_R, float(np.abs(pR - R[i]).max()))
        worst_t = max(worst_t, float(np.abs(pt - t[i] / 1000.0).max()))
    res["export_check"] = {"files": len(files), "max_abs_dR": worst_R,
                           "max_abs_dt_m": worst_t}
    if not (worst_R <= 1e-6 and worst_t <= 1e-6):
        return [f"exported poses: |dR| {worst_R} (bar 1e-6), |dt| "
                f"{worst_t} m (bar 1e-6)"]
    return []


def test_ransac_problems(res: dict, launches: dict, path: tuple,
                         frames: int) -> list[str]:
    problems = [f"{k} kernel never launched" for k in path
                if launches[k] == 0]
    for k, want in (("refine_irls", frames), ("diffmap", frames),
                    ("irls_stats", frames * STEPS)):
        if launches[k] != want:
            problems.append(f"{k} launched {launches[k]} times, not {want}")
    check = res["refine_check"]
    if not (check["served_max_abs_dt_mm"] <= STEPS_VS_FUSED_DT_MM
            and check["served_max_abs_dR"] <= STEPS_VS_FUSED_DR):
        problems.append(
            "stepwise refiner vs refine kernel at the served hypothesis: "
            f"|dt| {check['served_max_abs_dt_mm']} (bar "
            f"{STEPS_VS_FUSED_DT_MM} mm), |dR| {check['served_max_abs_dR']} "
            f"(bar {STEPS_VS_FUSED_DR})")
    bar = REF_TEST_RANSAC_ACCURACY - TEST_RANSAC_SLACK
    if not res["accuracy_5cm5deg"] >= bar:
        problems.append(f"accuracy {res['accuracy_5cm5deg']} < {bar} "
                        f"(reference {REF_TEST_RANSAC_ACCURACY} less 2 of "
                        "64 frames)")
    if not all(math.isfinite(res[k]) for k in ("mean_expected_loss",
                                               "mean_entropy_bits")):
        problems.append("non-finite expected loss or entropy")
    if not res["all_finite"]:
        problems.append("non-finite per-frame result")
    return problems


def train_grad(dev) -> tuple[dict, list[str]]:
    """Gradients of one full-width round, per refine mode, on fixture
    frame 0 with the trained weights and the same draws.

    DSAC's score gradient is p (loss - E[loss]) over the refined pool, and
    where the pool's hypotheses refine to one pose it is below f32
    resolution: f32 computations of it then disagree at random cosines
    (frame 0 is such a frame).  So on each of the first SCORE_FRAMES
    frames it is also computed with the refine kernel's plain version as
    the fixed point, in f32 and in f64, and the bar (cosine > 0.95,
    "implicit" against "unroll") is held on every frame where the plain
    f32 gradient meets its f64 twin at the bar; the phase fails if no
    frame does.  On the other frames the readings are reported only."""
    import torch
    from dsac_tpu_torch.config import DataConfig, DSACConfig, PoseConfig
    from dsac_tpu_torch.data.synthetic import SyntheticScene
    from dsac_tpu_torch.geometry.pose import Pose
    from dsac_tpu_torch.ops.gn_cuda import (InitSensitiveRefine,
                                            refine_pose_fused,
                                            refine_pose_fused_ref)
    from dsac_tpu_torch.pipeline import forward
    from dsac_tpu_torch.models.coord_net import coord_apply
    from dsac_tpu_torch.pipeline.train import e2e_expected_loss
    from dsac_tpu_torch.utils.params_io import (load_coord_net_npz,
                                                load_score_net_npz)

    data = DataConfig()
    cfg = DSACConfig(data=data, pose=PoseConfig(num_hypotheses=H,
                                                sample_attempts=T))
    scene = SyntheticScene(data.image_width, data.image_height,
                           data.focal_length, device=dev)
    coord_net = load_coord_net_npz(REPO / "artifacts" / "coord_e2e.npz", dev)
    score_net = load_score_net_npz(REPO / "artifacts" / "score_e2e.npz", dev)

    def plain_fixed_point(dtype):
        """The refine kernel's plain version in ``dtype``, in its place."""
        def refine(poses, coords, pix, cam, **kw):
            out, n_in = refine_pose_fused_ref(
                Pose(poses.R.to(dtype), poses.t.to(dtype)), coords.to(dtype),
                pix.to(dtype), cam, **kw)
            return Pose(out.R.float(), out.t.float()), n_in.float()
        return refine

    def run(softam: bool, mode: str, frame: int = 0, fixed_point=None):
        gt = Pose(scene.bench_poses.R[frame:frame + 1],
                  scene.bench_poses.t[frame:frame + 1])
        image = scene.render(gt)[0]
        coord_net.zero_grad()
        score_net.zero_grad()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if fixed_point is not None:
            forward.refine_pose_fused = fixed_point
        try:
            obj, aux = e2e_expected_loss(
                lambda im, pix: coord_apply(coord_net, im, pix),
                score_net, image, gt, data.camera(), cfg, softam=softam,
                refine_mode=mode,
                generator=torch.Generator(device=dev).manual_seed(7))
            obj.backward()
        finally:
            forward.refine_pose_fused = refine_pose_fused
        torch.cuda.synchronize()

        def flat(net):
            return torch.cat([q.grad.flatten() for q in net.parameters()])
        return {"objective": float(obj.detach()),
                "seconds": time.perf_counter() - t0,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                "entropy": float(aux["entropy"][0]),
                "valid_hyps": int(aux["valid_hyps"][0])}, flat(coord_net), \
            flat(score_net)

    out, problems = {}, []
    for softam, modes in ((False, ("implicit", "unroll")),
                          (True, ("implicit", "implicit_jnp"))):
        tag = "softam" if softam else "dsac"
        (ri, gci, gsi), (rj, gcj, gsj) = (run(softam, m) for m in modes)
        c_cos, c_ratio = cosine_ratio(gci, gcj)
        s_cos, s_ratio = cosine_ratio(gsi, gsj)
        out[tag] = {modes[0]: ri, modes[1]: rj, "coord_cos": c_cos,
                    "coord_ratio": c_ratio, "score_cos": s_cos,
                    "score_ratio": s_ratio,
                    "score_grad_norm": float(gsi.norm())}
        finite = all(bool(torch.isfinite(g).all())
                     for g in (gci, gsi, gcj, gsj))
        if not finite or not c_cos > 0.9:
            problems.append(f"{tag}: coordinate gradient cosine {c_cos} "
                            f"(bar > 0.9), finite {finite}")
        if softam:
            if not float(gsi.norm()) > 0.0:
                problems.append("softam: zero score gradient")
            # launches made to compare the backward with its plain
            # version are not the path's: the counters are put back
            counts = {fn: fn.launches for fn in (refine_pose_fused,
                                                 InitSensitiveRefine)}
            out[tag]["average_backward"] = softam_average_backward(
                dev, coord_net, score_net, scene, cfg, problems)
            for fn, n in counts.items():
                fn.launches = n
            continue
        if not abs(ri["objective"] - rj["objective"]) < 0.05 * (
                abs(rj["objective"]) + 1e-3):
            problems.append(f"dsac: objective {ri['objective']} vs "
                            f"{rj['objective']} (bar 5%)")
        frames = []
        for i in range(SCORE_FRAMES):
            gp32, gp64 = (run(False, "implicit", i, plain_fixed_point(d))[2]
                          for d in (torch.float32, torch.float64))
            if i > 0:
                gsi, gsj = (run(False, m, i)[2] for m in modes)
            f = {"frame": i,
                 "score_cos": cosine_ratio(gsi, gsj)[0],
                 "plain_f32_vs_f64": cosine_ratio(gp32, gp64)[0],
                 "kernel_vs_f64": cosine_ratio(gsi, gp64)[0],
                 "plain_f32_vs_unroll": cosine_ratio(gp32, gsj)[0],
                 "score_grad_norm": float(gsi.norm())}
            f["resolvable_in_f32"] = f["plain_f32_vs_f64"] > 0.95
            frames.append(f)
            if f["resolvable_in_f32"] and not (
                    f["score_cos"] > 0.95
                    and bool(torch.isfinite(gsi).all())):
                problems.append(f"dsac: score gradient cosine "
                                f"{f['score_cos']} on frame {i} (bar > "
                                "0.95)")
        out[tag]["score_frames"] = frames
        if not any(f["resolvable_in_f32"] for f in frames):
            problems.append("dsac: the score gradient is below f32 "
                            f"resolution on all of frames 0-"
                            f"{SCORE_FRAMES - 1}: nothing holds it")
    return out, problems


def softam_average_backward(dev, coord_net, score_net, scene, cfg,
                            problems: list) -> dict:
    """The refine kernel's init-pose backward at the main path's input:
    the softmax-averaged pose of SoftAM's forward (process_frame_softam,
    the draws of train_grad) on fixture frames 0-7 (frame 0 is
    train_grad's), refined for the default 8 x 2 = 16 steps, with the
    cotangent of the frame's maxLoss.  Per frame, the kernel's gradient in
    the averaged pose's tangent space against its plain version, in f32
    and in f64.  Where the plain f32 gradient misses its f64 twin (cosine
    < 0.999 or norm ratio outside 0.99-1.01) the average has converged
    within the 16 steps and the central differences are f32 rounding; the
    frame is counted as converged, with its reading (``sensitivity``: the
    f64 gradient's norm over that of the identity map, ~0 when converged,
    1 when frozen below min_inliers), and only held finite.  Every other frame is held at
    cosine >= 0.999 and norm ratio 0.99-1.01 against both."""
    import torch
    from dsac_tpu_torch.geometry.loss import max_loss
    from dsac_tpu_torch.geometry.pose import Pose
    from dsac_tpu_torch.geometry.rotation import so3_exp
    from dsac_tpu_torch.ops.gn_cuda import refine_init_sensitive
    from dsac_tpu_torch.pipeline.forward import (process_frame_softam,
                                                 softam_average)
    from dsac_tpu_torch.models.coord_net import coord_apply

    cam = cfg.data.camera()
    frames = []
    for i in range(8):
        gt = Pose(scene.bench_poses.R[i:i + 1], scene.bench_poses.t[i:i + 1])
        with torch.no_grad():
            res = process_frame_softam(
                scene.render(gt)[0],
                lambda im, pix: coord_apply(coord_net, im, pix),
                score_net, cam, cfg, refine_mode="implicit",
                generator=torch.Generator(device=dev).manual_seed(7))
            avg = softam_average(res.probs, res.hyps)
        pix = res.sampling.reshape(1, -1, 2).to(torch.float32).contiguous()

        def grad(route, dtype=torch.float32):
            v6 = torch.zeros(1, 1, 6, device=dev, dtype=dtype,
                             requires_grad=True)
            p = Pose(so3_exp(v6[..., :3]) @ avg.R[:, None].to(dtype),
                     avg.t[:, None].to(dtype) + v6[..., 3:])
            out = p if route == "identity" else refine_init_sensitive(
                p, res.coords.to(dtype), pix.to(dtype), cam,
                plain=route == "plain")
            max_loss(Pose(out.R[:, 0], out.t[:, 0]),
                     Pose(gt.R.to(dtype), gt.t.to(dtype))).sum().backward()
            return v6.grad[0, 0]

        gk, gp = grad("kernel"), grad("plain")
        g64, gi = grad("plain", torch.float64), grad("identity",
                                                     torch.float64)
        rounding = cosine_ratio(gp, g64)
        converged = not (rounding[0] >= 0.999
                         and 0.99 <= rounding[1] <= 1.01)
        n_in = float(res.inlier_counts[0, 0])
        f = {"frame": i, "soft_inliers": n_in,
             "frozen": n_in < cfg.pose.min_inliers,
             "sensitivity": float(g64.norm() / gi.norm()),
             "plain_vs_plain_f64": rounding,
             "kernel_vs_plain": cosine_ratio(gk, gp),
             "kernel_vs_plain_f64": cosine_ratio(gk, g64),
             "converged": converged}
        frames.append(f)
        held = converged or all(c >= 0.999 and 0.99 <= r <= 1.01
                                for c, r in (f["kernel_vs_plain"],
                                             f["kernel_vs_plain_f64"]))
        if not (held and bool(torch.isfinite(gk).all())):
            problems.append(f"softam average backward, frame {i}: {f}")
    return {"frames": frames,
            "converged_frames": sum(f["converged"] for f in frames),
            "frozen_frames": sum(f["frozen"] for f in frames),
            "bar": "per frame not converged: cosine >= 0.999 and norm "
                   "ratio 0.99-1.01 against plain and plain in f64; every "
                   "frame finite"}


def train_phase(softam: bool, arch: str = "dense",
                rounds: int = TRAIN_ROUNDS,
                scene: str = "room") -> tuple[dict, list[str]]:
    """``rounds`` rounds of train_ransac --arch ``arch`` --scene ``scene``
    from the trained weights (those of the archetype for another scene
    than the room), written as the port's init snapshots into a fresh
    runs/ directory; the end-to-end snapshots must read back as nets of
    the arch."""
    from dsac_tpu_torch.cli import train_ransac
    from dsac_tpu_torch.cli.common import ART_SUFFIX
    from dsac_tpu_torch.models import ScoreNet, coord_net_for_state
    from dsac_tpu_torch.utils import checkpoint as ckpt
    from dsac_tpu_torch.utils.params_io import (load_coord_net_npz,
                                                load_score_net_npz)

    suffix = ART_SUFFIX[arch] + ("" if scene == "room" else f"_{scene}")
    tag = ("softam" if softam else "e2e") + suffix
    out = REPO / "runs" / f"chip_smoke_train_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    art = REPO / "artifacts"
    for name, net in ((ckpt.OBJ_INIT, load_coord_net_npz(
            art / f"coord_e2e{suffix}.npz", "cpu", arch)),
                      (ckpt.SCORE_INIT, load_score_net_npz(
                          art / f"score_e2e{suffix}.npz", "cpu"))):
        ckpt.save(out, name, {"params": net.state_dict()})
    every = max(1, rounds // 2)
    res = train_ransac.main(
        ["--rounds", str(rounds), "--snapshot-every", str(every), "--out",
         str(out), "--device", "cuda", "--refine-mode", "auto", "--arch",
         arch, "--scene", scene] + (["--softam"] if softam else []))
    problems = []
    per_round = [r["launches"] for r in res["rounds"]]
    want_fwd, want_bwd = (2, 1) if softam else (1, 0)
    for r in res["rounds"]:
        if not (math.isfinite(r["objective"]) and r["grad_finite"]):
            problems.append(f"round {r['round']}: objective "
                            f"{r['objective']}, grad_finite "
                            f"{r['grad_finite']}")
        if (r["launches"]["refine_irls"] != want_fwd
                or r["launches"]["refine_init_backward"] != want_bwd):
            problems.append(f"round {r['round']}: launches {r['launches']}, "
                            f"want refine {want_fwd}, backward {want_bwd}")
    if res["refine_mode"] != "implicit" or len(res["rounds"]) != rounds:
        problems.append(f"mode {res['refine_mode']}, "
                        f"{len(res['rounds'])} rounds")
    obj_name = ckpt.OBJ_SOFTAM if softam else ckpt.OBJ_E2E
    score_name = ckpt.SCORE_SOFTAM if softam else ckpt.SCORE_E2E
    snap_c = ckpt.restore(out, obj_name)
    snap_s = ckpt.restore(out, score_name)
    coord_net_for_state(snap_c["params"], arch)
    ScoreNet().load_state_dict(snap_s["params"])
    want = sorted({*range(every, rounds + 1, every), rounds})
    if not (res["snapshots"] == want
            and snap_c["step"] == snap_s["step"] == rounds):
        problems.append(f"snapshots {res['snapshots']}, restored steps "
                        f"{snap_c['step']}, {snap_s['step']}")
    if res["scene"] != scene:
        problems.append(f"trained on scene {res['scene']}, not {scene}")
    summary = {k: res[k] for k in ("objective", "arch", "scene",
                                   "frame_set", "refine_mode",
                                   "ms_per_round_median", "first_round_ms",
                                   "peak_memory_bytes", "snapshots")}
    summary["launches_per_round"] = per_round
    summary["objectives"] = [r["objective"] for r in res["rounds"]]
    summary["grad_norms"] = [r["grad_norm"] for r in res["rounds"]]
    summary["valid_hyps"] = [r["valid_hyps"] for r in res["rounds"]]
    return summary, problems


def train_arch() -> tuple[dict, list[str]]:
    """train_phase for each of TRAIN_ARCHS, each with its counters set to
    0; returns the results by arch, with their launches."""
    from dsac_tpu_torch.cli import serve
    results, problems = {}, []
    for arch in TRAIN_ARCHS:
        (res, found), launches, seconds, peak = run_phase(
            lambda: train_phase(False, arch, TRAIN_ARCH_ROUNDS),
            serve.KERNELS)
        found += [f"{k} kernel never launched" for k in PATHS["train_arch"]
                  if launches[k] == 0]
        problems += [f"{arch}: {x}" for x in found]
        results[arch] = {"seconds": seconds, "launches": launches,
                         "phase_peak_memory_bytes": peak, **res}
    return results, problems


def scenes(dev) -> tuple[dict, list[str]]:
    """Each archetype at full size on the card, the first SCENE_FRAMES
    frames of seed 99: finite, RGB in [0, 255], depth > 0 but for the
    reference's own degenerate rays (at most one a frame; a ray component
    in (-1e-9, 0] exits through a wall behind the camera, as in the
    reference, tests/test_torch_scenes.py:frame_stats), and the statistics
    of data/scene_frames.json within SCENE_STAT_TOL."""
    import torch
    from dsac_tpu_torch.data.synthetic import (ARCHETYPES, SCENE_FIXTURE,
                                               Effects, frame_set,
                                               make_scene, render_frames)
    ref = json.loads(SCENE_FIXTURE.read_text())["stats"]
    results, problems = {}, []
    idx = list(range(SCENE_FRAMES))
    for name in ARCHETYPES:
        scene = make_scene(name, device=dev)
        fs = frame_set(scene, 99, SCENE_FRAMES)
        t0 = time.perf_counter()
        with torch.no_grad():
            rgb, depth, coords, pose = render_frames(scene, fs, idx)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            wall = scene.render(pose)[1]
            boxes = (scene.render(pose, Effects(fs.occluders, None, None))[1]
                     if fs.occluders is not None else wall)
        positive = depth > 0
        got = {"mean_rgb": float(rgb.double().mean()),
               "mean_depth_mm": float(depth[positive].double().mean()),
               "degenerate_pixels": int((~positive).sum()),
               "occluded_share": float((boxes < wall - 1.0).double().mean()),
               "gray_share": float(((rgb - 127.5).abs() < 4.0).all(-1)
                                   .double().mean())}
        found = []
        if not all(bool(torch.isfinite(x).all()) for x in (rgb, depth,
                                                           coords)):
            found.append("non-finite render")
        if not (float(rgb.min()) >= 0.0 and float(rgb.max()) <= 255.0):
            found.append("RGB outside [0, 255]")
        if got["degenerate_pixels"] > SCENE_FRAMES:
            found.append(f"{got['degenerate_pixels']} pixels of depth <= 0")
        for k, tol in SCENE_STAT_TOL.items():
            if k == "mean_rgb" and scene.knobs.texture_period_mm > 0:
                tol = PERIOD_RGB_TOL
            if not abs(got[k] - ref[name][k]) <= tol:
                found.append(f"{k} {got[k]} against the reference's "
                             f"{ref[name][k]} (bar {tol})")
        problems += [f"{name}: {x}" for x in found]
        results[name] = {"frame_set": fs.origin, "render_seconds": seconds,
                         **got, "reference": ref[name]}
    return results, problems


def eval_runs(runs: dict) -> tuple[dict, dict, list[str]]:
    """Entry-point runs of one phase, each with its counters set to 0:
    name -> (entry, argv, reference-accuracy key, path, kernels absent, or
    None for a serve run and its batches).  Returns the launches summed
    over the runs, each run's numbers, and the problems; each run may lose
    1 frame against REF_SCENE_ACCURACY."""
    from dsac_tpu_torch.cli import serve
    total, details, problems = {k: 0 for k in serve.KERNELS}, {}, []
    for name, (entry, argv, ref_key, path, absent) in runs.items():
        res, launches, seconds, peak = run_phase(lambda: entry(argv),
                                                 serve.KERNELS)
        for k, n in launches.items():
            total[k] += n
        ref, frames = REF_SCENE_ACCURACY[ref_key]
        if isinstance(absent, int):  # a serve run of ``absent`` batches
            found = serve_problems(res, launches, path, absent,
                                   ref - 1 / frames,
                                   f" (reference {ref} less 1 of {frames})")
        else:
            found = eval_problems(res, launches, path, absent, frames, ref,
                                  1)
        if res["frames"] != frames:
            found.append(f"{res['frames']} frames, not {frames}")
        problems += [f"{name}: {x}" for x in found]
        details[name] = {"seconds": seconds, "launches": launches,
                         "peak_memory_bytes": peak, "scene": res["scene"],
                         "frame_set": res["frame_set"],
                         "accuracy_5cm5deg": res["accuracy_5cm5deg"],
                         "reference_accuracy": ref,
                         **({"reloc_per_s": res["reloc_per_s"]}
                            if "reloc_per_s" in res else
                            {"tag": res["tag"],
                             "test_ransac_seconds": res["seconds"]})}
    return total, details, problems


def data_7scenes() -> tuple[dict, dict, list[str]]:
    """export_synthetic into a fresh runs/ directory, test_ransac on its
    test split with the room's weights, get_obj of 2 frames against the
    render's coordinates, and the PNG decoder that ran."""
    import numpy as np
    from dsac_tpu_torch.cli import export_synthetic, test_ransac
    from dsac_tpu_torch.cli.common import SyntheticSource
    from dsac_tpu_torch.config import DataConfig
    from dsac_tpu_torch.data.seven_scenes import SevenScenesDataset
    from dsac_tpu_torch.data.synthetic import make_scene
    from dsac_tpu_torch.utils import native_io
    out = REPO / "runs" / "chip_smoke_data"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    export_synthetic.main(["--out", str(out), "--train-frames",
                           str(EXPORT_TRAIN), "--test-frames",
                           str(EXPORT_TEST), "--device", "cuda"])
    export_seconds = time.perf_counter() - t0
    split = out / "test" / "synth"
    total, details, problems = eval_runs({"test_ransac": (
        test_ransac.main, ["--data", str(split), "-c",
                           str(out / "default.config"), "--fused-refine",
                           "--rdraw", "0", "--device", "cuda"],
        "data_7scenes", PATHS["data_7scenes"],
        ("soft_inlier_score", "p3p", "irls_stats"))})
    ds = SevenScenesDataset(split, config=DataConfig(raw_data=False))
    source = SyntheticSource(2, 99, make_scene("room", device="cuda"))
    errors = []
    for i in range(2):
        err = np.linalg.norm(ds.get_obj(i) - source.get(i).obj.cpu().numpy(),
                             axis=-1)[ds.get_depth(i) > 0]
        errors.append({"median_mm": float(np.median(err)),
                       "p95_mm": float(np.percentile(err, 95))})
        if not (errors[-1]["median_mm"] < OBJ_MEDIAN_MM
                and errors[-1]["p95_mm"] < OBJ_P95_MM):
            problems.append(f"get_obj({i}) against the render: "
                            f"{errors[-1]} (bars {OBJ_MEDIAN_MM}, "
                            f"{OBJ_P95_MM} mm)")
    # the export's row filters (adaptive, as PIL writes 7-Scenes-like
    # files), and the port's codec's host time to decode a frame of each
    # filter; the median of DECODE_REPS
    used = {}
    for sub in ("rgb_noseg", "depth_noseg"):
        counts = np.zeros(5, np.int64)
        for f in sorted((split / sub).glob("*.png")):
            rows = native_io.row_filters(f.read_bytes())
            counts += np.bincount(rows, minlength=5)
        used[sub] = dict(zip(DECODE_FILTERS, counts.tolist()))
    if not all(used[sub]["average"] + used[sub]["paeth"] > 0
               for sub in used):
        problems.append(f"the export has no average or Paeth rows: {used}")
    # and the average and Paeth rows of each encoding, which decide
    # whether the codec undoes it a row or a diagonal at a time
    decode_ms, slow_rows = {}, {}
    for image, sub in ((ds.get_rgb(0), "rgb"),
                       (ds.get_depth(0), "depth")):
        decode_ms[sub], slow_rows[sub] = {}, {}
        for kind, name in [*enumerate(DECODE_FILTERS),
                           ("adaptive", "adaptive")]:
            data = native_io.encode_png(image, kind)
            times = []
            for _ in range(DECODE_REPS):
                t0 = time.perf_counter()
                back = native_io.decode_png(data)
                times.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(back, image):
                problems.append(f"the codec's {sub} frame in filter {name} "
                                "does not decode to itself")
            decode_ms[sub][name] = float(np.median(times))
            slow_rows[sub][name] = int((native_io.row_filters(data)
                                        >= 3).sum())
    return total, {"export_seconds": export_seconds,
                   "decoder": native_io.decoder(), "get_obj": errors,
                   "export_row_filters": used, "decode_host_ms": decode_ms,
                   "decode_slow_rows": slow_rows,
                   **details["test_ransac"]}, problems


def train_scene() -> tuple[dict, dict, list[str]]:
    """TRAIN_SCENE_ROUNDS rounds of train_ransac --scene clutter (DSAC)
    and of train_ransac_softam --scene noisy, from the archetypes'
    weights, each with its counters set to 0."""
    from dsac_tpu_torch.cli import serve
    total, details, problems = {k: 0 for k in serve.KERNELS}, {}, []
    for name, softam, scene in (("dsac_clutter", False, "clutter"),
                                ("softam_noisy", True, "noisy")):
        (res, found), launches, seconds, peak = run_phase(
            lambda: train_phase(softam, "dense", TRAIN_SCENE_ROUNDS, scene),
            serve.KERNELS)
        path = ("refine_irls", "refine_init_backward") if softam else \
            ("refine_irls",)
        found += [f"{k} kernel never launched" for k in path
                  if launches[k] == 0]
        problems += [f"{name}: {x}" for x in found]
        for k, n in launches.items():
            total[k] += n
        details[name] = {"seconds": seconds, "launches": launches,
                         "phase_peak_memory_bytes": peak, **res}
    return total, details, problems


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
    from dsac_tpu_torch.cli import serve, test_ransac, test_ransac_softam
    from dsac_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    path, seconds = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": seconds, "library": path.name,
          "ptxas": _build.ptxas_report(path)})

    t0 = time.perf_counter()
    rows, failures, refine_check = check_kernels(dev)
    check_launches = {name: fn.launches for name, fn in serve.KERNELS.items()}
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "kernels": rows, "refine_check": refine_check,
          "failures": failures, "check_launches": check_launches})
    if failures:
        print("chip_smoke: kernel check failed: " + "; ".join(failures),
              file=sys.stderr)
        return 1

    serve_args = ["--synthetic", "64", "--verify-topk", "4", "--attempts",
                  "16", "--batch", "8", "--device", "cuda"]
    phases = {
        "serve": (serve.main, serve_args + ["--queue", "8", "--reps", "3"],
                  (1 + 3) * 8),
        "serve_cnn": (serve.main, serve_args + [
            "--queue", "8", "--reps", "3", "--no-fused-scoring"], (1 + 3) * 8),
        "serve_fixed_t": (serve.main, serve_args + [
            "--queue", "2", "--reps", "1", "--no-fused-scoring",
            "--no-two-phase"], (1 + 1) * 2),
        "test_ransac": (test_ransac.main, [
            "--synthetic", "64", "--fused-refine", "--rdraw", "0",
            "--check-refine", "--device", "cuda"], 64),
    }
    total = {k: 0 for k in serve.KERNELS}
    by_phase, results = {}, {}
    for name, (entry, argv, batches) in phases.items():
        res, launches, seconds, peak = run_phase(lambda: entry(argv),
                                                 serve.KERNELS)
        emit({"phase": name, "seconds": seconds, "launches": launches,
              "peak_memory_bytes": peak})
        results[name], by_phase[name] = res, launches
        for k, n in launches.items():
            total[k] += n
        find = (test_ransac_problems if name == "test_ransac"
                else serve_problems)
        problems = find(res, launches, PATHS[name], batches)
        if problems:
            print(f"chip_smoke: {name} failed: " + "; ".join(problems),
                  file=sys.stderr)
            return 1

    t0 = time.perf_counter()
    inlier = test_ransac.main(["--synthetic", "64", "--fused-refine",
                               "--rdraw", "0", "--select", "inlier",
                               "--device", "cuda"])
    emit({"phase": "test_ransac_select_inlier",
          "seconds": time.perf_counter() - t0,
          "accuracy_5cm5deg": inlier["accuracy_5cm5deg"]})
    # SoftAM serving: a batch's 8 averages refined in one launch of the
    # refine kernel (B = 8 x P = 1); name -> (argv, batches served in the
    # warm-up and timed passes, distinct frames, reference accuracy,
    # frames the phase may lose against it)
    softam_phases = {
        "serve_softam": (serve_args + ["--softam", "--queue", "8", "--reps",
                                       "1"], (1 + 1) * 8, 64,
                         REF_SERVE_SOFTAM_ACCURACY, 2),
        "serve_softam_cnn": (serve_args + [
            "--softam", "--no-fused-scoring", "--queue", "8", "--reps", "1"],
            (1 + 1) * 8, 64, REF_SERVE_SOFTAM_CNN_ACCURACY, 2),
    }
    for name, (argv, batches, frames, ref, lose) in softam_phases.items():
        res, launches, seconds, peak = run_phase(lambda: serve.main(argv),
                                                 serve.KERNELS)
        emit({"phase": name, "seconds": seconds, "launches": launches,
              "peak_memory_bytes": peak})
        results[name], by_phase[name] = res, launches
        for k, n in launches.items():
            total[k] += n
        bar = ref - lose / frames
        problems = serve_problems(res, launches, PATHS[name], batches, bar,
                                  f" (reference {ref} less {lose} of "
                                  f"{frames} frames)")
        if problems:
            print(f"chip_smoke: {name} failed: " + "; ".join(problems),
                  file=sys.stderr)
            return 1

    eval_args = ["--fused-refine", "--rdraw", "0", "--device", "cuda"]
    res, launches, seconds, peak = run_phase(
        lambda: test_ransac_softam.main(["--synthetic", "64"] + eval_args),
        serve.KERNELS)
    results["test_ransac_softam"] = res
    by_phase["test_ransac_softam"] = launches
    for k, n in launches.items():
        total[k] += n
    emit({"phase": "test_ransac_softam", "seconds": seconds,
          "launches": launches, "peak_memory_bytes": peak,
          "test_ransac_seconds": res["seconds"], "tag": res["tag"]})
    problems = eval_problems(res, launches, PATHS["test_ransac_softam"],
                             ("soft_inlier_score", "p3p"), 64,
                             REF_TEST_RANSAC_SOFTAM_ACCURACY, 2)
    if problems:
        print("chip_smoke: test_ransac_softam failed: " + "; ".join(problems),
              file=sys.stderr)
        return 1

    # the test_ransac variants, each with its counters set to 0; the
    # fused-scoring one also exports its poses
    pose_dir = REPO / "runs" / "smoke_poses"
    shutil.rmtree(pose_dir, ignore_errors=True)
    variants, phase_launches, problems = {}, {k: 0 for k in serve.KERNELS}, []
    for v, (flags, path, absent) in VARIANTS.items():
        export = (["--export-poses", str(pose_dir)]
                  if v == "fused_scoring" else [])
        res, launches, seconds, peak = run_phase(
            lambda: test_ransac.main(["--synthetic", str(VARIANT_FRAMES)]
                                     + eval_args + flags + export),
            serve.KERNELS)
        for k, n in launches.items():
            phase_launches[k] += n
        found = eval_problems(res, launches, path, absent, VARIANT_FRAMES,
                              REF_VARIANT_ACCURACY[v], 1)
        if export:
            found += exported_pose_problems(res, pose_dir)
        problems += [f"{v}: {x}" for x in found]
        variants[v] = {"seconds": seconds, "launches": launches,
                       "peak_memory_bytes": peak, "tag": res["tag"],
                       "accuracy_5cm5deg": res["accuracy_5cm5deg"],
                       "reference_accuracy": REF_VARIANT_ACCURACY[v],
                       **({"export_check": res["export_check"]}
                          if "export_check" in res else {})}
    by_phase["test_ransac_variants"] = phase_launches
    for k, n in phase_launches.items():
        total[k] += n
    emit({"phase": "test_ransac_variants", "frames": VARIANT_FRAMES,
          "launches": phase_launches, "variants": variants})
    if problems:
        print("chip_smoke: test_ransac_variants failed: "
              + "; ".join(problems), file=sys.stderr)
        return 1

    for name, fn in (("train_grad", lambda: train_grad(dev)),
                     ("train_ransac", lambda: train_phase(False)),
                     ("train_ransac_softam", lambda: train_phase(True))):
        (res, problems), launches, seconds, peak = run_phase(
            fn, serve.KERNELS)
        problems += [f"{k} kernel never launched" for k in PATHS[name]
                     if launches[k] == 0]
        emit({"phase": name, "seconds": seconds, "launches": launches,
              "phase_peak_memory_bytes": peak, **res})
        by_phase[name] = launches
        for k, n in launches.items():
            total[k] += n
        if problems:
            print(f"chip_smoke: {name} failed: " + "; ".join(problems),
                  file=sys.stderr)
            return 1

    # the coordinate-net archs: serving and test_ransac with the committed
    # s2d and patch weights, held to the reference's accuracy
    arch_phases = {
        "serve_s2d": (serve.main, serve_args + [
            "--arch", "dense_s2d", "--queue", "8", "--reps", "1"], 2 * 8),
        "serve_patch": (serve.main, serve_args + [
            "--arch", "patch", "--queue", "8", "--reps", "1"], 2 * 8),
        "serve_patch_cnn": (serve.main, serve_args + [
            "--arch", "patch", "--no-fused-scoring", "--queue", "8", "--reps",
            "1"], 2 * 8),
        "test_ransac_patch": (test_ransac.main, [
            "--synthetic", str(REF_ARCH_ACCURACY["test_ransac_patch"][1]),
            "--arch", "patch"] + eval_args, None),
    }
    for name, (entry, argv, batches) in arch_phases.items():
        res, launches, seconds, peak = run_phase(lambda: entry(argv),
                                                 serve.KERNELS)
        ref, frames = REF_ARCH_ACCURACY[name]
        emit({"phase": name, "seconds": seconds, "launches": launches,
              "peak_memory_bytes": peak, "arch": res["arch"],
              "accuracy_5cm5deg": res["accuracy_5cm5deg"],
              "reference_accuracy": ref,
              **({"tag": res["tag"], "test_ransac_seconds": res["seconds"]}
                 if batches is None else
                 {"reloc_per_s": res["reloc_per_s"]})})
        results[name], by_phase[name] = res, launches
        for k, n in launches.items():
            total[k] += n
        lose = 2 if frames == 64 else 1
        if batches is None:
            problems = eval_problems(res, launches, PATHS[name],
                                     ("soft_inlier_score", "p3p",
                                      "irls_stats"), frames, ref, lose)
            if "_patch_" not in res["tag"]:
                problems.append(f"tag {res['tag']} does not name the arch")
        else:
            problems = serve_problems(
                res, launches, PATHS[name], batches, ref - lose / frames,
                f" (reference {ref} less {lose} of {frames} frames)")
        if problems:
            print(f"chip_smoke: {name} failed: " + "; ".join(problems),
                  file=sys.stderr)
            return 1

    # dense_ctx has no committed weights: a fresh init from an empty --out
    ctx_out = REPO / "runs" / "chip_smoke_ctx"
    shutil.rmtree(ctx_out, ignore_errors=True)
    ctx_out.mkdir(parents=True)
    res, launches, seconds, peak = run_phase(lambda: serve.main([
        "--synthetic", str(CTX_FRAMES), "--verify-topk", "4", "--attempts",
        "16", "--batch", "8", "--queue", str(CTX_FRAMES // 8), "--reps",
        "1", "--device", "cuda", "--arch", "dense_ctx", "--out",
        str(ctx_out)]), serve.KERNELS)
    results["serve_ctx"], by_phase["serve_ctx"] = res, launches
    for k, n in launches.items():
        total[k] += n
    emit({"phase": "serve_ctx", "seconds": seconds, "launches": launches,
          "peak_memory_bytes": peak, "arch": res["arch"],
          "poses_finite": res["poses_finite"],
          "scores_finite": res["scores_finite"],
          "reloc_per_s": res["reloc_per_s"],
          "accuracy_5cm5deg_no_bar": res["accuracy_5cm5deg"]})
    problems = serve_problems(res, launches, PATHS["serve_ctx"],
                              2 * CTX_FRAMES // 8, 0.0)
    if problems:
        print("chip_smoke: serve_ctx failed: " + "; ".join(problems),
              file=sys.stderr)
        return 1

    arch_results, problems = train_arch()
    phase_launches = {k: sum(r["launches"][k] for r in arch_results.values())
                      for k in serve.KERNELS}
    by_phase["train_arch"] = phase_launches
    for k, n in phase_launches.items():
        total[k] += n
    emit({"phase": "train_arch", "rounds": TRAIN_ARCH_ROUNDS,
          "launches": phase_launches, "archs": arch_results})
    if problems:
        print("chip_smoke: train_arch failed: " + "; ".join(problems),
              file=sys.stderr)
        return 1

    # the data layer: the archetypes and a 7-Scenes-layout export
    (results_scenes, problems), launches, seconds, _peak = run_phase(
        lambda: scenes(dev), serve.KERNELS)
    by_phase["scenes"] = launches
    emit({"phase": "scenes", "seconds": seconds, "launches": launches,
          "frames": SCENE_FRAMES, "scenes": results_scenes})
    if problems:
        print("chip_smoke: scenes failed: " + "; ".join(problems),
              file=sys.stderr)
        return 1

    scene_args = ["--synthetic", "24", "--seed", "99", "--device", "cuda"]
    eval_scene = scene_args + ["--fused-refine", "--rdraw", "0"]
    art = REPO / "artifacts"

    def weights(arch_suffix: str, score: bool = True) -> list[str]:
        return (["--weights", str(art / f"coord_e2e{arch_suffix}.npz")]
                + (["--score-weights", str(art / f"score_e2e{arch_suffix}"
                                                ".npz")] if score else []))

    absent = ("soft_inlier_score", "p3p", "irls_stats")
    scene_phases = {
        "test_ransac_clutter": {
            "select_score": (test_ransac.main, eval_scene + [
                "--scene", "clutter"] + weights("_clutter"),
                "test_ransac_clutter", PATHS["test_ransac_clutter"], absent),
            "select_inlier": (test_ransac.main, eval_scene + [
                "--scene", "clutter", "--select", "inlier"]
                + weights("_clutter"), "test_ransac_clutter_select_inlier",
                PATHS["test_ransac_clutter"], absent)},
        "test_ransac_noisy": {"noisy": (test_ransac.main, eval_scene + [
            "--scene", "noisy"] + weights("_noisy"), "test_ransac_noisy",
            PATHS["test_ransac_noisy"], absent)},
        "test_ransac_repeat": {"repeat_soft_head": (
            test_ransac.main, eval_scene + ["--scene", "repeat",
                                            "--fused-scoring"]
            + weights("_repeat_t10b", score=False), "test_ransac_repeat",
            PATHS["test_ransac_repeat"], ("diffmap", "p3p", "irls_stats"))},
        "serve_scene": {
            "fused_soft": (serve.main, scene_args + [
                "--scene", "clutter", "--queue", "3", "--batch", "8",
                "--reps", "1"] + weights("_clutter"), "serve_scene",
                ("p3p", "soft_inlier_score", "refine_irls"), 2 * 3),
            "score_cnn": (serve.main, scene_args + [
                "--scene", "clutter", "--queue", "3", "--batch", "8",
                "--reps", "1", "--no-fused-scoring"] + weights("_clutter"),
                "serve_scene_cnn", ("p3p", "diffmap", "refine_irls"),
                2 * 3)},
    }
    scene_results = {}
    for name, runs in scene_phases.items():
        phase_launches, details, problems = eval_runs(runs)
        by_phase[name] = phase_launches
        for k, n in phase_launches.items():
            total[k] += n
        scene_results[name] = details
        emit({"phase": name, "launches": phase_launches, "runs": details})
        if problems:
            print(f"chip_smoke: {name} failed: " + "; ".join(problems),
                  file=sys.stderr)
            return 1
    for name, fn in (("data_7scenes", data_7scenes),
                     ("train_scene", train_scene)):
        phase_launches, details, problems = fn()
        by_phase[name] = phase_launches
        for k, n in phase_launches.items():
            total[k] += n
        scene_results[name] = details
        emit({"phase": name, "launches": phase_launches, **details})
        if problems:
            print(f"chip_smoke: {name} failed: " + "; ".join(problems),
                  file=sys.stderr)
            return 1

    emit({"phase": "summary",
          "reloc_per_s": {k: results[k]["reloc_per_s"]
                          for k in ("serve", "serve_cnn", "serve_fixed_t",
                                    "serve_softam", "serve_softam_cnn",
                                    "serve_s2d", "serve_patch",
                                    "serve_patch_cnn", "serve_ctx")},
          "accuracy_5cm5deg": {
              **{k: results[k]["accuracy_5cm5deg"] for k in results},
              **{f"test_ransac_{v}": x["accuracy_5cm5deg"]
                 for v, x in variants.items()}},
          "test_ransac_accuracy_select_inlier": inlier["accuracy_5cm5deg"],
          "scene_accuracy_5cm5deg": {
              f"{phase}.{run}": x["accuracy_5cm5deg"]
              for phase, runs in scene_results.items()
              if phase.startswith(("test_ransac", "serve"))
              for run, x in runs.items()},
          "data_7scenes_accuracy_5cm5deg":
              scene_results["data_7scenes"]["accuracy_5cm5deg"],
          "reference_accuracy": {
              "test_ransac": REF_TEST_RANSAC_ACCURACY,
              "serve_softam": REF_SERVE_SOFTAM_ACCURACY,
              "serve_softam_cnn": REF_SERVE_SOFTAM_CNN_ACCURACY,
              "test_ransac_softam": REF_TEST_RANSAC_SOFTAM_ACCURACY,
              **{f"test_ransac_{v}": x
                 for v, x in REF_VARIANT_ACCURACY.items()},
              **{k: ref for k, (ref, _n) in REF_ARCH_ACCURACY.items()},
              **{k: ref for k, (ref, _n) in REF_SCENE_ACCURACY.items()}}})

    for row in rows:
        row["launches"] = total[row["name"]]
        row["launches_by_phase"] = {k: v[row["name"]]
                                    for k, v in by_phase.items()}
        row["check_launches"] = check_launches[row["name"]]
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
