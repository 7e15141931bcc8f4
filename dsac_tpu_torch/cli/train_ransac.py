"""End-to-end DSAC training on one GPU (port of dsac_tpu/cli/train_ransac.py,
its single-chip loop, :391-404).

Each round takes one training frame chosen at random: of ``--data`` (a
7-Scenes-layout split; ``-c DIR/default.config`` and the reference's
short flags set its intrinsics and ``rd``), or of the ``--synthetic``
frames of the archetype ``--scene`` of the frame set of ``--seed``
(cli/common.py; for the default seed 1305 the views that ``random_pose``
draws from it, rendered with the scene's effects, which are the same
each time a frame comes round).  It takes one joint SGD step of both
nets on the
objective of ``--softam`` or DSAC (pipeline/train.py:e2e_step): SGD 1e-5
for the coordinate net and 1e-7 for the score net, momentum 0.9, global
norm clip 10, coordinate gradients clamped at +-0.1.  The nets start from
the port's ``obj_model_init`` and ``score_model_init`` snapshots in
``--out`` (utils/checkpoint.py), or else from a random init of a seeded
generator.  A run resumes from its own snapshots: parameters, optimizer
states, the round and the numpy generator of the view schedule.  With
``--validate-every`` the nets are evaluated on ``--validate-frames``
frames of the same scene of seed 777 (with ``--data``, the training
frames, as the reference does), and ``*_best`` snapshots keep the best.

The reference's ``--mesh``, ``--steps-per-call``, ``--stage-frames``,
``--score-head soft`` and ``--score-temp`` are not ported and are refused
(ROADMAP.md).  ``--arch`` picks the coordinate net (cli/common.py; an
``obj_model_init`` snapshot of another arch is an error), and
``--width-mult`` and ``--hypotheses`` scale freshly initialised nets and
the pool (the reference's ``--width-mult`` and ``-rI``).

Prints one JSON line: per-round objective, expected loss, entropy, valid
hypotheses, gradient statistics, seconds and kernel launches, the median
ms per round after the first, peak device memory, and the snapshots.

    python -m dsac_tpu_torch.cli.train_ransac --rounds 100
    python -m dsac_tpu_torch.cli.train_ransac --softam --rounds 100
    python -m dsac_tpu_torch.cli.train_ransac --arch patch --rounds 100
    python -m dsac_tpu_torch.cli.train_ransac --scene clutter --rounds 100
    python -m dsac_tpu_torch.cli.train_ransac --data DIR/training/synth \
        -c DIR/default.config --rounds 100
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from dsac_tpu_torch import resolve_device
from dsac_tpu_torch.cli.common import (SyntheticSource, add_arch_args,
                                       add_data_args, coord_fn_for,
                                       frame_source)
from dsac_tpu_torch.cli.serve import KERNELS
from dsac_tpu_torch.config import DSACConfig
from dsac_tpu_torch.flags import parse_with_flags
from dsac_tpu_torch.models import (ScoreNet, coord_net_for_state,
                                   init_like_flax, load_exact)
from dsac_tpu_torch.models.coord_net import coord_apply, make_coord_net
from dsac_tpu_torch.pipeline import evaluate_frame, process_frames_batched
from dsac_tpu_torch.pipeline.train import e2e_step, make_e2e_state
from dsac_tpu_torch.utils import checkpoint as ckpt
from dsac_tpu_torch.utils.logging import TrainingLog, blue, green

NOT_PORTED = ("--mesh", "--steps-per-call", "--stage-frames", "--score-head",
              "--score-temp")
VALIDATION_SEED = 777  # train_ransac.py:191


def parse_args(argv=None, softam: bool = False) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--training-rounds", type=int, default=5000,
                    help="reference: 5000 (train_ransac.cpp:50)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="overrides --training-rounds")
    ap.add_argument("--softam", action="store_true", default=softam)
    ap.add_argument("--snapshot-every", type=int, default=250)
    ap.add_argument("--validate-every", type=int, default=0)
    ap.add_argument("--validate-frames", type=int, default=8)
    ap.add_argument("--refine-mode",
                    choices=["auto", "unroll", "implicit", "implicit_jnp"],
                    default="auto",
                    help="pipeline/forward.py:make_refiners; auto is "
                         "implicit on CUDA and unroll on the CPU")
    ap.add_argument("--score-anchor", type=float, default=0.0)
    add_data_args(ap, synthetic=16, seed=1305)
    add_arch_args(ap)
    ap.add_argument("--hypotheses", type=int, default=None,
                    help="hypotheses a frame; default: the reference's "
                         "-rI, else 256")
    ap.add_argument("--out", default="./out")
    ap.add_argument("--device", default="cuda")
    given = sys.argv[1:] if argv is None else argv
    refused = [a for a in given if a.split("=")[0] in NOT_PORTED]
    if refused:
        raise SystemExit(f"{', '.join(refused)}: not ported to "
                         "dsac_tpu_torch (ROADMAP.md)")
    args, cfg, _strings = parse_with_flags(ap, argv)
    args.cfg = DSACConfig(data=cfg.data, pose=dataclasses.replace(
        cfg.pose, num_hypotheses=args.hypotheses or cfg.pose.num_hypotheses))
    if args.rounds is not None:
        args.training_rounds = args.rounds
    if args.score_anchor > 0 and args.softam:
        raise SystemExit("--score-anchor is not implemented for the "
                         "softam objective")
    return args


def _init_net(out: str, name: str, fresh: torch.nn.Module, load,
              seed: int, device: torch.device) -> torch.nn.Module:
    """The net that ``load`` builds from the parameters of snapshot
    ``name`` in ``out``, else ``fresh`` with Flax's default init drawn
    from a generator seeded with ``seed`` (train_ransac.py:87-122 seeds 1
    and 2)."""
    try:
        net = load(ckpt.restore(out, name)["params"])
        print(blue(f"Loaded {name}."))
    except FileNotFoundError:
        print(blue(f"No {name}; initialising."))
        net = init_like_flax(fresh, torch.Generator().manual_seed(seed))
    return net.to(device)


def _snapshot(out: str, name: str, net, opt, step: int, keep: int = 3):
    ckpt.save(out, name, {"params": net.state_dict(),
                          "opt_state": opt.state_dict(), "step": step},
              step=step, keep=keep)


def main(argv=None, softam: bool = False) -> dict:
    args = parse_args(argv, softam)
    device = resolve_device(args.device)
    cfg = args.cfg
    cam = cfg.data.camera()
    source = frame_source(args, cfg, device)
    rng = np.random.default_rng(args.seed)

    wm = args.width_mult
    coord_net = _init_net(
        args.out, ckpt.OBJ_INIT, make_coord_net(args.arch, wm),
        lambda params: coord_net_for_state(params, args.arch), 1, device)
    score_net = _init_net(
        args.out, ckpt.SCORE_INIT, ScoreNet(width_mult=wm),
        lambda params: load_exact(ScoreNet(width_mult=wm), params), 2,
        device)
    state = make_e2e_state(coord_net, score_net)

    refine_mode = args.refine_mode
    if refine_mode == "auto":
        refine_mode = "implicit" if device.type == "cuda" else "unroll"
    print(blue(f"Refinement gradient mode: {refine_mode}"))
    coord_apply_ = functools.partial(coord_apply,
                                     patch_size=cfg.net.rgb_patch_size)

    obj_name = ckpt.OBJ_SOFTAM if args.softam else ckpt.OBJ_E2E
    score_name = ckpt.SCORE_SOFTAM if args.softam else ckpt.SCORE_E2E
    sidecar = Path(args.out) / f"rng_state_{obj_name}.json"
    best = {"acc": -1.0, "exp": float("inf")}
    start = 0
    try:
        snap_c = ckpt.restore(args.out, obj_name, map_location=device)
        snap_s = ckpt.restore(args.out, score_name, map_location=device)
        coord_net.load_state_dict(snap_c["params"])
        score_net.load_state_dict(snap_s["params"])
        state.coord_opt.load_state_dict(snap_c["opt_state"])
        state.score_opt.load_state_dict(snap_s["opt_state"])
        state.step = start = int(snap_c["step"])
        if sidecar.exists():
            saved = json.loads(sidecar.read_text())
            if saved.get("round") == start:
                rng.bit_generator.state = saved["state"]
            best.update(saved.get("best", {}))
        print(blue(f"Resumed end-to-end training at round {start}."))
    except FileNotFoundError:
        pass

    def write_sidecar(rnd: int) -> None:
        sidecar.write_text(json.dumps(
            {"round": rnd, "state": rng.bit_generator.state, "best": best}))

    # the same scene as training (the archetypes), views of another seed
    val_source = (source if args.data else SyntheticSource(
        args.validate_frames, VALIDATION_SEED, source.scene))

    def validate() -> tuple[float, float]:
        correct, exps = [], []
        with torch.no_grad():
            for i in range(min(args.validate_frames, len(val_source))):
                image, gt = val_source.batch([i])
                gen = torch.Generator(device=device).manual_seed(7000 + i)
                res = process_frames_batched(
                    image,
                    coord_fn_for(coord_net, cfg),
                    cam, cfg, generator=gen, scoring="cnn",
                    score_fn=score_net, sampling=False, refine_all=True,
                    fused_refine=False)
                ev = evaluate_frame(res, gt)
                correct.append(bool(ev.correct[0]))
                exps.append(float(ev.expected_loss[0]))
        return float(np.mean(correct)), float(np.mean(exps))

    tag = "softam" if args.softam else "e2e"
    log = TrainingLog(Path(args.out) / f"ransac_training_loss_{tag}.txt")
    val_log = TrainingLog(Path(args.out) / f"ransac_validation_{tag}.txt")
    print(blue(f"End-to-end training ({tag}) for {args.training_rounds} "
               "rounds."))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rounds, snapshots = [], []
    with log, val_log:
        for rnd in range(start, args.training_rounds):
            i = int(rng.integers(len(source)))
            gen = torch.Generator(device=device).manual_seed(
                int(rng.integers(2 ** 31)))
            before = {k: w.launches for k, w in KERNELS.items()}
            t0 = time.perf_counter()
            image, gt = source.batch([i])
            state, loss, aux = e2e_step(
                state, image, gt, cam, cfg, coord_apply=coord_apply_,
                softam=args.softam,
                refine_mode=refine_mode, score_anchor=args.score_anchor,
                generator=gen)
            rec = {"round": rnd, "objective": float(loss),
                   **{k: float(v.float().mean()) for k, v in aux.items()
                      if k not in ("grad_finite",)},
                   "grad_finite": bool(aux["grad_finite"]),
                   "seconds": time.perf_counter() - t0,
                   "launches": {k: w.launches - before[k]
                                for k, w in KERNELS.items()}}
            rounds.append(rec)
            log.append(rnd, rec["objective"], {
                "expected": rec["expected_loss"],
                "entropy": rec["entropy"], "valid": rec["valid_hyps"]})
            if rnd % 10 == 0:
                print(f"round {rnd}: E[loss] {rec['objective']:.3f} "
                      f"entropy {rec['entropy']:.2f} "
                      f"valid {int(rec['valid_hyps'])}")
            if (args.validate_every > 0
                    and (rnd + 1) % args.validate_every == 0):
                acc, exp = validate()
                val_log.append(rnd, exp, {"accuracy": acc})
                print(blue(f"validation @ round {rnd}: accuracy "
                           f"{acc * 100:.1f}%, E[loss] {exp:.2f}"))
                if (acc, -exp) > (best["acc"], -best["exp"]):
                    best.update(acc=acc, exp=exp)
                    _snapshot(args.out, score_name + "_best", score_net,
                              state.score_opt, state.step, keep=1)
                    _snapshot(args.out, obj_name + "_best", coord_net,
                              state.coord_opt, state.step, keep=1)
                    write_sidecar(rnd + 1)
            if ((rnd + 1) % args.snapshot_every == 0
                    or rnd == args.training_rounds - 1):
                _snapshot(args.out, score_name, score_net, state.score_opt,
                          state.step)
                _snapshot(args.out, obj_name, coord_net, state.coord_opt,
                          state.step)
                write_sidecar(rnd + 1)
                snapshots.append(rnd + 1)
    print(green("End-to-end training complete."))

    later = [r["seconds"] * 1e3 for r in rounds[1:]]
    result = {
        "metric": "train_ransac", "objective": tag, "arch": args.arch,
        "scene": source.name,
        "frame_set": source.frame_set, "frames": len(source),
        "refine_mode": refine_mode, "start_round": start,
        "rounds": rounds, "snapshots": snapshots,
        "ms_per_round_median": statistics.median(later) if later else None,
        "first_round_ms": rounds[0]["seconds"] * 1e3 if rounds else None,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "launches": {k: sum(r["launches"][k] for r in rounds)
                     for k in KERNELS},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
