"""Inputs for holding the CUDA kernels against their plain versions and
timing them on the card, made on the device from a ``torch.Generator``,
and the shapes the main path gives the refine, P3P, score, diff-map and
IRLS-stats kernels.  Shared by ``chip_smoke.py`` and
``cli/profile_kernels.py``."""

from __future__ import annotations

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose, invert, transform
from dsac_tpu_torch.geometry.projection import project
from dsac_tpu_torch.geometry.rotation import so3_exp
from dsac_tpu_torch.ops.gn_cuda import init_probes
from dsac_tpu_torch.ops.p3p_cuda import p3p_solve
from dsac_tpu_torch.ops.sampling import gather_rows

# A serve batch: 8 frames of N pixels, 256 hypotheses a frame, two-phase
# sampling's 32 survivors of 16 attempts, the verified top 4; a
# refinement is 16 IRLS steps (8 reweightings x 2 GN steps).
FRAMES, N, HYPS, SURVIVORS, ATTEMPTS, TOPK = 8, 1600, 256, 32, 16, 4
STEPS = 16

# The refine kernel's regimes on the main path: (frames, poses a frame).
REFINE_REGIMES = {
    "softam_forward": (1, 1),  # SoftAM's averaged pose
    "softam_serve": (FRAMES, 1),  # a SoftAM serve batch's 8 averages
    "softam_backward": (1, 12),  # the 12 probes of its init-pose backward
    "serve_top4": (FRAMES, TOPK),  # a serve batch's verified top 4
    "test_ransac": (1, HYPS),  # refine-all of one frame; a DSAC round
    "refine_all": (FRAMES, HYPS),  # refine-all of a batch
}
# The P3P kernel's shapes: attempt lanes a frame of a serve batch.
P3P_SHAPES = {
    "serve_phase1": HYPS,  # two-phase sampling, phase 1
    "serve_phase2": SURVIVORS * (ATTEMPTS - 1),  # its phase 2
    "fixed_t": HYPS * ATTEMPTS,  # fixed-T sampling
}
# The score kernel's shapes: (frames, hypotheses a frame).
SCORE_SHAPES = {
    "serve": (FRAMES, HYPS),  # a fused-soft serve batch
    # the large-H regime the TPU kernel was written for
    # (dsac_tpu/ops/diffmap_pallas.py:1-16, scripts/bench_large_h.py)
    "large_h": (FRAMES, 4096),
}
# The diff-map kernel's shapes: (frames, hypotheses a frame).
DIFFMAP_SHAPES = {
    "serve": (FRAMES, HYPS),  # a score-CNN or fixed-T serve batch
    "test_ransac": (1, HYPS),  # one test_ransac frame
}
# The IRLS-stats kernel's shapes: (frames, poses a frame).
IRLS_STATS_SHAPES = {
    # a pass of the stepwise refiner, 16 a frame under test_ransac
    # --check-refine
    "test_ransac": (1, HYPS),
    "refine_all": (FRAMES, HYPS),  # a refine-all batch
}
# The IRLS statistics' bars against their plain version
# (tests/test_gn_pallas.py:46-55), per part of ops/gn_cuda.py:unpack_stats:
# (part, rtol, atol).
IRLS_BARS = (("JtJ", 2e-3, 2.0), ("Jtr", 2e-3, 2.0), ("n_in", 1e-3, 0.05))


def make_problem(B: int, N: int, dev, gen: torch.Generator
                 ) -> tuple[Camera, Pose, torch.Tensor, torch.Tensor]:
    """B frames of N scene coordinates seen from known poses: 4 mm noise
    and 30% uniform outliers, pixels where the true points project.
    Returns (camera, the known poses (B,), coords (B, N, 3), pix (B, N,
    2))."""
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


def reference_problem(B: int, H: int, N: int, dev, gen: torch.Generator
                      ) -> tuple[torch.Tensor, ...]:
    """B frames of H poses and N points, drawn as the reference's kernel
    tests draw them (tests/test_pallas_kernels.py:_random_problem,
    tests/test_gn_pallas.py:_problem): every point 1-4 m in front of the
    camera.  Returns (R (B, H, 3, 3), t (B, H, 3), coords, pix)."""
    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    R = so3_exp(torch.randn(B, H, 3, generator=gen, device=dev) * 0.5)
    t = torch.randn(B, H, 3, generator=gen, device=dev) * 300.0
    t[..., 2] -= 2500.0
    coords = torch.stack([uniform(-1000, 1000, B, N),
                          uniform(-800, 800, B, N),
                          uniform(-500, 500, B, N)], dim=-1)
    pix = torch.stack([uniform(0, 640, B, N), uniform(0, 480, B, N)], dim=-1)
    return R.contiguous(), t.contiguous(), coords.contiguous(), pix


def near_poses(gt: Pose, P: int, gen: torch.Generator, rad: float = 0.005,
               mm: float = 15.0) -> Pose:
    """P poses (B, P) around each known pose: a rotation of ``rad`` and a
    translation of ``mm`` standard deviation per axis."""
    B, dev = gt.t.shape[0], gt.t.device
    pert = so3_exp(torch.randn(B, P, 3, generator=gen, device=dev) * rad)
    return Pose((pert @ gt.R[:, None]).contiguous(),
                (gt.t[:, None] + torch.randn(B, P, 3, generator=gen,
                                             device=dev) * mm).contiguous())


def attempt_sets(coords: torch.Tensor, pix: torch.Tensor, lanes: int,
                 gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """``lanes`` random 4-point sets of every frame, flattened: obj
    (B * lanes, 4, 3), img (B * lanes, 4, 2)."""
    B, N = coords.shape[:2]
    idx = torch.randint(0, N, (B, lanes, 4), generator=gen,
                        device=coords.device)
    return (gather_rows(coords, idx).reshape(-1, 4, 3).contiguous(),
            gather_rows(pix, idx).reshape(-1, 4, 2).contiguous())


def regime_poses(name: str, gt: Pose, pool: Pose, gen: torch.Generator
                 ) -> Pose:
    """The poses of refine regime ``name`` (REFINE_REGIMES) for the first
    frames of known poses ``gt``: the 12 init probes of one near pose
    for SoftAM's backward; the first frames of ``pool`` (the phase-1
    P3P pool, HYPS poses a frame) for refine-all; near poses otherwise."""
    nb, P = REFINE_REGIMES[name]
    frames = Pose(gt.R[:nb], gt.t[:nb])
    if name == "softam_backward":
        return init_probes(*near_poses(frames, 1, gen))
    if P == HYPS:
        return Pose(pool.R[:nb].contiguous(), pool.t[:nb].contiguous())
    return near_poses(frames, P, gen)


def hypothesis_pool(coords: torch.Tensor, pix: torch.Tensor, H: int,
                    cam: Camera, gen: torch.Generator) -> Pose:
    """H P3P hypotheses (B, H) of every frame, each from a random 4-point
    set, as sampling draws them: valid and invalid lanes alike."""
    B = coords.shape[0]
    pool = p3p_solve(*attempt_sets(coords, pix, H, gen), cam)[0]
    return Pose(pool.R.reshape(B, H, 3, 3).contiguous(),
                pool.t.reshape(B, H, 3).contiguous())
