"""The reprojection-error surface and fused soft-inlier scoring: the CUDA
kernels (csrc/diffmap.cu, csrc/score.cu) and their plain PyTorch versions.

Ports of dsac_tpu/ops/diffmap_pallas.py:diffmaps_pallas and
soft_inlier_scores_pallas, with a leading frame axis: each frame has its
own pixels and coordinates, and one launch serves every hypothesis of
every frame.  Each wrapper counts its kernel launches in its
``launches`` attribute.  ``score_layout`` and ``diffmap_layout`` pick each
kernel's layout from the launch's size and the card's SM count;
``launch_score`` and ``launch_diffmap`` launch in a given layout, uncounted.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.ops import _build
from dsac_tpu_torch.ops.diffmap import diffmaps as diffmaps_plain
from dsac_tpu_torch.ops.diffmap import soft_inlier_scores as _from_diffmaps
from dsac_tpu_torch.ops.gn_cuda import SMEM_LIMIT_BYTES

MAX_THREADS = 1024  # both kernels' __launch_bounds__


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ScoreLayout(NamedTuple):
    """How csrc/score.cu lays a launch out: a CTA holds ``hyps_per_cta``
    hypotheses of one frame, each split over ``warps_per_hyp`` warps, and
    stages the frame's pixels in shared memory ``tile`` at a time."""

    hyps_per_cta: int
    warps_per_hyp: int
    tile: int

    @property
    def threads(self) -> int:
        return self.hyps_per_cta * self.warps_per_hyp * 32


# the pixel tiles csrc/score.cu is compiled for (its SoA stride): small
# frames, and frames of up to 2,048 pixels (N = 1,600 on the main path)
# staged whole; larger frames go 2,048 pixels at a time
SCORE_TILES = (256, 2048)
# score_layout's aims: CTAs of SCORE_CTA_WARPS warps (the H100 holds one
# an SM at the kernel's register count); each hypothesis as many warps (a
# power of two, at most SCORE_MAX_WARPS_PER_HYP) as keep one such CTA an
# SM; where one warp a hypothesis already does, the first design's CTA of
# SCORE_ONE_WARP_HYPS hypotheses
SCORE_CTA_WARPS = 32
SCORE_MAX_WARPS_PER_HYP = 8
SCORE_ONE_WARP_HYPS = 8


def score_tile(N: int) -> int:
    """The smallest tile of SCORE_TILES that holds N pixels, else the
    largest."""
    return next((t for t in SCORE_TILES if t >= N), SCORE_TILES[-1])


def score_smem_bytes(layout: ScoreLayout) -> int:
    """Shared memory of one CTA: the pixel tile (x, y, z, u, v as float32)
    and one partial sum a warp."""
    return 4 * (5 * layout.tile + layout.hyps_per_cta * layout.warps_per_hyp)


def check_score_layout(layout: ScoreLayout) -> None:
    """Raise ValueError unless csrc/score.cu takes ``layout``."""
    g, w, tile = layout
    problems = []
    if g < 1 or w < 1 or layout.threads > MAX_THREADS:
        problems.append(f"{g} hypotheses x {w} warps a CTA is not 1 to "
                        f"{MAX_THREADS} threads")
    if tile not in SCORE_TILES:
        problems.append(f"tile {tile} is not one of {SCORE_TILES}")
    if score_smem_bytes(layout) > SMEM_LIMIT_BYTES:
        problems.append(f"{score_smem_bytes(layout)} bytes of shared memory "
                        f"a CTA, more than {SMEM_LIMIT_BYTES}")
    if problems:
        raise ValueError(f"score layout {tuple(layout)}: "
                         + "; ".join(problems))


@functools.cache  # a pure function, on the launch path
def score_layout(B: int, H: int, N: int, sm_count: int) -> ScoreLayout:
    """The score kernel's layout for B frames of H hypotheses against N
    pixels a frame on a card of ``sm_count`` SMs: CTAs of SCORE_CTA_WARPS
    warps; each hypothesis as many warps (a power of two, at most
    SCORE_MAX_WARPS_PER_HYP) as keep the launch within one such CTA an SM;
    where one warp a hypothesis already fills that, CTAs of
    SCORE_ONE_WARP_HYPS hypotheses x 1 warp, the first design's shape; the
    whole frame staged at once where a tile of SCORE_TILES holds it.  At
    N = 1,600 on the H100 that is 16 hypotheses x 2 warps at a serve
    batch's 8 x 256, the fastest layout of the sweep there
    (``cli/profile_kernels.py --sweep``, PERF.md), and 8 x 1 at 8 x 4,096,
    where no layout beat the first design by more than the card's spread
    from call to call."""
    w = 1
    while (w < SCORE_MAX_WARPS_PER_HYP
           and B * H * w * 2 <= SCORE_CTA_WARPS * sm_count):
        w *= 2
    g = SCORE_ONE_WARP_HYPS if w == 1 else SCORE_CTA_WARPS // w
    g = max(1, min(g, H))
    layout = ScoreLayout(g, w, score_tile(N))
    check_score_layout(layout)
    return layout


def score_grid(layout: ScoreLayout, B: int, H: int) -> tuple[int, int]:
    """The score kernel's grid: (CTAs a frame, frames)."""
    return _cdiv(H, layout.hyps_per_cta), B


class DiffmapLayout(NamedTuple):
    """How csrc/diffmap.cu lays a launch out: a CTA of ``threads`` threads
    covers ``vec * threads`` consecutive pixels (``vec`` a thread: 4, one
    float4 store, or 1) of ``hyps_per_cta`` hypotheses of one frame."""

    hyps_per_cta: int
    threads: int
    vec: int


# diffmap_layout's aims: about DIFFMAP_WARPS_PER_SM warps of work an SM: 4
# pixels a thread (one float4 store) where DIFFMAP_TILE_HYPS hypotheses a
# CTA give that many, else 1; then as many hypotheses a CTA (a power of
# two, at most DIFFMAP_TILE_HYPS) as still do; CTAs of
# DIFFMAP_THREADS[vec] threads
DIFFMAP_THREADS = {4: 512, 1: 128}
DIFFMAP_TILE_HYPS = 8
DIFFMAP_WARPS_PER_SM = 24
# the kernel's limit: the tile's poses, 48 bytes each, in 48 KB
DIFFMAP_MAX_HYPS_PER_CTA = 1024


def diffmap_smem_bytes(layout: DiffmapLayout) -> int:
    """Shared memory of one CTA: its hypotheses' poses, 12 float32 each."""
    return 48 * layout.hyps_per_cta


def check_diffmap_layout(layout: DiffmapLayout, N: int) -> None:
    """Raise ValueError unless csrc/diffmap.cu takes ``layout`` at N
    pixels a frame."""
    g, threads, vec = layout
    problems = []
    if not 1 <= g <= DIFFMAP_MAX_HYPS_PER_CTA:
        problems.append(f"{g} hypotheses a CTA is not 1 to "
                        f"{DIFFMAP_MAX_HYPS_PER_CTA}")
    if not (32 <= threads <= MAX_THREADS and threads % 32 == 0):
        problems.append(f"{threads} threads is not 32 to {MAX_THREADS} in "
                        "whole warps")
    if vec not in (1, 4):
        problems.append(f"vec {vec} is not 1 or 4")
    elif vec == 4 and N % 4:
        problems.append(f"float4 stores need N % 4 == 0, not N = {N}")
    if problems:
        raise ValueError(f"diff-map layout {tuple(layout)}: "
                         + "; ".join(problems))


@functools.cache  # a pure function, on the launch path
def diffmap_layout(B: int, H: int, N: int, sm_count: int) -> DiffmapLayout:
    """The diff-map kernel's layout for B frames of H hypotheses against N
    pixels a frame on a card of ``sm_count`` SMs.  Its threads (one per
    ``vec`` pixels of each ``hyps_per_cta`` hypotheses) should number
    about DIFFMAP_WARPS_PER_SM warps an SM: 4 pixels a thread where N % 4
    == 0 and DIFFMAP_TILE_HYPS hypotheses a CTA still give that many (a
    serve batch of 8 frames), else 1 pixel a thread (a test_ransac frame);
    then as many hypotheses a CTA (a power of two, at most
    DIFFMAP_TILE_HYPS) as keep that many threads.  At N = 1,600 on the
    H100 that is 8 hypotheses x 512 threads x 4 pixels at 8 x 256 and 4 x
    128 x 1 at 1 x 256, the fastest layouts of the sweep
    (``cli/profile_kernels.py --sweep``, PERF.md)."""
    want = DIFFMAP_WARPS_PER_SM * 32 * sm_count

    def threads(g: int, vec: int) -> int:
        return B * _cdiv(H, g) * _cdiv(N, vec)

    vec = 4 if N % 4 == 0 and threads(DIFFMAP_TILE_HYPS, 4) >= want else 1
    g = DIFFMAP_TILE_HYPS
    while g > 1 and threads(g, vec) < want:
        g //= 2
    layout = DiffmapLayout(max(1, min(g, H)), DIFFMAP_THREADS[vec], vec)
    check_diffmap_layout(layout, N)
    return layout


def diffmap_grid(layout: DiffmapLayout, B: int, H: int, N: int
                 ) -> tuple[int, int, int]:
    """The diff-map kernel's grid: (pixel tiles, hypothesis tiles,
    frames)."""
    return (_cdiv(_cdiv(N, layout.vec), layout.threads),
            _cdiv(H, layout.hyps_per_cta), B)


def _aligned16(*xs: torch.Tensor) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in xs)


def diffmaps_ref(R: torch.Tensor, t: torch.Tensor, coords: torch.Tensor,
                 pix: torch.Tensor, cam: Camera, max_error: float = 100.0
                 ) -> torch.Tensor:
    """Plain version: ops/diffmap.py:diffmaps."""
    return diffmaps_plain(Pose(R, t), coords, pix, cam, max_error)


def launch_diffmap(R: torch.Tensor, t: torch.Tensor, coords: torch.Tensor,
                   pix: torch.Tensor, cam: Camera, max_error: float = 100.0,
                   layout: DiffmapLayout | None = None) -> torch.Tensor:
    """One launch of the diff-map kernel on checked CUDA tensors, in
    ``layout`` (``diffmap_layout``'s by default, with scalar loads and
    stores where the inputs are not 16-byte aligned).  Not counted: the
    caller counts its launches."""
    B, H, N, dev = *t.shape[:2], coords.shape[1], t.device
    aligned = _aligned16(coords, pix)
    if layout is None:
        layout = diffmap_layout(B, H, N, _build.sm_count(dev))
        if not aligned:
            layout = layout._replace(vec=1)
    check_diffmap_layout(layout, N)
    if layout.vec == 4 and not aligned:
        raise ValueError("float4 loads need 16-byte aligned coords and pix")
    out = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    _build.launch("dsac_diffmaps", dev, R.data_ptr(), t.data_ptr(),
                  coords.data_ptr(), pix.data_ptr(), B, H, N, *layout,
                  diffmap_grid(layout, B, H, N)[0], cam.focal, cam.cx,
                  cam.cy, max_error, out.data_ptr())
    return out


def diffmaps(R: torch.Tensor, t: torch.Tensor, coords: torch.Tensor,
             pix: torch.Tensor, cam: Camera, max_error: float = 100.0
             ) -> torch.Tensor:
    """(B, H, N) clamped reprojection errors of hypotheses R (B, H, 3, 3),
    t (B, H, 3) against coords (B, N, 3) mm at pixels pix (B, N, 2)."""
    dev = _build.check_poses(R, t, coords, pix)[3]
    if dev.type == "cpu":
        return diffmaps_ref(R, t, coords, pix, cam, max_error)
    out = launch_diffmap(R, t, coords, pix, cam, max_error)
    diffmaps.launches += 1
    return out


diffmaps.launches = 0


def soft_inlier_scores_ref(R: torch.Tensor, t: torch.Tensor,
                           coords: torch.Tensor, pix: torch.Tensor,
                           cam: Camera, threshold: float = 10.0,
                           beta: float = 10.0, max_error: float = 100.0
                           ) -> torch.Tensor:
    """Plain version: the (B, H, N) error surface, then the soft count."""
    return _from_diffmaps(diffmaps_ref(R, t, coords, pix, cam, max_error),
                          threshold, beta)


def launch_score(R: torch.Tensor, t: torch.Tensor, coords: torch.Tensor,
                 pix: torch.Tensor, cam: Camera, threshold: float = 10.0,
                 beta: float = 10.0, max_error: float = 100.0,
                 layout: ScoreLayout | None = None) -> torch.Tensor:
    """One launch of the score kernel on checked CUDA tensors, in
    ``layout`` (``score_layout``'s by default).  Not counted: the caller
    counts its launches."""
    B, H, N, dev = *t.shape[:2], coords.shape[1], t.device
    if layout is None:
        layout = score_layout(B, H, N, _build.sm_count(dev))
    check_score_layout(layout)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    _build.launch("dsac_soft_inlier_scores", dev, R.data_ptr(),
                  t.data_ptr(), coords.data_ptr(), pix.data_ptr(), B, H, N,
                  *layout, score_grid(layout, B, H)[0], cam.focal, cam.cx,
                  cam.cy, threshold, 1.0 / beta, max_error, out.data_ptr())
    return out


def soft_inlier_scores(R: torch.Tensor, t: torch.Tensor,
                       coords: torch.Tensor, pix: torch.Tensor, cam: Camera,
                       threshold: float = 10.0, beta: float = 10.0,
                       max_error: float = 100.0) -> torch.Tensor:
    """(B, H) soft inlier counts of hypotheses R (B, H, 3, 3), t (B, H, 3)
    against coords (B, N, 3) mm at pixels pix (B, N, 2)."""
    dev = _build.check_poses(R, t, coords, pix)[3]
    if dev.type == "cpu":
        return soft_inlier_scores_ref(R, t, coords, pix, cam, threshold,
                                      beta, max_error)
    out = launch_score(R, t, coords, pix, cam, threshold, beta, max_error)
    soft_inlier_scores.launches += 1
    return out


soft_inlier_scores.launches = 0
