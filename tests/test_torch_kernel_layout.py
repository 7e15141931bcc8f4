"""The layout functions of the refine, IRLS-stats, P3P, score and
diff-map kernels (ops/gn_cuda.py:refine_layout and irls_stats_layout,
ops/p3p_cuda.py:p3p_layout, ops/diffmap_cuda.py:score_layout and
diffmap_layout): pure functions of their arguments, run here on the CPU.
Every layout they pick is one the CUDA kernels take (csrc/refine.cu,
csrc/irls_stats.cu, csrc/p3p.cu, csrc/score.cu, csrc/diffmap.cu: clusters
of at most 8 CTAs, at most 256 threads a refine or IRLS-stats CTA and
1,024 a P3P block or score or diff-map CTA, shared memory under the
H100's 227 KB a block, float4 stores only where N % 4 == 0), the main
path's regimes get the layouts the H100 sweep chose (PERF.md), and the
IRLS-stats, score and diff-map grids cover every (frame, pose or
hypothesis, pixel) once."""

import numpy as np
import pytest
import torch

from dsac_tpu_torch.ops.diffmap_cuda import (MAX_THREADS, SCORE_TILES,
                                             DiffmapLayout, ScoreLayout,
                                             _aligned16,
                                             check_diffmap_layout,
                                             check_score_layout,
                                             diffmap_grid, diffmap_layout,
                                             diffmap_smem_bytes, score_grid,
                                             score_layout, score_smem_bytes)
from dsac_tpu_torch.ops.gn_cuda import (MAX_CLUSTER, REFINE_MAX_THREADS,
                                        REFINE_STATIC_SMEM_BYTES,
                                        SMEM_LIMIT_BYTES, RefineLayout,
                                        check_irls_stats_layout,
                                        check_refine_layout,
                                        irls_stats_layout, refine_layout,
                                        refine_smem_bytes)
from dsac_tpu_torch.ops.p3p_cuda import (P3PLayout, check_p3p_layout,
                                         p3p_layout)
from dsac_tpu_torch.utils.kernel_problems import IRLS_STATS_SHAPES

H100_SMS = 132


def test_refine_shared_memory_limit_is_the_h100s():
    assert SMEM_LIMIT_BYTES == 227 * 1024  # a block's most on Hopper


@pytest.mark.parametrize("sm_count", [132, 114, 78, 66, 16, 1])
@pytest.mark.parametrize("N", [1, 14, 31, 100, 1600, 1601, 4800, 20_000])
def test_refine_layouts_are_legal(N, sm_count):
    for P in (1, 3, 4, 12, 37, 256, 1024):
        for B in (1, 2, 8, 64):
            c, g, w = lay = refine_layout(B * P, P, N, sm_count)
            assert c in (1, 2, 4, 8) and c <= MAX_CLUSTER
            assert g >= 1 and w >= 1 and g <= P
            assert lay.threads <= min(REFINE_MAX_THREADS, 1024)
            assert c == 1 or g == 1  # a cluster serves one pose
            assert refine_smem_bytes(lay, N) <= SMEM_LIMIT_BYTES
            check_refine_layout(lay, N)


@pytest.mark.parametrize("num_poses, P, want", [
    (1, 1, RefineLayout(8, 1, 4)),       # SoftAM's averaged pose
    (8, 1, RefineLayout(8, 1, 4)),       # a SoftAM serve batch's averages
    (12, 12, RefineLayout(8, 1, 4)),     # its backward's 12 probes
    (32, 4, RefineLayout(8, 1, 4)),      # serve top 4 of 8 frames
    (256, 256, RefineLayout(1, 1, 8)),   # refine-all of a frame
    (2048, 256, RefineLayout(1, 8, 1)),  # refine-all of 8 frames
])
def test_refine_regimes_get_the_sweeps_layouts(num_poses, P, want):
    got = refine_layout(num_poses, P, 1600, H100_SMS)
    assert got == want
    assert (got.cluster > 1) == (num_poses * 2 <= H100_SMS)


def test_refine_layout_depends_only_on_its_arguments():
    args = [(n, p, N, sm) for n, p in ((1, 1), (12, 12), (32, 4), (256, 256),
                                       (2048, 256), (96, 12))
            for N in (100, 1600) for sm in (132, 78)]
    first = [refine_layout(*a) for a in args]
    assert [refine_layout(*a) for a in reversed(args)] == first[::-1]


def test_refine_layout_splits_large_frames_over_a_cluster():
    lay = refine_layout(2048, 256, 20_000, H100_SMS)
    assert lay.cluster > 1 and lay.poses_per_cta == 1
    assert refine_smem_bytes(lay, 20_000) <= SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        refine_layout(1, 1, 100_000, H100_SMS)


@pytest.mark.parametrize("layout", [RefineLayout(3, 1, 4),
                                    RefineLayout(16, 1, 4),
                                    RefineLayout(2, 2, 4),
                                    RefineLayout(1, 4, 4),
                                    RefineLayout(1, 0, 4),
                                    RefineLayout(1, 1, 0)])
def test_refine_layout_check_refuses_what_the_kernel_does_not_take(layout):
    with pytest.raises(ValueError):
        check_refine_layout(layout, 1600)


def test_refine_layouts_and_limits_are_what_they_were():
    """The staging and sums that refine.cu shares with irls_stats.cu
    (csrc/pose_layout.cuh) keep refine's shared memory: 20 bytes a pixel
    of the CTA's slice and 4,112 static bytes (double-buffered warp and
    cluster sums, two mbarriers)."""
    assert REFINE_STATIC_SMEM_BYTES == 4 * 2 * 2 * 8 * 32 + 2 * 8 == 4112
    assert refine_smem_bytes(RefineLayout(1, 8, 1), 1600) == 32_000 + 4112
    assert refine_smem_bytes(RefineLayout(8, 1, 4), 1600) == 4_000 + 4112
    assert refine_smem_bytes(RefineLayout(8, 1, 4), 1601) == 4_020 + 4112
    assert refine_smem_bytes(RefineLayout(2, 1, 8), 20_000) == 200_000 + 4112


# ---- the IRLS-stats kernel (csrc/irls_stats.cu): the refine kernel's
# layouts (csrc/pose_layout.cuh) ----

def test_irls_stats_kernel_takes_the_refine_kernels_layouts():
    """irls_stats.cu takes refine.cu's layouts and limits and is given
    them by refine's rule (the refine tests above hold both); a frame too
    large for a CTA's staged slice is refused in a layout without a
    cluster."""
    assert irls_stats_layout is refine_layout
    assert check_irls_stats_layout is check_refine_layout
    with pytest.raises(ValueError, match="shared memory"):
        check_irls_stats_layout(RefineLayout(1, 8, 1), 20_000)


@pytest.mark.parametrize("shape, want", [
    ("test_ransac", RefineLayout(1, 1, 8)),  # a stepwise refiner's pass
    ("refine_all", RefineLayout(1, 8, 1)),   # a refine-all batch
])
def test_irls_stats_shapes_get_the_sweeps_layouts(shape, want):
    B, P = IRLS_STATS_SHAPES[shape]
    assert irls_stats_layout(B * P, P, 1600, H100_SMS) == want


def test_irls_stats_layout_splits_large_frames_over_a_cluster():
    for B, P in IRLS_STATS_SHAPES.values():
        lay = irls_stats_layout(B * P, P, 20_000, H100_SMS)
        assert lay.cluster > 1 and lay.poses_per_cta == 1
        assert refine_smem_bytes(lay, 20_000) <= SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        irls_stats_layout(256, 256, 100_000, H100_SMS)


def pose_cover(layout, B, P, N):
    """How often the IRLS-stats kernel visits each (frame, pose, pixel) and
    writes each (frame, pose): csrc/pose_layout.cuh's grid
    (launch_in_layout), place (locate) and pixel order (sum_pixels), and
    irls_stats.cu's write by warp 0 of the pose in rank 0."""
    C, G, W = layout
    pixels = np.zeros((B, P, N), np.int64)
    writes = np.zeros((B, P), np.int64)
    groups = -(-P // G)
    slice_ = -(-N // C)
    lane = np.arange(32)
    for x in range(B * groups * C):
        rank, unit = x % C, x // C
        b = unit // groups
        assert 0 <= b < B
        start = rank * slice_
        length = max(0, min(slice_, N - start))
        for warp in range(G * W):
            g, w = warp // W, warp % W
            j = (unit % groups) * G + g
            if j >= P:
                continue
            n = (np.arange(w * 32, max(length, 1), W * 32)[:, None]
                 + lane).ravel()
            np.add.at(pixels[b, j], start + n[n < length], 1)
            if rank == 0 and w == 0:
                writes[b, j] += 1
    return pixels, writes


@pytest.mark.parametrize("B, P, N", [(2, 1, 14), (1, 3, 100), (3, 37, 1601),
                                     (1, 5, 1600), (2, 9, 7)])
def test_irls_stats_grid_covers_every_pair_once(B, P, N):
    for lay in (irls_stats_layout(B * P, P, N, H100_SMS),
                RefineLayout(8, 1, 4), RefineLayout(2, 1, 2),
                RefineLayout(4, 1, 1), RefineLayout(1, 8, 1),
                RefineLayout(1, 2, 4), RefineLayout(1, 1, 8)):
        check_irls_stats_layout(lay, N)
        pixels, writes = pose_cover(lay, B, P, N)
        assert (pixels == 1).all() and (writes == 1).all(), lay


@pytest.mark.parametrize("sm_count", [132, 78])
def test_p3p_layouts_are_legal(sm_count):
    for M in (1, 3, 31, 2048, 3840, 16_383, 16_384, 32_768, 1 << 20):
        tpl, block = lay = p3p_layout(M, sm_count)
        assert tpl in (1, 4) and 32 <= block <= 1024 and block % 32 == 0
        assert p3p_layout(M, sm_count) == lay
        check_p3p_layout(lay)


@pytest.mark.parametrize("M, threads_per_lane", [
    (2048, 4),   # two-phase sampling, phase 1 of a serve batch
    (3840, 4),   # its phase 2
    (32768, 1),  # fixed-T sampling of a serve batch
])
def test_p3p_shapes_get_the_sweeps_layouts(M, threads_per_lane):
    assert p3p_layout(M, H100_SMS) == P3PLayout(threads_per_lane, 64)


@pytest.mark.parametrize("layout", [P3PLayout(2, 64), P3PLayout(4, 48),
                                    P3PLayout(1, 2048), P3PLayout(4, 0)])
def test_p3p_layout_check_refuses_what_the_kernel_does_not_take(layout):
    with pytest.raises(ValueError):
        check_p3p_layout(layout)


# ---- the score and diff-map kernels (ops/diffmap_cuda.py; csrc/score.cu,
# csrc/diffmap.cu: at most 1,024 threads a CTA) ----

LAYOUT_NS = [1, 14, 1600, 1601, 4800, 20_000]
LAYOUT_HS = [1, 3, 256, 4096]


@pytest.mark.parametrize("sm_count", [132, 114, 16])
@pytest.mark.parametrize("N", LAYOUT_NS)
def test_score_layouts_are_legal(N, sm_count):
    for H in LAYOUT_HS:
        for B in (1, 8):
            g, w, tile = lay = score_layout(B, H, N, sm_count)
            assert 1 <= g <= H and w >= 1 and tile in SCORE_TILES
            assert tile >= N or tile == max(SCORE_TILES)  # the whole frame
            assert lay.threads <= MAX_THREADS == 1024
            assert score_smem_bytes(lay) <= SMEM_LIMIT_BYTES
            check_score_layout(lay)


@pytest.mark.parametrize("sm_count", [132, 114, 16])
@pytest.mark.parametrize("N", LAYOUT_NS)
def test_diffmap_layouts_are_legal(N, sm_count):
    for H in LAYOUT_HS:
        for B in (1, 8):
            g, threads, vec = lay = diffmap_layout(B, H, N, sm_count)
            assert 1 <= g <= H
            assert 32 <= threads <= MAX_THREADS and threads % 32 == 0
            assert vec in (1, 4) and (vec == 1 or N % 4 == 0)
            assert diffmap_smem_bytes(lay) <= SMEM_LIMIT_BYTES
            check_diffmap_layout(lay, N)


@pytest.mark.parametrize("B, H, want", [
    (8, 256, ScoreLayout(16, 2, 2048)),  # a fused-soft serve batch
    (8, 4096, ScoreLayout(8, 1, 2048)),  # the large-H regime
])
def test_score_shapes_get_the_sweeps_layouts(B, H, want):
    assert score_layout(B, H, 1600, H100_SMS) == want


@pytest.mark.parametrize("B, H, want", [
    (8, 256, DiffmapLayout(8, 512, 4)),  # a score-CNN or fixed-T batch
    (1, 256, DiffmapLayout(4, 128, 1)),  # a test_ransac frame
])
def test_diffmap_shapes_get_the_sweeps_layouts(B, H, want):
    assert diffmap_layout(B, H, 1600, H100_SMS) == want
    # one frame fills every SM
    gx, gy, gz = diffmap_grid(want, B, H, 1600)
    assert gx * gy * gz >= H100_SMS


def test_score_and_diffmap_layouts_depend_only_on_their_arguments():
    args = [(B, H, N, sm) for B in (1, 8) for H in (3, 256, 4096)
            for N in (14, 1600) for sm in (132, 16)]
    for fn in (score_layout, diffmap_layout):
        first = [fn(*a) for a in args]
        assert [fn(*a) for a in reversed(args)] == first[::-1]


@pytest.mark.parametrize("layout", [ScoreLayout(0, 4, 1600),
                                    ScoreLayout(4, 0, 1600),
                                    ScoreLayout(8, 8, 1600),
                                    ScoreLayout(1, 1, 0),
                                    ScoreLayout(1, 1, 20_000),
                                    ScoreLayout(1, 1, 1600),
                                    ScoreLayout(4, 4, 512)])
def test_score_layout_check_refuses_what_the_kernel_does_not_take(layout):
    with pytest.raises(ValueError):
        check_score_layout(layout)


@pytest.mark.parametrize("layout, N", [(DiffmapLayout(8, 128, 4), 1601),
                                       (DiffmapLayout(8, 100, 4), 1600),
                                       (DiffmapLayout(8, 2048, 1), 1600),
                                       (DiffmapLayout(0, 128, 1), 1600),
                                       (DiffmapLayout(2048, 128, 1), 1600),
                                       (DiffmapLayout(8, 128, 2), 1600)])
def test_diffmap_layout_check_refuses_what_the_kernel_does_not_take(layout,
                                                                    N):
    with pytest.raises(ValueError):
        check_diffmap_layout(layout, N)


def score_cover(layout, B, H, N):
    """How often the score kernel, launched on score_grid's grid, visits
    each (frame, hypothesis, pixel) and writes each (frame, hypothesis):
    csrc/score.cu's index arithmetic."""
    g_, w_, tile = layout
    pixels = np.zeros((B, H, N), np.int64)
    writes = np.zeros((B, H), np.int64)
    gx, gy = score_grid(layout, B, H)
    lane = np.arange(32)
    for b in range(gy):
        for bx in range(gx):
            h0 = bx * g_
            for warp in range(g_ * w_):
                h = h0 + warp // w_
                if h >= H:
                    continue
                for n0 in range(0, N, tile):
                    n = np.arange((warp % w_) * 32, min(tile, N - n0),
                                  w_ * 32)[:, None] + lane
                    n = n[n < min(tile, N - n0)]
                    np.add.at(pixels[b, h], n0 + n, 1)
            hh = h0 + np.arange(g_)
            writes[b, hh[hh < H]] += 1
    return pixels, writes


def diffmap_cover(layout, B, H, N):
    """How often the diff-map kernel, launched on diffmap_grid's grid,
    writes each (frame, hypothesis, pixel): csrc/diffmap.cu's index
    arithmetic."""
    g_, threads, vec = layout
    out = np.zeros((B, H, N), np.int64)
    gx, gy, gz = diffmap_grid(layout, B, H, N)
    for b in range(gz):
        for by in range(gy):
            hs = slice(by * g_, min(by * g_ + g_, H))
            for bx in range(gx):
                n = (bx * threads + np.arange(threads)) * vec
                n = n[n < N]
                for j in range(vec):
                    out[b, hs, n + j] += 1
    return out


@pytest.mark.parametrize("B, H, N", [(2, 1, 14), (1, 3, 100), (2, 37, 1601),
                                     (1, 5, 1600)])
def test_score_grid_covers_every_pair_once(B, H, N):
    for lay in (score_layout(B, H, N, H100_SMS), ScoreLayout(2, 4, 256),
                ScoreLayout(4, 2, 256), ScoreLayout(32, 1, 2048),
                ScoreLayout(1, 8, 2048), ScoreLayout(1, 4, 256)):
        pixels, writes = score_cover(lay, B, H, N)
        assert (pixels == 1).all() and (writes == 1).all(), lay


@pytest.mark.parametrize("B, H, N", [(2, 1, 14), (1, 3, 100), (2, 37, 1601),
                                     (1, 5, 1600), (2, 9, 20)])
def test_diffmap_grid_covers_every_pair_once(B, H, N):
    lays = [diffmap_layout(B, H, N, H100_SMS), DiffmapLayout(4, 64, 1),
            DiffmapLayout(16, 32, 1)]
    if N % 4 == 0:
        lays += [DiffmapLayout(2, 64, 4), DiffmapLayout(3, 32, 4)]
    for lay in lays:
        check_diffmap_layout(lay, N)
        assert (diffmap_cover(lay, B, H, N) == 1).all(), lay


def test_float4_path_needs_16_byte_aligned_inputs():
    x = torch.zeros(64)
    assert _aligned16(x) and not _aligned16(x[1:])
