"""The layout functions of the refine and P3P kernels (ops/gn_cuda.py:
refine_layout, ops/p3p_cuda.py:p3p_layout): pure functions of their
arguments, run here on the CPU.  Every layout they pick is one the CUDA
kernels take (csrc/refine.cu, csrc/p3p.cu: clusters of at most 8 CTAs, at
most 256 threads a refine CTA and 1,024 a P3P block, shared memory under
the H100's 227 KB a block), and the main path's regimes get the layouts
the H100 sweep chose (PERF.md)."""

import pytest

from dsac_tpu_torch.ops.gn_cuda import (MAX_CLUSTER, REFINE_MAX_THREADS,
                                        SMEM_LIMIT_BYTES, RefineLayout,
                                        check_refine_layout, refine_layout,
                                        refine_smem_bytes)
from dsac_tpu_torch.ops.p3p_cuda import (P3PLayout, check_p3p_layout,
                                         p3p_layout)

H100_SMS = 132


def test_refine_shared_memory_limit_is_the_h100s():
    assert SMEM_LIMIT_BYTES == 227 * 1024  # a block's most on Hopper


@pytest.mark.parametrize("sm_count", [132, 114, 78, 16])
@pytest.mark.parametrize("N", [1, 14, 100, 1600, 1601, 4800, 20_000])
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
