"""The port's CUDA kernels on the card (marker `gpu`; each test skips
without a CUDA device).  No JAX here, so that the machine with the card,
which has none, can run the file; tests/conftest.py imports JAX, so run it
there without the conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

Bars as in tests/test_torch_kernels.py: P3P decision agreement >= 0.98 and
median |dR| < 1e-3; score max abs error <= 1e-3; refine |dt| <= 2 mm,
|dR| <= 1e-4, |dn_in| <= 0.5.  The refine and P3P kernels are held at
each of their layouts (ops/gn_cuda.py:RefineLayout, ops/p3p_cuda.py:
P3PLayout), on ragged sizes too, and the refine layouts against each
other at the refine bar; the score and diff-map kernels in every layout
that ``cli/profile_kernels.py --sweep`` tries, on ragged sizes, the score
bit-identical from launch to launch; the IRLS-stats kernel in every
layout of its sweep, on ragged sizes, bit-identical from launch to
launch and equal in its inlier mass to the refine kernel's n_in after one
step in the same layout.  As in tests/test_torch_diffmap_stats.py:
diff-maps rtol 1e-4, atol 1e-2 (tests/test_pallas_kernels.py:42-53); IRLS
statistics n_in rtol 1e-3 / atol 0.05, JtJ and Jtr rtol 2e-3 / atol 2.0
(tests/test_gn_pallas.py:46-55); the stepwise refiner against the refine
kernel at the refine kernel's bars, and in test_ransac at the served
hypothesis at tests/test_gn_pallas.py:112-115's (1e-2 mm, 1e-5).  The
refine kernel's init-pose backward against its plain version: cosine >=
0.999 and norm ratio 0.99-1.01 (tests/test_torch_implicit_grad.py).  With
two cards or more, a kernel launched on tensors of the second card while
the first is current gives the result it gives there.
"""

import numpy as np
import pytest
import torch

from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.rotation import so3_exp
from dsac_tpu_torch.ops.diffmap_cuda import (DiffmapLayout, diffmaps,
                                             diffmaps_ref, launch_diffmap,
                                             launch_score,
                                             soft_inlier_scores,
                                             soft_inlier_scores_ref)
from dsac_tpu_torch.geometry.pose import pose_to_vec6
from dsac_tpu_torch.ops import _build, gn_cuda
from dsac_tpu_torch.cli.profile_kernels import sweep_refine_layouts
from dsac_tpu_torch.ops.gn_cuda import (InitSensitiveRefine, RefineLayout,
                                        irls_stats, irls_stats_layout,
                                        irls_stats_ref, launch_irls_stats,
                                        launch_refine, refine_layout,
                                        refine_init_sensitive,
                                        refine_pose_fused,
                                        refine_pose_fused_ref,
                                        refine_pose_fused_steps,
                                        unpack_stats)
from dsac_tpu_torch.ops.p3p_cuda import (P3PLayout, launch_p3p, p3p_layout,
                                         p3p_solve, p3p_solve_ref)
from dsac_tpu_torch.ops.sampling import gather_rows
from torch_problems import frames

CAM = Camera.make(525.0, 640, 480)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def problem(cuda):
    rng = np.random.default_rng(1305)
    gt, coords, pix = frames(rng, B=2)
    return rng, Pose(gt.R.to(cuda), gt.t.to(cuda)), coords.to(cuda), \
        pix.to(cuda)


@pytest.mark.parametrize("threads_per_lane", [4, 1])
@pytest.mark.parametrize("M", [1, 3, 2048, 32768])
def test_p3p_and_score_match_plain_versions(problem, M, threads_per_lane):
    rng, gt, coords, pix = problem
    idx = torch.from_numpy(rng.integers(0, 1600, size=(2, M // 2 or 1, 4))
                           ).to(coords.device)
    obj = gather_rows(coords, idx).reshape(-1, 4, 3)[:M].contiguous()
    img = gather_rows(pix, idx).reshape(-1, 4, 2)[:M].contiguous()
    block = p3p_layout(M, _build.sm_count(coords.device)).block
    kp, kv, kw = launch_p3p(obj, img, CAM, P3PLayout(threads_per_lane, block))
    rp, rv, rw = p3p_solve_ref(obj, img, CAM)
    kc, rc = kv & (kw < 10), rv & (rw < 10)
    assert float((kc == rc).float().mean()) >= 0.98
    both = kc & rc
    if both.any():
        assert float((kp.R - rp.R).abs().flatten(1).amax(1)[both].median()
                     ) < 1e-3
    assert torch.isfinite(kp.R).all() and torch.isfinite(kp.t).all() \
        and torch.isfinite(kw).all()
    if M != 2048 or threads_per_lane != 4:
        return
    before = p3p_solve.launches
    sp, _, _ = p3p_solve(obj, img, CAM)  # the default layout, counted
    assert p3p_solve.launches == before + 1
    assert torch.equal(sp.R, kp.R)
    R = kp.R.reshape(2, M // 2, 3, 3).contiguous()
    t = kp.t.reshape(2, M // 2, 3).contiguous()
    err = (soft_inlier_scores(R, t, coords, pix, CAM)
           - soft_inlier_scores_ref(R, t, coords, pix, CAM)).abs().max()
    assert float(err) <= 1e-3


# every layout of the refine kernel the layout function picks on an H100
# (clusters of 8 and 2; 2 poses of 4 warps and 8 poses of 1 warp a CTA),
# and others it can take
REFINE_LAYOUTS = [RefineLayout(8, 1, 4), RefineLayout(2, 1, 4),
                  RefineLayout(1, 2, 4), RefineLayout(1, 8, 1),
                  RefineLayout(4, 1, 8), RefineLayout(1, 1, 8),
                  RefineLayout(1, 4, 2), RefineLayout(8, 1, 1)]


def _refine_bar(a, na, b, nb):
    assert float((a.t - b.t).abs().max()) <= 2.0
    assert float((a.R - b.R).abs().max()) <= 1e-4
    assert float((na - nb).abs().max()) <= 0.5


@pytest.mark.parametrize("layout", [None] + REFINE_LAYOUTS,
                         ids=lambda x: "auto" if x is None else
                         "c{}g{}w{}".format(*x))
def test_refine_matches_plain_version(problem, layout):
    rng, gt, coords, pix = problem
    def noise(scale):
        return torch.from_numpy(rng.normal(size=(2, 4, 3)) * scale).float(
        ).to(coords.device)

    poses = Pose((so3_exp(noise(0.005)) @ gt.R[:, None]).contiguous(),
                 (gt.t[:, None] + noise(15.0)).contiguous())
    if layout is None:
        before = refine_pose_fused.launches
        a, na = refine_pose_fused(poses, coords, pix, CAM)
        assert refine_pose_fused.launches == before + 1
    else:
        a, na = launch_refine(poses.R, poses.t, coords, pix, CAM, 16, 10.0,
                              1.0, 50.0, 1e-4, 100.0, layout=layout)
    b, nb = refine_pose_fused_ref(poses, coords, pix, CAM)
    _refine_bar(a, na, b, nb)


@pytest.mark.parametrize("N", [14, 100, 1601])
def test_refine_layouts_agree_on_ragged_frames(problem, N):
    """Frames of N pixels: N = 14 leaves a CTA of a cluster of 8 without a
    pixel, N = 100 leaves most threads without one; every layout against
    the plain version and against the others.  min_inliers is 0 so that
    no pose freezes."""
    rng, gt, coords, pix = problem
    c, x = coords[:, :N].contiguous(), pix[:, :N].contiguous()
    pool = _pool(rng, gt, 0.005, 15.0, P=5)
    kw = dict(threshold=10.0, beta=1.0, min_inliers=0.0, damping=1e-4,
              max_error=100.0)
    b, nb = refine_pose_fused_ref(pool, c, x, CAM, outer_steps=16,
                                  inner_iters=1, **kw)
    outs = [launch_refine(pool.R, pool.t, c, x, CAM, 16, layout=lay, **kw)
            for lay in REFINE_LAYOUTS]
    for a, na in outs:
        assert torch.isfinite(a.R).all() and torch.isfinite(a.t).all()
        _refine_bar(a, na, b, nb)
        _refine_bar(a, na, *outs[0])


@pytest.mark.parametrize("layout", REFINE_LAYOUTS,
                         ids=lambda x: "c{}g{}w{}".format(*x))
def test_refine_freezes_and_stays_finite(problem, layout):
    """A pose below min_inliers from the first step comes back as it went
    in; a pose whose projection overflows (R scaled by 1e38: inf - inf in
    the residual, NaN statistics) is kept by the NaN guard and comes back
    finite."""
    rng, gt, coords, pix = problem
    far = _pool(rng, gt, 0.8, 2000.0, P=3)
    R = far.R.clone()
    R[:, 2] = gt.R * 1e38
    t = far.t.clone()
    t[:, 2] = gt.t
    a, na = launch_refine(R, t, coords, pix, CAM, 16, 10.0, 1.0, 50.0, 1e-4,
                          100.0, layout=layout)
    _, nb = refine_pose_fused_ref(Pose(R, t), coords, pix, CAM)
    frozen = nb[:, :2] < 50.0
    assert frozen.all(), nb
    assert torch.equal(a.R, R) and torch.equal(a.t, t)
    assert torch.isfinite(na).all()
    torch.testing.assert_close(na[:, :2], nb[:, :2], rtol=0.0, atol=0.5)


def _pool(rng, gt, scale_w, scale_t, P=64):
    """P poses per frame around the known ones."""
    def noise(scale):
        return torch.from_numpy(rng.normal(size=(gt.t.shape[0], P, 3))
                                * scale).float().to(gt.t.device)

    return Pose((so3_exp(noise(scale_w)) @ gt.R[:, None]).contiguous(),
                (gt.t[:, None] + noise(scale_t)).contiguous())


def test_diffmap_and_irls_stats_match_plain_versions(problem):
    rng, gt, coords, pix = problem
    pool = _pool(rng, gt, 0.2, 300.0, P=37)  # a ragged hypothesis tile
    before = (diffmaps.launches, irls_stats.launches)
    got = diffmaps(pool.R, pool.t, coords, pix, CAM)
    assert diffmaps.launches == before[0] + 1
    torch.testing.assert_close(got, diffmaps_ref(pool.R, pool.t, coords,
                                                 pix, CAM),
                               rtol=1e-4, atol=1e-2)
    ks = unpack_stats(irls_stats(pool.R, pool.t, coords, pix, CAM))
    assert irls_stats.launches == before[1] + 1
    rs = unpack_stats(irls_stats_ref(pool.R, pool.t, coords, pix, CAM))
    torch.testing.assert_close(ks[2], rs[2], rtol=1e-3, atol=0.05)
    torch.testing.assert_close(ks[1], rs[1], rtol=2e-3, atol=2.0)
    torch.testing.assert_close(ks[0], rs[0], rtol=2e-3, atol=2.0)


def _ragged(rng, dev, B, H, N):
    """B frames of N pixels and H hypotheses around their known poses."""
    gt, coords, pix = frames(rng, B=2, N=N)
    pool = _pool(rng, Pose(gt.R.to(dev), gt.t.to(dev)), 0.2, 300.0, P=H)
    return (pool.R[:B].contiguous(), pool.t[:B].contiguous(),
            coords[:B].to(dev), pix[:B].to(dev))


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("H", [1, 3, 257])
@pytest.mark.parametrize("N", [14, 100, 1601])
def test_score_layouts_match_plain_version(problem, B, H, N):
    """Every layout that profile_kernels --sweep tries, at ragged sizes,
    against the plain version (max abs error <= 1e-3); each bit-identical
    from launch to launch."""
    from dsac_tpu_torch.cli.profile_kernels import sweep_score_layouts
    args = _ragged(problem[0], problem[2].device, B, H, N)
    want = soft_inlier_scores_ref(*args, CAM)
    for lay in sweep_score_layouts(N):
        got = launch_score(*args, CAM, layout=lay)
        assert float((got - want).abs().max()) <= 1e-3, lay
        assert torch.equal(got, launch_score(*args, CAM, layout=lay)), lay


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("H", [1, 3, 257])
@pytest.mark.parametrize("N", [14, 100, 1601])
def test_diffmap_layouts_match_plain_version(problem, B, H, N):
    """Every layout that profile_kernels --sweep tries, at ragged sizes
    (float4 stores at N = 100), against the plain version (rtol 1e-4, atol
    1e-2)."""
    from dsac_tpu_torch.cli.profile_kernels import sweep_diffmap_layouts
    args = _ragged(problem[0], problem[2].device, B, H, N)
    want = diffmaps_ref(*args, CAM)
    for lay in sweep_diffmap_layouts(N):
        got = launch_diffmap(*args, CAM, layout=lay)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2,
                                   msg=str(lay))


def test_score_and_diffmap_count_one_launch_a_call(problem):
    """The wrappers count their launches; launch_score and launch_diffmap
    do not; a serve batch's scores are bit-identical from call to call."""
    rng, gt, coords, pix = problem
    pool = _pool(rng, gt, 0.2, 300.0, P=256)
    args = (pool.R, pool.t, coords, pix)
    before = (soft_inlier_scores.launches, diffmaps.launches)
    a = soft_inlier_scores(*args, CAM)
    assert torch.equal(a, soft_inlier_scores(*args, CAM))
    diffmaps(*args, CAM)
    launch_score(*args, CAM)
    launch_diffmap(*args, CAM)
    assert (soft_inlier_scores.launches, diffmaps.launches) == (
        before[0] + 2, before[1] + 1)


def test_diffmap_takes_unaligned_inputs_with_scalar_loads(problem):
    """Inputs that start 4 bytes past a 16-byte boundary: the wrapper's
    layout drops to one pixel a thread and gives the plain version's
    result; a float4 layout given explicitly is refused."""
    rng, gt, coords, pix = problem
    pool = _pool(rng, gt, 0.2, 300.0, P=8)
    c = torch.empty(coords.numel() + 1, device=coords.device)[1:]
    c = c.view(coords.shape).copy_(coords)
    x = torch.empty(pix.numel() + 1, device=pix.device)[1:]
    x = x.view(pix.shape).copy_(pix)
    torch.testing.assert_close(diffmaps(pool.R, pool.t, c, x, CAM),
                               diffmaps_ref(pool.R, pool.t, coords, pix,
                                            CAM), rtol=1e-4, atol=1e-2)
    with pytest.raises(ValueError):
        launch_diffmap(pool.R, pool.t, c, x, CAM,
                       layout=DiffmapLayout(8, 128, 4))


def test_stepwise_refiner_matches_refine_kernel(problem):
    rng, gt, coords, pix = problem
    pool = _pool(rng, gt, 0.01, 30.0)
    a, na = refine_pose_fused(pool, coords, pix, CAM)
    before = irls_stats.launches
    b, nb = refine_pose_fused_steps(pool, coords, pix, CAM, steps=16)
    assert irls_stats.launches == before + 16
    assert float((a.t - b.t).abs().max()) <= 2.0
    assert float((a.R - b.R).abs().max()) <= 1e-4
    assert float((na - nb).abs().max()) <= 0.5


def _irls_bar(got, want):
    ks, rs = unpack_stats(got), unpack_stats(want)
    torch.testing.assert_close(ks[2], rs[2], rtol=1e-3, atol=0.05)
    torch.testing.assert_close(ks[1], rs[1], rtol=2e-3, atol=2.0)
    torch.testing.assert_close(ks[0], rs[0], rtol=2e-3, atol=2.0)


@pytest.mark.parametrize("layout", sweep_refine_layouts(),
                         ids=lambda x: "c{}g{}w{}".format(*x))
def test_irls_stats_layouts_match_plain_version(cuda, layout):
    """Every layout of ``profile_kernels --sweep --kernels irls_stats`` at
    ragged sizes (3 frames of 37 poses and 1,601 pixels: frames 1 and 2
    start unaligned and stage with scalar loads) against the plain
    version; two launches bit-identical; and the refine kernel's n_in after
    one step in the same layout equal to the pass's inlier mass bit for
    bit."""
    rng = np.random.default_rng(1306)
    gt, coords, pix = frames(rng, B=3, N=1601)
    pool = _pool(rng, Pose(gt.R.to(cuda), gt.t.to(cuda)), 0.2, 300.0, P=37)
    args = (pool.R, pool.t, coords.to(cuda), pix.to(cuda))
    got = launch_irls_stats(*args, CAM, layout=layout)
    _irls_bar(got, irls_stats_ref(*args, CAM))
    assert torch.equal(got, launch_irls_stats(*args, CAM, layout=layout))
    _, n_one = launch_refine(*args, CAM, 1, 10.0, 1.0, 50.0, 1e-4, 100.0,
                             layout=layout)
    assert torch.equal(n_one, got[..., 27])


@pytest.mark.parametrize("B", [1, 2])
def test_irls_stats_is_a_refine_step_where_the_layouts_coincide(problem, B):
    """At 256 poses a frame (the IRLS-stats shapes of the main path, one
    frame and a batch) a refine launch of one step in the wrapper's layout
    returns the wrapper's inlier mass as n_in, bit for bit: through
    refine_pose_fused where refine_layout picks the same layout (as on the
    H100)."""
    rng, gt, coords, pix = problem
    pool = _pool(rng, gt, 0.05, 60.0, P=256)
    poses = Pose(pool.R[:B].contiguous(), pool.t[:B].contiguous())
    c, x = coords[:B].contiguous(), pix[:B].contiguous()
    sms = _build.sm_count(c.device)
    layout = irls_stats_layout(B * 256, 256, 1600, sms)
    stats = irls_stats(poses.R, poses.t, c, x, CAM)
    if layout == refine_layout(B * 256, 256, 1600, sms):
        _, n_one = refine_pose_fused(poses, c, x, CAM, outer_steps=1,
                                     inner_iters=1)
    else:
        _, n_one = launch_refine(poses.R, poses.t, c, x, CAM, 1, 10.0, 1.0,
                                 50.0, 1e-4, 100.0, layout=layout)
    assert torch.equal(n_one, stats[..., 27])
    _irls_bar(stats, irls_stats_ref(poses.R, poses.t, c, x, CAM))


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(problem):
    _, gt, coords, pix = problem
    R = gt.R[:, None].expand(2, 4, 3, 3).contiguous()
    t = gt.t[:, None].expand(2, 4, 3).contiguous()
    with pytest.raises(TypeError):
        soft_inlier_scores(R, t, coords.half(), pix, CAM)
    with pytest.raises(ValueError):
        soft_inlier_scores(R, t, coords.cpu(), pix, CAM)
    with pytest.raises(ValueError):
        refine_pose_fused(Pose(R.transpose(-1, -2), t), coords, pix, CAM)
    with pytest.raises(TypeError):
        diffmaps(R, t, coords, pix.double(), CAM)
    with pytest.raises(ValueError):
        diffmaps(R, t[:, :3], coords, pix, CAM)
    with pytest.raises(ValueError):
        irls_stats(R.transpose(-1, -2), t, coords, pix, CAM)
    with pytest.raises(ValueError):
        irls_stats(R, t, coords, pix.cpu(), CAM)


def test_serve_localises_a_small_queue(cuda):
    from dsac_tpu_torch.cli import serve
    res = serve.main(["--synthetic", "8", "--batch", "4", "--queue", "2",
                      "--reps", "1"])
    assert res["accuracy_5cm5deg"] >= 0.95 and res["poses_finite"]


def test_test_ransac_evaluates_two_frames(cuda):
    from dsac_tpu_torch.cli import test_ransac
    from dsac_tpu_torch.ops.p3p_cuda import p3p_solve
    before = (refine_pose_fused.launches, diffmaps.launches,
              p3p_solve.launches, irls_stats.launches)
    res = test_ransac.main(["--synthetic", "2", "--fused-refine", "--rdraw",
                            "0", "--check-refine"])
    assert (refine_pose_fused.launches, diffmaps.launches,
            p3p_solve.launches, irls_stats.launches) == (
        before[0] + 2, before[1] + 2, before[2], before[3] + 2 * 16)
    assert res["accuracy_5cm5deg"] >= 0.5 and res["all_finite"]
    # tests/test_gn_pallas.py:112-115, at the served hypothesis
    assert res["refine_check"]["served_max_abs_dt_mm"] <= 1e-2
    assert res["refine_check"]["served_max_abs_dR"] <= 1e-5


@pytest.mark.parametrize("layout", [None] + REFINE_LAYOUTS,
                         ids=lambda x: "auto" if x is None else
                         "c{}g{}w{}".format(*x))
def test_init_backward_matches_plain_version(problem, layout, monkeypatch):
    """One launch of the refine kernel on the 12 probes of each pose, in
    the layout that refine_layout picks or in the one given (for both the
    forward and the backward)."""
    rng, gt, coords, pix = problem
    if layout is not None:
        monkeypatch.setattr(gn_cuda, "refine_layout", lambda *a: layout)
    R0 = _pool(rng, gt, 0.15, 300.0, P=3)

    def grad(plain):
        R = R0.R.clone().requires_grad_()
        t = R0.t.clone().requires_grad_()
        out = refine_init_sensitive(Pose(R, t), coords, pix, CAM,
                                    outer_steps=4, inner_iters=1, plain=plain)
        pose_to_vec6(out).sum().backward()
        return torch.cat([R.grad.flatten(1), t.grad.flatten(1)], 1)

    before = InitSensitiveRefine.launches
    k = grad(False)
    assert InitSensitiveRefine.launches == before + 1
    p = grad(True)
    assert InitSensitiveRefine.launches == before + 1
    assert torch.isfinite(k).all()
    cos = torch.nn.functional.cosine_similarity(k.double(), p.double(), 1)
    ratio = k.double().norm(dim=1) / p.double().norm(dim=1)
    assert bool((cos >= 0.999).all()) and bool(
        ((ratio >= 0.99) & (ratio <= 1.01)).all()), (cos, ratio)


def test_launch_runs_on_the_tensors_device(problem):
    """Tensors on cuda:1 while cuda:0 is current: the launch goes to the
    tensors' device and stream and gives the result it gives there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng, gt, coords, pix = problem
    pool = _pool(rng, gt, 0.01, 30.0, P=8)
    want, n_want = refine_pose_fused(pool, coords, pix, CAM)
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        got, n_got = refine_pose_fused(
            Pose(pool.R.to(other), pool.t.to(other)), coords.to(other),
            pix.to(other), CAM)
        scores = soft_inlier_scores(pool.R.to(other), pool.t.to(other),
                                    coords.to(other), pix.to(other), CAM)
    assert got.t.device == other
    torch.testing.assert_close(got.t.cpu(), want.t.cpu())
    torch.testing.assert_close(n_got.cpu(), n_want.cpu())
    torch.testing.assert_close(
        scores.cpu(), soft_inlier_scores(pool.R, pool.t, coords, pix,
                                         CAM).cpu())
