"""The port's synthetic archetypes against dsac_tpu/data/synthetic.py.

The reference draws the archetypes' wave sets, its poses and its
occluders from jax.random, so the port reads them from the fixture
dsac_tpu_torch/data/scene_frames.json; this file writes it from the
reference and holds the fixture to it (1e-6: the fixture stores the
reference's f32 values).  The fixture also records, per archetype, the
reference's statistics of 8 full-size frames of the seed-99 set (mean RGB,
mean depth, the occluded share, the gray share), which chip_smoke.py's
``scenes`` phase holds the port's render on the card to.

Renders are held to the reference's at 64 x 48 (focal 52.5) with the
reference's own draws injected (occluders, RGB and depth noise): RGB to
0.05 of 255, depth and coordinates to 1e-2 mm with rtol 1e-5, the room's
bars.  Two kinds of pixel may flip, and every other pixel meets the bar:

* under a texture period (``repeat``, ``hard``), a pixel whose point lies
  within 0.01 mm of a multiple of the period can wrap to the other side
  in f32, because floor(p / L) flips.  The room's walls lie at 0, 3000
  and 4000 mm, all multiples of the 500 mm period, so every wall pixel is
  such a pixel: f32 rounding of o + t d picks, pixel by pixel, which side
  of the wall's wrap its texture reads (the reference's own jitted frame
  and its eager render differ by up to 85 of 255 on half the pixels).  So
  these flips excuse RGB alone, with no cap: depth and coordinates do not
  read the texture and meet their bars there; the texture itself is held
  on the reference's own points instead, where both sides read the same
  coordinates;
* under occluders (``clutter``, ``hard``), a pixel on a box's edge can
  flip between hit and miss: at most 0.1% of a frame.

Running it as a script rewrites the fixture:

    PYTHONPATH=. python tests/test_torch_scenes.py
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsac_tpu.data.synthetic import ARCHETYPES as JAX_ARCHETYPES
from dsac_tpu.data.synthetic import SyntheticScene as JaxScene
from dsac_tpu.data.synthetic import make_scene as jax_make_scene
from dsac_tpu_torch.data.synthetic import (ARCHETYPES, FRAME_SETS,
                                           SCENE_FIXTURE, WAVE_SETS, Effects,
                                           Occluders, SyntheticScene,
                                           frame_key, frame_set, make_scene,
                                           render_frames)
from dsac_tpu_torch.geometry.pose import Pose
from torch_problems import one_torch_thread  # noqa: F401

SMALL = dict(width=64, height=48, focal=52.5)
OCCLUDER_COUNTS = (5, 3)  # clutter, hard
STATS_SET, STATS_FRAMES = "seed99", 8  # the smoke's scenes phase
GRAY_TOL = 4.0  # a pixel within 4 of mid-gray on every channel is gray
FLIP_SHARE = 1e-3  # the named pixel flips, at most 0.1% of a frame


def lst(x):
    return np.asarray(x, np.float32).astype(float).tolist()


def reference_draws(scene: JaxScene, key):
    """The reference's draws of one frame under its key schedule
    (synthetic.py:276-302, 201-251): (pose, centres, half sizes, anchors,
    RGB noise, depth noise), each None where the scene has none."""
    if scene._needs_frame_key:
        kpose, keff = jax.random.split(key)
    else:
        kpose, keff = key, None
    pose = scene.random_pose(kpose)
    occ = rgb = dep = None
    if keff is not None:
        k_occ, k_rgb, k_dep = jax.random.split(keff, 3)
        bounds = jnp.asarray(scene.room_mm)
        n = scene.n_occluders
        if n > 0:
            kc, kh, ka = jax.random.split(k_occ, 3)
            lo, hi = scene.occluder_half_mm
            occ = (jax.random.uniform(kc, (n, 3), minval=bounds * 0.2,
                                      maxval=bounds * 0.8),
                   jax.random.uniform(kh, (n, 3), minval=lo, maxval=hi),
                   jax.random.uniform(ka, (n, 3), minval=bounds * 0.1,
                                      maxval=bounds * 0.9))
        if scene.noise_std > 0:
            rgb = jax.random.normal(k_rgb, (scene.height, scene.width, 3))
        if scene.label_noise_mm > 0:
            dep = jax.random.normal(k_dep, (scene.height, scene.width))
    return pose, occ, rgb, dep


def to_effects(occ, rgb, dep) -> Effects:
    def t(x):
        return None if x is None else torch.from_numpy(
            np.array(x, np.float32))[None]
    return Effects(None if occ is None else Occluders(*(t(x) for x in occ)),
                   t(rgb), t(dep))


def frame_stats(rgb, depth, occluded) -> dict:
    """Mean RGB, the mean positive depth, the degenerate pixels, the
    occluded share and the gray share of a stack of frames (numpy).

    A degenerate pixel is the reference's own: where a ray's direction
    has a component in (-1e-9, 0], its exit takes 1e-9 for it and a wall
    behind the camera, t = -origin / 1e-9 (synthetic.py:196-201), some
    -1e12 mm; f32 rounding decides which pixels, about one in 8 frames
    of the seed-99 set."""
    rgb = np.asarray(rgb, np.float64)
    depth = np.asarray(depth, np.float64)
    return {"mean_rgb": float(rgb.mean()),
            "mean_depth_mm": float(depth[depth > 0].mean()),
            "degenerate_pixels": int((depth <= 0).sum()),
            "occluded_share": float(np.mean(occluded)),
            "gray_share": float(np.mean(np.all(np.abs(rgb - 127.5)
                                               < GRAY_TOL, axis=-1)))}


def reference_stats(name: str) -> dict:
    """The reference's statistics of the first STATS_FRAMES frames of the
    seed-99 set of archetype ``name`` at full size; a pixel is occluded
    where the frame without noise lies over 1 mm nearer than the walls."""
    scene = jax_make_scene(name)
    first = FRAME_SETS[STATS_SET][0]
    quiet = jax_make_scene(name, noise_std=0.0, label_noise_mm=0.0)
    rgbs, depths, occluded = [], [], []
    for i in range(STATS_FRAMES):
        key = jax.random.PRNGKey(first + i)
        pose, rgb, depth, _ = scene.frame(key)
        rgbs.append(np.asarray(rgb))
        depths.append(np.asarray(depth))
        if scene._needs_frame_key:
            keff = jax.random.split(key)[1]
            _, d_occ, _ = quiet.render(pose, keff)
            _, d_wall, _ = quiet.render(pose)
            occluded.append(np.asarray(d_occ) < np.asarray(d_wall) - 1.0)
        else:
            occluded.append(np.zeros(depths[-1].shape, bool))
    return frame_stats(np.stack(rgbs), np.stack(depths), np.stack(occluded))


def reference_fixture() -> dict:
    scene = JaxScene()
    waves = {}
    for name, (offset, n, lo, hi) in WAVE_SETS.items():
        freqs, dirs, phases = scene._wave_params(offset, n, lo, hi)
        waves[name] = {"seed_offset": offset, "freqs": lst(freqs[:, 0]),
                       "dirs": lst(dirs), "phases": lst(phases)}
    sets = {}
    for name, (first, n) in FRAME_SETS.items():
        keys = jax.vmap(jax.random.PRNGKey)(np.arange(first, first + n))
        room = jax.vmap(scene.random_pose)(keys)
        keyed = jax.vmap(scene.random_pose)(
            jax.vmap(lambda k: jax.random.split(k)[0])(keys))
        occluders = {}
        for m in OCCLUDER_COUNTS:
            draws = [reference_draws(jax_make_scene("clutter",
                                                    n_occluders=m),
                                     jax.random.PRNGKey(first + i))[1]
                     for i in range(n)]
            occluders[str(m)] = {
                field: lst(np.stack([d[j] for d in draws]))
                for j, field in enumerate(Occluders._fields)}
        sets[name] = {"first_key": first, "frames": n,
                      "room": {"R": lst(room.R), "t": lst(room.t)},
                      "keyed": {"R": lst(keyed.R), "t": lst(keyed.t)},
                      "occluders": occluders}
    return {
        "source": "dsac_tpu.data.synthetic (seed 1305): _wave_params(7, 4, "
                  "2500, 8000) and (13, 4, 500, 1800); for each frame set, "
                  "random_pose of PRNGKey(first_key + i) (room) and of its "
                  "split's first key (keyed), and the occluder draws of 5 "
                  "and 3 boxes; stats: 8 full-size frames of seed 99 a "
                  "scene; written by tests/test_torch_scenes.py",
        "waves": waves, "frame_sets": sets,
        "stats": {name: reference_stats(name) for name in JAX_ARCHETYPES},
    }


@pytest.fixture(scope="module")
def fixture() -> dict:
    return json.loads(SCENE_FIXTURE.read_text())


# ---- the fixture against the reference ----

def test_fixture_waves_match_reference(fixture):
    scene = JaxScene()
    for name, (offset, n, lo, hi) in WAVE_SETS.items():
        freqs, dirs, phases = scene._wave_params(offset, n, lo, hi)
        got = fixture["waves"][name]
        for k, v in (("freqs", freqs[:, 0]), ("dirs", dirs),
                     ("phases", phases)):
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=0,
                                       atol=1e-6, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("name", list(FRAME_SETS))
def test_fixture_frames_match_reference(fixture, name):
    """Every pose under both schedules and every occluder draw; a few
    frames also through the reference's own jitted ``frame``."""
    first, n = FRAME_SETS[name]
    got = fixture["frame_sets"][name]
    assert (got["first_key"], got["frames"]) == (first, n)
    scene = JaxScene()
    for i in range(n):
        key = jax.random.PRNGKey(first + i)
        for sched, sc in (("room", scene),
                          ("keyed", jax_make_scene("noisy"))):
            pose = reference_draws(sc, key)[0]
            np.testing.assert_allclose(got[sched]["R"][i],
                                       np.asarray(pose.R), atol=1e-6)
            np.testing.assert_allclose(got[sched]["t"][i],
                                       np.asarray(pose.t), atol=1e-6)
    for m in OCCLUDER_COUNTS:
        sc = jax_make_scene("clutter", n_occluders=m)
        for i in (0, n - 1):
            occ = reference_draws(sc, jax.random.PRNGKey(first + i))[1]
            for j, field in enumerate(Occluders._fields):
                np.testing.assert_allclose(
                    got["occluders"][str(m)][field][i], np.asarray(occ[j]),
                    atol=1e-6)
    pose = jax_make_scene("clutter", **SMALL).frame(
        jax.random.PRNGKey(first))[0]
    np.testing.assert_allclose(got["keyed"]["R"][0], np.asarray(pose.R),
                               atol=1e-6)
    np.testing.assert_allclose(got["keyed"]["t"][0], np.asarray(pose.t),
                               atol=1e-3)


def test_fixture_stats_match_reference(fixture):
    """The recorded statistics of the cheapest archetype again (the rest
    cost ~1 s a full-size frame on the CPU)."""
    want = reference_stats("bare")
    for k, v in want.items():
        assert fixture["stats"]["bare"][k] == pytest.approx(v, rel=1e-9)
    assert set(fixture["stats"]) == set(JAX_ARCHETYPES)


# ---- the archetypes against the reference ----

def test_registry_matches_reference():
    assert ARCHETYPES == JAX_ARCHETYPES
    for name in ARCHETYPES:
        ref = jax_make_scene(name)
        k = make_scene(name, device="cpu").knobs
        for field in ("texture_period_mm", "texture_repeat_weight",
                      "texture_sparsity", "noise_std", "label_noise_mm",
                      "n_occluders", "occluder_half_mm"):
            assert getattr(k, field) == getattr(ref, field), (name, field)
        assert k.needs_frame_key == ref._needs_frame_key
    with pytest.raises(ValueError, match="unknown scene archetype"):
        make_scene("nope", device="cpu")


def flips(a, b, rtol, atol) -> np.ndarray:
    """Pixels (H, W) where a misses b's bar on some channel."""
    bad = np.abs(a - b) > atol + rtol * np.abs(b)
    return bad if bad.ndim == 2 else bad.any(axis=-1)


def wrap_pixels(coords, period) -> np.ndarray:
    """Pixels whose point lies within 0.01 mm of a multiple of the
    period on some axis."""
    r = np.mod(np.asarray(coords, np.float64), period)
    return (np.minimum(r, period - r) < 1e-2).any(axis=-1)


def edge_pixels(occluded) -> np.ndarray:
    """Pixels on an occluder's edge: occluded and not, 4-neighbours."""
    o = np.asarray(occluded)
    edge = np.zeros_like(o)
    edge[1:] |= o[1:] != o[:-1]
    edge[:-1] |= o[1:] != o[:-1]
    edge[:, 1:] |= o[:, 1:] != o[:, :-1]
    edge[:, :-1] |= o[:, 1:] != o[:, :-1]
    return edge


@pytest.fixture(scope="module")
def reference_renders():
    """Each archetype's small frames of keys 3 and 11: the reference's
    render, its draws, and its occlusion without noise."""
    out = {}
    for name in ARCHETYPES:
        scene = jax_make_scene(name, **SMALL)
        quiet = jax_make_scene(name, noise_std=0.0, label_noise_mm=0.0,
                               **SMALL)
        for k in (3, 11):
            key = jax.random.PRNGKey(k)
            _pose, rgb, depth, coords = scene.frame(key)
            pose, occ, nrgb, ndep = reference_draws(scene, key)
            # the texture's points of the walls: the noise-free render's
            # coordinates where no box occludes
            keff = jax.random.split(key)[1] if occ is not None else None
            _, d_quiet, c_quiet = quiet.render(pose, keff)
            occluded = np.asarray(d_quiet) < np.asarray(
                quiet.render(pose)[1]) - 1.0
            out[name, k] = (pose, (occ, nrgb, ndep),
                            tuple(np.asarray(x) for x in (rgb, depth,
                                                          coords)),
                            occluded, np.asarray(c_quiet))
    return out


@pytest.mark.parametrize("name", list(ARCHETYPES))
def test_render_matches_reference(reference_renders, name):
    """With the reference's draws injected, every pixel meets the room's
    bars but the named flips (module docstring), and the texture meets
    the RGB bar on the reference's own points."""
    scene = make_scene(name, device="cpu", **SMALL)
    ref_scene = jax_make_scene(name, **SMALL)
    k = scene.knobs
    for key in (3, 11):
        pose, draws, (rgb, depth, coords), occluded, walls = \
            reference_renders[name, key]
        R = torch.from_numpy(np.array(pose.R))[None]
        t = torch.from_numpy(np.array(pose.t))[None]
        got = [x[0].numpy() for x in scene.render(Pose(R, t),
                                                   to_effects(*draws))]
        wrap = (wrap_pixels(walls, k.texture_period_mm) & ~occluded
                if k.texture_period_mm > 0 else np.zeros(depth.shape, bool))
        edge = (edge_pixels(occluded) if k.n_occluders > 0
                else np.zeros(depth.shape, bool))
        # the wrap excuses the texture's RGB only: depth and coordinates
        # do not read the texture
        bad = ((flips(got[0], rgb, 0.0, 0.05) & ~wrap)
               | flips(got[1], depth, 1e-5, 1e-2)
               | flips(got[2], coords, 1e-5, 1e-2))
        assert not (bad & ~edge).any(), (name, key, int(bad.sum()))
        assert (bad & edge).mean() <= FLIP_SHARE, (name, key)
        np.testing.assert_allclose(
            scene.texture(torch.from_numpy(coords.copy())).numpy(),
            np.asarray(ref_scene.texture(jnp.asarray(coords))), atol=0.05)


def test_frame_sets_are_the_reference_poses(fixture):
    """frame_set's poses are the fixture's under each schedule; the room's
    bench set is room_default.json's bench poses."""
    room = SyntheticScene(device="cpu")
    fs = frame_set(room, 0, 64)
    assert fs.origin == "reference" and fs.keys[0] == 9000
    torch.testing.assert_close(fs.poses.R, room.bench_poses.R)
    torch.testing.assert_close(fs.poses.t, room.bench_poses.t)
    for name in ("repeat", "clutter", "hard"):
        scene = make_scene(name, device="cpu")
        fs = frame_set(scene, 99, 24)
        sched = "keyed" if scene.knobs.needs_frame_key else "room"
        assert fs.origin == "reference"
        assert fs.keys == [frame_key(99, i) for i in range(24)]
        np.testing.assert_array_equal(
            fs.poses.t.numpy(),
            np.asarray(fixture["frame_sets"]["seed99"][sched]["t"],
                       np.float32))
        if scene.knobs.n_occluders:
            np.testing.assert_array_equal(
                fs.occluders.centers.numpy(),
                np.asarray(fixture["frame_sets"]["seed99"]["occluders"][
                    str(scene.knobs.n_occluders)]["centers"], np.float32))
    mixed = frame_set(make_scene("clutter", device="cpu"), 99, 26)
    assert mixed.origin == "reference+drawn"
    assert mixed.occluders.centers.shape == (26, 5, 3)
    drawn = frame_set(room, 1305, 4)
    assert drawn.origin == "drawn" and drawn.occluders is None
    # train_ransac's views of seed 1305 as they have always been drawn
    views = room.random_pose(torch.Generator().manual_seed(1305), 4)
    torch.testing.assert_close(drawn.poses.t, views.t)


def test_effects_deterministic_per_seed_and_index():
    """A frame's effects depend on (seed, index) alone: the same frame in
    another batch, or of a longer set, renders the same."""
    scene = make_scene("hard", device="cpu", **SMALL)
    fs = frame_set(scene, 5, 4)
    a = render_frames(scene, fs, [2])
    b = render_frames(scene, fs, [0, 2])
    c = render_frames(scene, frame_set(scene, 5, 6), [2])
    for x, y, z in zip(a, b, c):
        x = x.R if isinstance(x, Pose) else x
        y = y.R[1:] if isinstance(y, Pose) else y[1:]
        z = z.R if isinstance(z, Pose) else z
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        if not isinstance(x, tuple):
            assert x.shape == z.shape
    other = render_frames(scene, frame_set(scene, 6, 4), [2])
    assert not torch.equal(a[0], other[0])


def test_drawn_effects_follow_reference_distributions():
    """The port's draws against the reference's on the same counts:
    occluder moments (uniform: mean (a+b)/2, std (b-a)/sqrt(12)), the
    noise's mean and std, and the occluded share of small frames."""
    scene = make_scene("clutter", device="cpu", **SMALL)
    ref_scene = jax_make_scene("clutter", **SMALL)
    n = 256
    occ = scene.draw_occluders(torch.Generator().manual_seed(0), n)
    ref = [reference_draws(ref_scene, jax.random.PRNGKey(k))[1]
           for k in range(n)]
    bounds = np.asarray([4000.0, 3000.0, 4000.0])
    for j, (lo, hi) in enumerate(((bounds * 0.2, bounds * 0.8),
                                  (150.0, 450.0),
                                  (bounds * 0.1, bounds * 0.9))):
        ours = occ[j].reshape(-1, 3).numpy()
        theirs = np.stack([r[j] for r in ref]).reshape(-1, 3)
        width = np.broadcast_to(np.asarray(hi) - np.asarray(lo), (3,))
        for x in (ours, theirs):
            assert (x >= lo - 1e-3).all() and (x <= hi + 1e-3).all()
            np.testing.assert_allclose(x.mean(0), (np.asarray(hi)
                                                   + np.asarray(lo)) / 2,
                                       atol=0.06 * width.max())
            np.testing.assert_allclose(x.std(0), width / 12 ** 0.5,
                                       rtol=0.08)
    rgb, dep = make_scene("noisy", device="cpu").draw_noise(
        torch.Generator().manual_seed(1))
    for x in (rgb, dep):
        assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 1) < 0.01
    # the occluded share of the port's draws against the reference's
    quiet_ref = jax_make_scene("clutter", **SMALL)
    fs = frame_set(scene, 1305, 48)
    share_port = share_ref = 0.0
    for i in range(48):
        pose = Pose(fs.poses.R[i:i + 1], fs.poses.t[i:i + 1])
        occ_i = Occluders(*(x[i:i + 1] for x in fs.occluders))
        d_occ = scene.render(pose, Effects(occ_i, None, None))[1]
        share_port += float((d_occ < scene.render(pose)[1] - 1.0)
                            .float().mean()) / 48
        key = jax.random.PRNGKey(1000 + i)
        jpose = reference_draws(quiet_ref, key)[0]
        keff = jax.random.split(key)[1]
        d = quiet_ref.render(jpose, keff)[1]
        share_ref += float(np.mean(np.asarray(d) < np.asarray(
            quiet_ref.render(jpose)[1]) - 1.0)) / 48
    assert 0.02 < share_port < 0.6 and 0.02 < share_ref < 0.6
    assert abs(share_port - share_ref) < 0.1, (share_port, share_ref)


# ---- the reference's archetype tests, mirrored (tests/
# test_synthetic_archetypes.py:23-127) ----

def test_default_room_unchanged():
    """make_scene('room') renders as SyntheticScene() does, bit for bit."""
    pose = Pose(*(x[:2] for x in SyntheticScene(device="cpu").bench_poses))
    a = make_scene("room", device="cpu", **SMALL).render(pose)
    b = SyntheticScene(device="cpu", **SMALL).render(pose)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_repeat_texture_periodicity():
    sc = make_scene("repeat", device="cpu")
    L = sc.knobs.texture_period_mm
    pts = 300.0 + 2200.0 * torch.rand((512, 3),
                                      generator=torch.Generator()
                                      .manual_seed(0))
    t0 = sc.texture(pts)
    d_period = float((sc.texture(pts + torch.tensor([L, 0.0, 0.0]))
                      - t0).abs().mean())
    d_other = float((sc.texture(pts + torch.tensor([0.61 * L, 0.0, 0.0]))
                     - t0).abs().mean())
    assert d_period < 0.25 * d_other and d_period < 8.0


def test_bare_flattens_surface():
    sc = make_scene("bare", device="cpu")
    pts = 3000.0 * torch.rand((4096, 3),
                              generator=torch.Generator().manual_seed(1))
    tex = sc.texture(pts).numpy()
    gray = np.all(np.abs(tex - 127.5) < GRAY_TOL, axis=-1)
    assert 0.45 < gray.mean() < 0.9, gray.mean()
    assert tex[~gray].std() > 10.0


def test_noisy_depth_noise_is_along_ray():
    sc = make_scene("noisy", device="cpu", **SMALL)
    fs = frame_set(sc, 11, 1)
    rgb, depth, coords, pose = render_frames(sc, fs, [0])
    rgb0, depth0, coords0 = sc.render(pose)
    dd = (depth - depth0).numpy()
    assert 0.5 * 30.0 < dd.std() < 2.0 * 30.0
    dist = np.linalg.norm((coords - coords0).numpy(), axis=-1)
    ray_norm = dist / np.maximum(np.abs(dd), 1e-9)
    assert np.all(ray_norm > 0.99) and np.all(ray_norm < 2.5)
    dr = (rgb - rgb0).numpy()
    assert 0.3 * 12.0 < dr.std() < 2.0 * 12.0
    assert float(rgb.max()) <= 255.0 and float(rgb.min()) >= 0.0


def test_clutter_occludes_and_decoys():
    sc = make_scene("clutter", device="cpu", n_occluders=8, **SMALL)
    fs = frame_set(sc, 100, 6)
    hit_any = False
    for i in range(6):
        rgb, depth, coords, pose = render_frames(sc, fs, [i])
        rgb0, depth0, _ = sc.render(pose)
        d, d0 = depth.numpy(), depth0.numpy()
        occ = d < d0 - 1.0
        assert np.all(d <= d0 + 1e-3)
        if 0.01 < occ.mean() < 0.9:
            hit_any = True
            mismatch = np.abs(rgb.numpy() - sc.texture(coords).numpy()
                              ).mean(-1)
            assert mismatch[occ].mean() > 5.0 * mismatch[~occ].mean()
    assert hit_any, "no frame had >1% occluded pixels"


def test_every_archetype_renders_finite_and_in_range():
    for name in ARCHETYPES:
        sc = make_scene(name, device="cpu", width=32, height=24,
                        focal=26.25)
        rgb, depth, coords, _ = render_frames(sc, frame_set(sc, 99, 2),
                                              [0, 1])
        for x in (rgb, depth, coords):
            assert torch.isfinite(x).all(), name
        assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 255.0
        assert float(depth.min()) > 0.0, name


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else SCENE_FIXTURE
    out.write_text(json.dumps(reference_fixture()) + "\n")
    print(f"wrote {out} ({out.stat().st_size} bytes)")
