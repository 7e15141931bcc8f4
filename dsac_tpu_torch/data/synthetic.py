"""The reference's procedural room and its archetypes, rendered with
PyTorch on the device (port of dsac_tpu/data/synthetic.py).

The reference draws its texture parameters, its poses and its occluders
from ``jax.random``, which PyTorch cannot reproduce, so they come from
two fixtures written from the reference:

* ``room_default.json``: the room's 12 wave frequencies, directions and
  phases (seed 1305), and the 64 bench poses of keys 9000..9063
  (bench.py:135), scene -> eye, which are also the ground truth;
* ``scene_frames.json``: the two further wave sets of the archetypes
  (seed offsets 7 and 13), and for three frame sets (``FRAME_SETS``) the
  reference's poses under both of its key schedules and the occluder
  draws of ``clutter`` (5 boxes) and ``hard`` (3).

What neither fixture holds is drawn on the device from an explicit
``torch.Generator``: the reference's distributions, not its draws.  That
is always so for the per-pixel noise of ``noisy`` and ``hard`` (RGB noise
and depth noise along the ray), and for poses and occluders of frames
outside the fixture's sets.  Drawing is apart from rendering: ``render``
takes the drawn effects (``Effects``) as an argument, and
``draw_occluders`` and ``draw_noise`` make them from a generator, so a
test can feed the reference's own draws in.  A frame's effects are drawn from a generator seeded with the
frame's key, so they are deterministic in (seed, frame index).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import NamedTuple

import torch

from dsac_tpu_torch import resolve_device
from dsac_tpu_torch.config import Camera
from dsac_tpu_torch.geometry.pose import Pose, invert
from dsac_tpu_torch.geometry.rotation import so3_exp

FIXTURE = Path(__file__).resolve().parent / "room_default.json"
SCENE_FIXTURE = Path(__file__).resolve().parent / "scene_frames.json"
ROOM_MM = (4000.0, 3000.0, 4000.0)  # the box [0, w] x [0, h] x [0, d]
KEY_STRIDE = 100003  # SyntheticSource keys frame i of seed s s * 100003 + i
BENCH_KEY = 9000  # bench.py keys frame i 9000 + i
# the frame sets of scene_frames.json: name -> (first key, frames); the
# bench frames, SyntheticSource's seed 99 (the test split that judged the
# archetype weights; export_synthetic's --test-seed) and seed 3
# (export_synthetic's --train-seed)
FRAME_SETS = {"bench": (BENCH_KEY, 64), "seed99": (99 * KEY_STRIDE, 24),
              "seed3": (3 * KEY_STRIDE, 48)}
# the wave sets of the archetypes: name -> (seed offset, waves, shortest
# and longest wavelength in mm) (synthetic.py:117-126)
WAVE_SETS = {"repeat_coarse": (7, 4, 2500.0, 8000.0),
             "sparsity": (13, 4, 500.0, 1800.0)}
SPARSITY_WAVES = WAVE_SETS["sparsity"][1]


@dataclasses.dataclass(frozen=True)
class SceneKnobs:
    """The archetype knobs of the reference (synthetic.py:58-71); all off
    is the default room."""

    texture_period_mm: float = 0.0
    texture_repeat_weight: float = 0.92
    texture_sparsity: float = 0.0
    noise_std: float = 0.0
    label_noise_mm: float = 0.0
    n_occluders: int = 0
    occluder_half_mm: tuple[float, float] = (150.0, 450.0)

    @property
    def needs_frame_key(self) -> bool:
        """Whether a frame's key is split into a pose key and an effects
        key (synthetic.py:77-80); if not, the key is the pose's alone and
        the poses are the room's."""
        return (self.noise_std > 0 or self.label_noise_mm > 0
                or self.n_occluders > 0)


# The named archetypes (synthetic.py:310-326).
ARCHETYPES: dict[str, dict] = {
    "room": {},
    "repeat": dict(texture_period_mm=500.0, texture_repeat_weight=0.92),
    "bare": dict(texture_sparsity=0.7),
    "noisy": dict(noise_std=12.0, label_noise_mm=30.0),
    "clutter": dict(n_occluders=5),
    "hard": dict(texture_period_mm=500.0, texture_sparsity=0.4,
                 noise_std=8.0, label_noise_mm=20.0, n_occluders=3),
}


class Occluders(NamedTuple):
    """Floating decoy boxes of B frames, each (B, n, 3) in mm: centres,
    half sizes, and the decoy anchors their texture is read at."""

    centers: torch.Tensor
    halfs: torch.Tensor
    anchors: torch.Tensor


class Effects(NamedTuple):
    """The drawn per-frame effects of B frames; None where the scene has
    no such effect."""

    occluders: Occluders | None
    rgb_noise: torch.Tensor | None  # (B, H, W, 3), standard normal
    depth_noise: torch.Tensor | None  # (B, H, W), standard normal


class FrameSet(NamedTuple):
    """A seeded frame set of a scene: poses, occluders, keys and where
    each came from."""

    poses: Pose  # (n,) scene -> eye, the ground truth
    occluders: Occluders | None  # (n, k, 3) each; None without occluders
    keys: list[int]  # frame i's key, which seeds its drawn effects
    origin: str  # "reference", "drawn" or "reference+drawn"


def _load_fixture(path: Path) -> dict:
    return json.loads(path.read_text())


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _mix(points_mm: torch.Tensor, waves) -> torch.Tensor:
    """Sinusoid mixture (..., 3) in [-1, 1] (synthetic.py:105-112)."""
    freqs, dirs, phases = waves
    proj = points_mm @ dirs.T  # (..., M)
    arg = proj[..., :, None] * freqs[:, None] + phases
    return torch.mean(torch.sin(arg), dim=-2)


class SyntheticScene:
    """The reference's room, an axis-aligned box textured by a sinusoid
    mixture of the 3D surface point, with the knobs of an archetype
    (``SceneKnobs``).  Frames are (B, H, W, 3) RGB in [0, 255] with depth
    and scene coordinates."""

    def __init__(self, width: int = 640, height: int = 480,
                 focal: float = 525.0, device: torch.device | str = "cuda",
                 name: str = "room", **knobs):
        self.width, self.height, self.focal = width, height, focal
        self.device = resolve_device(device)
        self.name = name
        self.knobs = SceneKnobs(**knobs)
        fx = _load_fixture(FIXTURE)
        tex = fx["texture"]
        dev = self.device
        self.waves = (_f32(tex["freqs"], dev), _f32(tex["dirs"], dev),
                      _f32(tex["phases"], dev))
        self.bench_poses = Pose(_f32(fx["bench_poses"]["R"], dev),
                                _f32(fx["bench_poses"]["t"], dev))
        k = self.knobs
        self.extra_waves = {}
        if k.texture_period_mm > 0 or k.texture_sparsity > 0:
            waves = _load_fixture(SCENE_FIXTURE)["waves"]
            self.extra_waves = {
                name: (_f32(w["freqs"], dev), _f32(w["dirs"], dev),
                       _f32(w["phases"], dev))
                for name, w in waves.items()}

    @property
    def camera(self) -> Camera:
        return Camera.make(self.focal, self.width, self.height)

    def random_pose(self, generator: torch.Generator,
                    batch: int = 1) -> Pose:
        """Random scene -> eye poses (batch,) of a camera standing inside
        the room and looking inward (synthetic.py:146-168): its centre
        uniform in the middle half of the floor plan at 0.3-0.7 of the
        height, yaw uniform in [0, 2 pi), pitch in [-0.35, 0.35] and roll
        in [-0.2, 0.2] rad, the camera-to-scene rotation yaw (about y)
        after pitch (x) after roll (z).  ``generator`` lies on the scene's
        device."""
        w, h, d = ROOM_MM
        f32 = dict(dtype=torch.float32, device=self.device)

        def uniform(lo, hi, shape):
            lo = torch.as_tensor(lo, **f32)
            hi = torch.as_tensor(hi, **f32)
            return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                               **f32)

        pos = uniform([w * 0.25, h * 0.3, d * 0.25],
                      [w * 0.75, h * 0.7, d * 0.75], (batch, 3))
        yaw = uniform(0.0, 2 * math.pi, (batch,))
        pitch = uniform(-0.35, 0.35, (batch,))
        roll = uniform(-0.2, 0.2, (batch,))
        eye = torch.eye(3, **f32)
        Rc = (so3_exp(eye[1] * yaw[:, None]) @ so3_exp(eye[0] * pitch[:, None])
              @ so3_exp(eye[2] * roll[:, None]))
        return invert(Pose(Rc, pos))

    def texture(self, points_mm: torch.Tensor) -> torch.Tensor:
        """Scene points (..., 3) -> RGB in [0, 255] (..., 3)
        (synthetic.py:114-144): under a texture period the room's waves
        see the point modulo the period, mixed with a weak coarse wave
        set; under sparsity a third wave set, thresholded at its quantile
        of the sparsity through a sigmoid of width 0.02, flattens part of
        the surface to gray."""
        k = self.knobs
        if k.texture_period_mm > 0:
            L = k.texture_period_mm
            wrapped = points_mm - L * torch.floor(points_mm / L)
            w = k.texture_repeat_weight
            mix = (w * _mix(wrapped, self.waves) + (1.0 - w)
                   * _mix(points_mm, self.extra_waves["repeat_coarse"]))
        else:
            mix = _mix(points_mm, self.waves)
        if k.texture_sparsity > 0:
            field = torch.mean(_mix(points_mm, self.extra_waves["sparsity"]),
                               dim=-1)
            # the field is ~N(0, sigma^2): M averaged unit sinusoids a
            # channel, then the mean of 3 channels
            sigma = (1.0 / (2.0 * SPARSITY_WAVES)) ** 0.5 / 3.0 ** 0.5
            thresh = NormalDist().inv_cdf(min(k.texture_sparsity,
                                              0.999)) * sigma
            mix = mix * torch.sigmoid((field - thresh) / 0.02)[..., None]
        return (mix * 0.5 + 0.5) * 255.0

    def draw_occluders(self, generator: torch.Generator,
                       batch: int = 1) -> Occluders | None:
        """Occluders of ``batch`` frames drawn from ``generator`` (on the
        scene's device) in the reference's distributions
        (synthetic.py:244-251): centres uniform in 0.2-0.8 of the room,
        half sizes in ``occluder_half_mm``, anchors in 0.1-0.9 of the
        room; None without occluders."""
        k = self.knobs
        if k.n_occluders == 0:
            return None
        f32 = dict(dtype=torch.float32, device=self.device)
        bounds = torch.tensor(ROOM_MM, **f32)
        shape = (batch, k.n_occluders, 3)

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                               **f32)

        lo, hi = k.occluder_half_mm
        return Occluders(uniform(bounds * 0.2, bounds * 0.8),
                         uniform(lo, hi),
                         uniform(bounds * 0.1, bounds * 0.9))

    def draw_noise(self, generator: torch.Generator, batch: int = 1
                   ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        """Standard-normal RGB noise (batch, H, W, 3) and depth noise
        (batch, H, W) from ``generator``; None where the scene has none
        (synthetic.py:214-229)."""
        k = self.knobs
        f32 = dict(dtype=torch.float32, device=self.device)
        H, W = self.height, self.width
        rgb = (torch.randn((batch, H, W, 3), generator=generator, **f32)
               if k.noise_std > 0 else None)
        depth = (torch.randn((batch, H, W), generator=generator, **f32)
                 if k.label_noise_mm > 0 else None)
        return rgb, depth

    def render(self, pose: Pose, effects: Effects | None = None):
        """Render scene -> eye poses R (B, 3, 3), t (B, 3) with the drawn
        ``effects`` (synthetic.py:170-233); without them, the walls
        alone, noise-free.

        Returns rgb (B, H, W, 3) float32 in [0, 255], depth (B, H, W) mm
        and coords (B, H, W, 3) ground-truth scene coordinates, mm.  Depth
        noise moves the depth along the ray and the coordinates with it.
        """
        cam = self.camera
        inv = invert(pose)
        origin = inv.t  # (B, 3) camera centre in the scene frame
        dev = pose.t.device
        u = torch.arange(self.width, dtype=torch.float32, device=dev) + 0.5
        v = torch.arange(self.height, dtype=torch.float32, device=dev) + 0.5
        vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H, W)
        bx = (uu - cam.cx) / cam.focal
        by = -(vv - cam.cy) / cam.focal
        d_eye = torch.stack([bx, by, -torch.ones_like(bx)], dim=-1)
        d_scene = torch.einsum("bij,hwj->bhwi", inv.R, d_eye)

        bounds = torch.tensor(ROOM_MM, dtype=torch.float32, device=dev)
        o = origin[:, None, None, :]
        d_safe = torch.where(torch.abs(d_scene) < 1e-9, 1e-9, d_scene)
        t_hi = (bounds - o) / d_safe
        t_lo = (0.0 - o) / d_safe
        t = torch.where(d_scene > 0, t_hi, t_lo).amin(dim=-1)  # (B, H, W)
        points = o + t[..., None] * d_scene
        tex_points = points
        k = self.knobs
        if effects is not None and effects.occluders is not None:
            t, tex_points = self._apply_occluders(effects.occluders, origin,
                                                  d_scene, d_safe, t)
            points = o + t[..., None] * d_scene
        rgb = self.texture(tex_points)
        if effects is not None and effects.rgb_noise is not None:
            rgb = torch.clamp(rgb + k.noise_std * effects.rgb_noise,
                              0.0, 255.0)
        depth = t
        if effects is not None and effects.depth_noise is not None:
            depth = t + k.label_noise_mm * effects.depth_noise
            points = o + depth[..., None] * d_scene
        return rgb, depth, points

    @staticmethod
    def _apply_occluders(occ: Occluders, origin, d_scene, d_safe, t_wall):
        """Pixels whose ray hits a box nearer than the wall take the box's
        depth, and their texture is the room's at the decoy anchor plus
        the offset from the box's centre (synthetic.py:235-274).  Boxes
        within 800 mm of the camera are off.  Returns (t, texture points).
        """
        inv_d = 1.0 / d_safe
        o = origin[:, None, None, :]
        t_near = torch.full_like(t_wall, math.inf)
        c_near = torch.zeros_like(d_scene)  # the nearest box's centre
        a_near = torch.zeros_like(d_scene)  # and its anchor
        for j in range(occ.centers.shape[1]):
            c = occ.centers[:, j][:, None, None, :]
            a = occ.anchors[:, j][:, None, None, :]
            h = occ.halfs[:, j][:, None, None, :]
            t1 = (c - h - o) * inv_d
            t2 = (c + h - o) * inv_d
            tmin = torch.minimum(t1, t2).amax(dim=-1)  # (B, H, W)
            tmax = torch.maximum(t1, t2).amin(dim=-1)
            near = torch.linalg.norm(occ.centers[:, j] - origin, dim=-1) \
                < 800.0  # (B,)
            hit = (tmax > tmin) & (tmin > 1.0) & ~near[:, None, None]
            # the first box at the least distance wins, as argmin picks
            closer = (hit & (tmin < t_near))[..., None]
            t_near = torch.where(closer[..., 0], tmin, t_near)
            c_near = torch.where(closer, c, c_near)
            a_near = torch.where(closer, a, a_near)
        occluded = t_near < t_wall
        t = torch.where(occluded, t_near, t_wall)
        points = o + t[..., None] * d_scene
        decoy = points - c_near + a_near
        return t, torch.where(occluded[..., None], decoy, points)


def make_scene(name: str = "room", width: int = 640, height: int = 480,
               focal: float = 525.0, device: torch.device | str = "cuda",
               **overrides) -> SyntheticScene:
    """A named archetype (``ARCHETYPES``) -> SyntheticScene
    (synthetic.py:329-335)."""
    if name not in ARCHETYPES:
        raise ValueError(f"unknown scene archetype {name!r}; "
                         f"choose from {sorted(ARCHETYPES)}")
    return SyntheticScene(width, height, focal, device, name=name,
                          **{**ARCHETYPES[name], **overrides})


def frame_key(seed: int, i: int) -> int:
    """The key of frame i: bench.py's 9000 + i for seed 0, else
    SyntheticSource's seed * 100003 + i (dsac_tpu/cli/common.py:76)."""
    return (BENCH_KEY if seed == 0 else seed * KEY_STRIDE) + i


def frame_set(scene: SyntheticScene, seed: int, n: int) -> FrameSet:
    """The first ``n`` frames of ``seed`` (keys ``frame_key``) of
    ``scene``.  Where scene_frames.json holds the set, its frames are the
    reference's: the poses under the scene's key schedule and, for 5 or 3
    occluders of the default sizes, the occluders.  Frames past the
    fixture's set take the poses ``random_pose`` draws for ``n`` views
    from a generator seeded with ``seed`` (so those of seed 1305, the
    default of train_ransac, stay the views it has always drawn) and
    occluders drawn from a generator seeded with 2 * key."""
    keys = [frame_key(seed, i) for i in range(n)]
    dev = scene.device
    k = scene.knobs
    entry = next((name for name, (first, _n) in FRAME_SETS.items()
                  if first == keys[0]), None) if n else None
    n_ref = min(n, FRAME_SETS[entry][1]) if entry else 0
    R, t, occ = [], [], []
    if n_ref:
        fs = _load_fixture(SCENE_FIXTURE)["frame_sets"][entry]
        poses = fs["keyed" if k.needs_frame_key else "room"]
        R.append(_f32(poses["R"][:n_ref], dev))
        t.append(_f32(poses["t"][:n_ref], dev))
        drawn = (fs["occluders"].get(str(k.n_occluders))
                 if tuple(k.occluder_half_mm)
                 == SceneKnobs().occluder_half_mm else None)
        if drawn is not None:
            occ.append(Occluders(*(_f32(drawn[f][:n_ref], dev)
                                   for f in Occluders._fields)))
        elif k.n_occluders:
            occ += [scene.draw_occluders(torch.Generator(dev).manual_seed(
                2 * key)) for key in keys[:n_ref]]
    if n > n_ref:
        views = scene.random_pose(torch.Generator(dev).manual_seed(seed), n)
        R.append(views.R[n_ref:])
        t.append(views.t[n_ref:])
        if k.n_occluders:
            occ += [scene.draw_occluders(torch.Generator(dev).manual_seed(
                2 * key)) for key in keys[n_ref:]]
    occluders = (Occluders(*(torch.cat(x) for x in zip(*occ)))
                 if occ else None)
    origin = ("reference" if n_ref == n else "drawn" if n_ref == 0
              else "reference+drawn")
    return FrameSet(Pose(torch.cat(R), torch.cat(t)), occluders, keys,
                    origin)


def render_frames(scene: SyntheticScene, frames: FrameSet, idx):
    """Render frames ``idx`` (a list of indices) of a frame set with
    their effects: the set's occluders, and noise drawn from a generator
    seeded with 2 * key + 1 a frame.  Returns (rgb, depth, coords, pose),
    the poses (B,) the ground truth."""
    pose = Pose(frames.poses.R[idx], frames.poses.t[idx])
    occ = frames.occluders
    if occ is not None:
        occ = Occluders(*(x[idx] for x in occ))
    rgb_noise, depth_noise = [], []
    for i in idx:
        rgb, depth = scene.draw_noise(torch.Generator(
            scene.device).manual_seed(2 * frames.keys[i] + 1))
        rgb_noise.append(rgb)
        depth_noise.append(depth)
    effects = Effects(
        occ, None if rgb_noise[0] is None else torch.cat(rgb_noise),
        None if depth_noise[0] is None else torch.cat(depth_noise))
    return (*scene.render(pose, effects), pose)
