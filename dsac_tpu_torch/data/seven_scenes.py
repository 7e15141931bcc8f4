"""7-Scenes-layout datasets (port of dsac_tpu/data/seven_scenes.py; plain
numpy: frames go to the device at the entry points).

Folder convention (core/dataset.h:290-296, made by cli/link_7scenes.py or
cli/export_synthetic.py):

    <scene>/{training|test}/<name>/
        rgb_noseg/    *.png   8-bit RGB, 640x480
        depth_noseg/  *.png   16-bit grayscale, depth in mm
        poses/        *.txt   4x4 camera-to-world matrix (7-Scenes axes)
    and per scene: translation.txt (the scene-centering offset, metres)
                   sensorTrans.dat (depth -> RGB extrinsics: int rows,
                   int cols, row-major doubles)

A pose file holds the camera-to-world matrix of a frame in the dataset's
axes, with the offset of translation.txt subtracted on reading
(core/read_data.cpp:69-133).  The port's poses are scene -> eye in the
internal axes (x right, y up, z = -depth), translation in mm.  Depth is
registered to the RGB camera (``map_depth_to_rgb``, core/dataset.h:93-111)
where the config's ``raw_data`` says so, and the ground-truth scene
coordinates come from depth and pose (``get_obj``,
core/dataset.h:226-255).  PNGs decode through utils/native_io.py.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np
import torch

from dsac_tpu_torch.config import DataConfig
from dsac_tpu_torch.geometry.rotation import so3_log
from dsac_tpu_torch.utils import native_io

# the axis correction between the dataset's camera axes and the internal
# ones: negate y and z
_CORRECTION = np.diag([1.0, -1.0, -1.0, 1.0])


def _eye_to_scene(R: np.ndarray, t_mm: np.ndarray) -> np.ndarray:
    """The 4x4 camera-to-world matrix (metres, dataset axes) of a scene ->
    eye pose."""
    M = np.eye(4)
    M[:3, :3] = np.asarray(R, np.float64)
    M[:3, 3] = np.asarray(t_mm, np.float64) / 1000.0
    return np.linalg.inv(M) @ np.linalg.inv(_CORRECTION)


def write_pose_file(path: str | Path, R: np.ndarray, t_mm: np.ndarray,
                    translation_m: np.ndarray | None = None) -> None:
    """Write a scene -> eye pose (R (3, 3), t (3,) mm) as a 7-Scenes pose
    file, the scene-centering offset re-added (core/test_ransac.cpp:
    170-219); ``parse_pose_file`` reads it back."""
    file_mat = _eye_to_scene(R, t_mm)
    if translation_m is not None:
        file_mat[:3, 3] += translation_m
    lines = [" ".join(f"{v:.9f}" for v in row) for row in file_mat]
    Path(path).write_text("\n".join(lines) + "\n")


def pose_to_7scenes_vec6(R: np.ndarray, t_mm: np.ndarray,
                         translation_m: np.ndarray | None = None
                         ) -> np.ndarray:
    """A scene -> eye pose as the reference's exported 6-vector: the
    Rodrigues vector of the camera-to-world rotation and its translation
    in metres with the scene-centering offset re-added (columns 5-10 of
    test_ransac's error file).  The rotation's log is ``so3_log`` in f32,
    as the reference takes it."""
    M = _eye_to_scene(R, t_mm)
    rod = so3_log(torch.from_numpy(M[:3, :3].astype(np.float32)))
    t = M[:3, 3]
    if translation_m is not None:
        t = t + np.asarray(translation_m, np.float64)
    return np.concatenate([rod.numpy().astype(np.float64), t])


def parse_pose_file(path: str | Path,
                    translation: np.ndarray | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """A 7-Scenes pose file -> (R, t in metres), scene -> eye: the top three
    rows of the camera-to-world matrix, the offset subtracted, the axes
    corrected, inverted (read_data.cpp:69-133)."""
    rows = []
    with open(path) as f:
        for _ in range(3):
            rows.append([float(t) for t in f.readline().split()[:4]])
    trans = np.eye(4)
    trans[:3, :4] = np.asarray(rows)
    if translation is not None:
        trans[:3, 3] -= translation
    trans = np.linalg.inv(trans @ _CORRECTION)
    return trans[:3, :3].copy(), trans[:3, 3].copy()


def read_sensor_trans(path: str | Path) -> np.ndarray:
    """A sensorTrans.dat matrix: int rows, int cols, row-major doubles
    (core/generic_io.h:166-180)."""
    raw = Path(path).read_bytes()
    rows, cols = struct.unpack_from("<ii", raw, 0)
    vals = struct.unpack_from(f"<{rows * cols}d", raw, 8)
    return np.asarray(vals, np.float64).reshape(rows, cols)


def write_sensor_trans(path: str | Path, mat: np.ndarray) -> None:
    """Write a matrix as ``read_sensor_trans`` reads it
    (core/generic_io.h:150-163)."""
    m = np.asarray(mat, np.float64)
    Path(path).write_bytes(struct.pack("<ii", *m.shape) + m.tobytes())


def read_translation(path: str | Path) -> np.ndarray:
    """translation.txt: one line of 3 floats (metres)."""
    toks = Path(path).read_text().split()
    return np.asarray([float(t) for t in toks[:3]], np.float64)


@dataclasses.dataclass
class SevenScenesDataset:
    """One split of one scene: ``rgb, depth, (R, t_mm) = ds[i]``
    (dsac_tpu/data/seven_scenes.py:132-256).

    The scene's translation.txt and sensorTrans.dat are looked for in the
    split's directory and up to two directories above it; the first found
    wins.  ``register_depth`` None takes the config's ``raw_data``."""

    root: str | Path
    config: DataConfig = dataclasses.field(default_factory=DataConfig)
    register_depth: bool | None = None

    def __post_init__(self):
        root = Path(self.root)
        self.rgb_files = sorted((root / "rgb_noseg").glob("*.png"))
        self.depth_files = sorted((root / "depth_noseg").glob("*.png"))
        self.pose_files = sorted((root / "poses").glob("*.txt"))
        if not self.rgb_files:
            raise FileNotFoundError(f"no rgb_noseg/*.png under {root}")
        self.translation = None
        self.sensor_trans = np.eye(4)
        for base in (root, root.parent, root.parent.parent):
            t = base / "translation.txt"
            if self.translation is None and t.exists():
                self.translation = read_translation(t)
            s = base / "sensorTrans.dat"
            if s.exists() and np.allclose(self.sensor_trans, np.eye(4)):
                self.sensor_trans = read_sensor_trans(s)
        if self.register_depth is None:
            self.register_depth = self.config.raw_data

    def __len__(self) -> int:
        return len(self.rgb_files)

    def get_rgb(self, i: int) -> np.ndarray:
        """(H, W, 3) uint8 (Dataset::getBGR, as RGB)."""
        c = self.config
        return native_io.read_rgb(str(self.rgb_files[i]), c.image_width,
                                  c.image_height)

    def get_depth(self, i: int) -> np.ndarray:
        """(H, W) uint16 depth in mm, registered to the RGB camera where
        ``register_depth`` says so (Dataset::getDepth)."""
        c = self.config
        depth = native_io.read_depth16(str(self.depth_files[i]),
                                       c.image_width, c.image_height)
        return self.map_depth_to_rgb(depth) if self.register_depth else depth

    def get_pose(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(R, t_mm), scene -> eye in the internal axes."""
        R, t_m = parse_pose_file(self.pose_files[i], self.translation)
        return R, t_m * 1000.0

    def map_depth_to_rgb(self, depth: np.ndarray) -> np.ndarray:
        """Each depth pixel through the depth sensor's intrinsics, the
        extrinsics of sensorTrans.dat and the RGB intrinsics
        (core/dataset.h:93-111), scattered; the reference divides by the
        original depth in the reprojection (:107-108), and so does this."""
        c = self.config
        h, w = depth.shape
        ys, xs = np.nonzero(depth)
        d = depth[ys, xs].astype(np.float64)
        ex = (xs - (c.image_width / 2.0 + c.raw_x_shift)) * d \
            / c.secondary_focal_length
        ey = -(ys - (c.image_height / 2.0 + c.raw_y_shift)) * d \
            / c.secondary_focal_length
        pts = self.sensor_trans @ np.stack([ex, ey, -d, np.ones_like(ex)])
        nx = (pts[0] * (c.focal_length / d)
              + (c.image_width / 2.0 + c.x_shift) + 0.5).astype(np.int64)
        ny = (-(pts[1] * (c.focal_length / d))
              + (c.image_height / 2.0 + c.y_shift) + 0.5).astype(np.int64)
        ok = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
        out = np.zeros_like(depth)
        out[ny[ok], nx[ok]] = depth[ys[ok], xs[ok]]
        return out

    def px_to_eye(self, depth: np.ndarray) -> np.ndarray:
        """Depth (H, W) -> camera coordinates (H, W, 3) mm through the
        inverse pinhole, zero where depth is (core/dataset.cpp:37-56)."""
        c = self.config
        h, w = depth.shape
        xs = np.arange(w)[None, :]
        ys = np.arange(h)[:, None]
        d = depth.astype(np.float64)
        ex = (xs - (c.image_width / 2.0 + c.x_shift)) * d / c.focal_length
        ey = -(ys - (c.image_height / 2.0 + c.y_shift)) * d / c.focal_length
        eye = np.stack([ex, ey, -d], axis=-1)
        eye[depth == 0] = 0
        return eye.astype(np.float32)

    def get_eye(self, i: int) -> np.ndarray:
        """The camera-coordinate image (Dataset::getEye)."""
        return self.px_to_eye(self.get_depth(i))

    def get_obj(self, i: int) -> np.ndarray:
        """The ground-truth scene-coordinate image in mm: the camera
        coordinates through the inverse of the frame's pose, zero where
        depth is missing (Dataset::getObj, core/dataset.h:226-255)."""
        depth = self.get_depth(i)
        eye = self.px_to_eye(depth)
        R, t = self.get_pose(i)
        scene = (eye.reshape(-1, 3).astype(np.float64) - t) @ R
        scene = scene.reshape(eye.shape).astype(np.float32)
        scene[depth == 0] = 0
        return scene

    def __getitem__(self, i: int):
        R, t = self.get_pose(i)
        return self.get_rgb(i), self.get_depth(i), (R, t)

    def prefetch(self, sequence: list[int], n_threads: int = 3,
                 capacity: int = 8) -> native_io.PrefetchLoader:
        """Threaded in-order prefetch over ``sequence``: yields (index,
        rgb, depth); depth is as decoded, not registered."""
        c = self.config
        return native_io.PrefetchLoader(
            [str(p) for p in self.rgb_files],
            [str(p) for p in self.depth_files] if self.depth_files else None,
            sequence, c.image_width, c.image_height, n_threads, capacity)
