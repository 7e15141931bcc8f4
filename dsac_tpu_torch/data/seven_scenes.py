"""Pose files in the 7-Scenes convention (port of the pose conversions of
dsac_tpu/data/seven_scenes.py:58-130; plain numpy).

A 7-Scenes pose file holds the 4x4 camera-to-world matrix of a frame in
the dataset's axes, with the scene-centering offset of translation.txt
(metres) subtracted on reading (core/read_data.cpp:69-133).  The port's
poses are scene -> eye in the internal axes (x right, y up, z = -depth),
translation in mm.  The dataset reader itself (``SevenScenesDataset``) is
not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from dsac_tpu_torch.geometry.rotation import so3_log

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
