"""Static configuration (port of dsac_tpu/config.py:21-132).

Units follow the reference: millimetres for 3D, pixels for 2D, degrees for
the rotational part of the pose error.  The camera is three plain floats:
kernels take them as scalars.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple


class Camera(NamedTuple):
    """Pinhole intrinsics: focal length and principal point, in pixels."""

    focal: float
    cx: float
    cy: float

    @staticmethod
    def make(focal: float = 525.0, width: int = 640, height: int = 480,
             x_shift: float = 0.0, y_shift: float = 0.0) -> "Camera":
        return Camera(float(focal), width / 2.0 + x_shift,
                      height / 2.0 + y_shift)


@dataclasses.dataclass(frozen=True)
class PoseConfig:
    """Hypothesis sampling, scoring and refinement parameters."""

    num_hypotheses: int = 256
    refinement_steps: int = 8
    inlier_count_cap: int = 100
    gradient_subsample: float = 0.01
    inlier_threshold_2d: float = 10.0
    inlier_threshold_3d: float = 100.0
    random_draw: bool = True
    inlier_beta: float = 1.0
    sample_attempts: int = 16
    gn_inner_steps: int = 2
    gn_damping: float = 1e-4
    min_inliers: float = 50.0
    max_reprojection_error: float = 100.0
    min_set_size: int = 4
    score_beta: float = 10.0
    hyp_sample_chunk: int = 2048
    two_phase_budget: float = 0.125


@dataclasses.dataclass(frozen=True)
class DataConfig:
    focal_length: float = 525.0
    x_shift: float = 0.0
    y_shift: float = 0.0
    secondary_focal_length: float = 585.0
    raw_x_shift: float = 0.0
    raw_y_shift: float = 0.0
    image_width: int = 640
    image_height: int = 480
    raw_data: bool = True

    def camera(self) -> Camera:
        return Camera.make(self.focal_length, self.image_width,
                           self.image_height, self.x_shift, self.y_shift)


@dataclasses.dataclass(frozen=True)
class NetConfig:
    rgb_patch_size: int = 42
    subsample_size: int = 40
    score_mean: float = 45.0
    rgb_mean: float = 127.0


@dataclasses.dataclass(frozen=True)
class DSACConfig:
    pose: PoseConfig = dataclasses.field(default_factory=PoseConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    net: NetConfig = dataclasses.field(default_factory=NetConfig)


DEFAULT = DSACConfig()
