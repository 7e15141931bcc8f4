"""Shared inputs of the port's kernel tests (numpy-seeded, no JAX), used
by tests/test_torch_kernels.py and tests/test_torch_cuda.py."""

import numpy as np
import torch

from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.rotation import so3_exp


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


def frames(rng, B=2, N=1600, noise=4.0, outliers=0.3):
    """B frames of N scene coordinates (mm) seen from known poses, with
    noise and uniform outliers; pixels where the true points project."""
    w = rng.normal(size=(B, 3)) * 0.4
    gt = Pose(so3_exp(T(w)), T(rng.normal(size=(B, 3)) * 200
                               + [0.0, 0.0, -2500.0]))
    eye = np.stack([rng.uniform(-1200, 1200, (B, N)),
                    rng.uniform(-900, 900, (B, N)),
                    -rng.uniform(1500, 3500, (B, N))], -1)
    pix = np.stack([-525.0 * eye[..., 0] / eye[..., 2] + 320.0,
                    525.0 * eye[..., 1] / eye[..., 2] + 240.0], -1)
    Rt = gt.R.transpose(-1, -2).numpy()
    scene = np.einsum("bij,bnj->bni", Rt, eye - gt.t.numpy()[:, None])
    scene = scene + rng.normal(size=scene.shape) * noise
    out = rng.random((B, N)) < outliers
    scene[out] = rng.uniform(-3000, 3000, size=(out.sum(), 3))
    return gt, T(scene), T(pix)
