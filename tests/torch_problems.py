"""Shared inputs of the port's tests (numpy-seeded, no JAX), used by
tests/test_torch_kernels.py, tests/test_torch_cuda.py and the score-net
and score-CNN pipeline tests."""

import numpy as np
import pytest
import torch

from dsac_tpu_torch.geometry.pose import Pose
from dsac_tpu_torch.geometry.rotation import so3_exp
from dsac_tpu_torch.models.score_net import ScoreNet


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


def random_score_flat(rng, width_mult):
    """Flax-layout parameters of a ScoreNet at width_mult (He-scaled), as
    the npz artifacts hold them: HWIO conv kernels, (in, out) dense."""
    flat, cin = {}, 1
    for i, (cout, _s, _p) in enumerate(ScoreNet(width_mult).spec):
        flat[f"params|Conv_{i}|kernel"] = rng.normal(
            size=(3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin))
        flat[f"params|Conv_{i}|bias"] = rng.normal(size=cout) * 0.1
        cin = cout
    fc = max(16, int(1024 * width_mult))
    for i, (a, b) in enumerate([(cin, fc), (fc, fc), (fc, 1)]):
        flat[f"params|Dense_{i}|kernel"] = rng.normal(size=(a, b)) * \
            np.sqrt(2.0 / a)
        flat[f"params|Dense_{i}|bias"] = rng.normal(size=b) * 0.1
    return {k: v.astype(np.float32) for k, v in flat.items()}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests (autouse where imported):
    the suite runs test files in parallel worker processes, and torch's
    OpenMP threads in all of them oversubscribe the cores, which slowed
    the port's small training tests a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
