"""The port's synthetic room against dsac_tpu/data/synthetic.py.

The texture parameters and bench poses come from jax.random, so the port
reads them from a fixture (dsac_tpu_torch/data/room_default.json); this
file regenerates them from the reference and holds the fixture to them
(1e-6: the fixture stores the reference's f32 values in full).  Running it
as a script rewrites the fixture:

    python tests/test_torch_synthetic.py
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from dsac_tpu.data.synthetic import SyntheticScene as JaxScene
from dsac_tpu_torch.data.synthetic import FIXTURE, SyntheticScene
from dsac_tpu_torch.geometry.pose import Pose

N_BENCH = 64  # bench.py serves keys 9000 .. 9063 (queue 8 x batch 8)


def reference_fixture() -> dict:
    scene = JaxScene()
    freqs, dirs, phases = scene._texture_params()
    pose = jax.vmap(scene.random_pose)(
        jax.vmap(jax.random.PRNGKey)(np.arange(9000, 9000 + N_BENCH)))

    def lst(x):
        return np.asarray(x, np.float32).astype(float).tolist()

    return {
        "source": "dsac_tpu.data.synthetic.SyntheticScene() (seed 1305): "
                  "_texture_params() and random_pose(PRNGKey(9000 + i)), "
                  "i < 64; written by tests/test_torch_synthetic.py",
        "texture": {"freqs": lst(freqs[:, 0]), "dirs": lst(dirs),
                    "phases": lst(phases)},
        "bench_poses": {"R": lst(pose.R), "t": lst(pose.t)},
    }


def test_fixture_matches_reference():
    ref = reference_fixture()
    with open(FIXTURE) as fh:
        got = json.load(fh)
    for group in ("texture", "bench_poses"):
        for k, v in ref[group].items():
            np.testing.assert_allclose(np.asarray(got[group][k]),
                                       np.asarray(v), rtol=0, atol=1e-6,
                                       err_msg=f"{group}.{k}")


def test_bench_poses_are_the_reference_frames():
    """The fixture's pose i is the pose of the reference's frame
    PRNGKey(9000 + i), i.e. the ground truth the bench scores against."""
    scene = SyntheticScene(device="cpu")
    for i in (0, 37):
        pose, *_ = JaxScene().frame(jax.random.PRNGKey(9000 + i))
        np.testing.assert_allclose(scene.bench_poses.R[i].numpy(),
                                   np.asarray(pose.R), atol=1e-6)
        np.testing.assert_allclose(scene.bench_poses.t[i].numpy(),
                                   np.asarray(pose.t), atol=1e-3)


def test_render_matches_reference():
    """64x48 render of two bench poses.  Tolerance: depth and coords to
    1e-2 mm of ~4000 (f32 ray-box arithmetic in a different order); RGB to
    0.05 of 255 (sin of arguments up to ~170 rad in f32)."""
    jscene = JaxScene(width=64, height=48, focal=52.5)
    scene = SyntheticScene(width=64, height=48, focal=52.5, device="cpu")
    R, t = scene.bench_poses.R[:2], scene.bench_poses.t[:2]
    rgb, depth, coords = scene.render(Pose(R, t))
    assert rgb.shape == (2, 48, 64, 3) and depth.shape == (2, 48, 64)
    for b in range(2):
        from dsac_tpu.geometry.pose import Pose as JPose
        jr, jd, jc = jscene.render(JPose(jax.numpy.asarray(R[b].numpy()),
                                         jax.numpy.asarray(t[b].numpy())))
        np.testing.assert_allclose(depth[b].numpy(), np.asarray(jd),
                                   rtol=1e-5, atol=1e-2)
        np.testing.assert_allclose(coords[b].numpy(), np.asarray(jc),
                                   rtol=1e-5, atol=1e-2)
        np.testing.assert_allclose(rgb[b].numpy(), np.asarray(jr),
                                   atol=0.05)


def test_render_is_device_agnostic_and_finite():
    scene = SyntheticScene(width=32, height=24, focal=26.25, device="cpu")
    rgb, depth, coords = scene.render(Pose(scene.bench_poses.R[:3],
                                           scene.bench_poses.t[:3]))
    for x in (rgb, depth, coords):
        assert torch.isfinite(x).all()
    assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 255.0
    assert float(depth.min()) > 0.0


if __name__ == "__main__":
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURE
    out.write_text(json.dumps(reference_fixture()) + "\n")
    print(f"wrote {out} ({out.stat().st_size} bytes)")
