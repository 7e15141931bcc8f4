"""Export the procedural room as a 7-Scenes-layout dataset on disk (port
of dsac_tpu/cli/export_synthetic.py).

Writes the folder convention of the reference's link_7scenes.py
(core/dataset.h:290-296): rgb_noseg/, depth_noseg/ and poses/ under
training/<name>/ and test/<name>/, and the scene's translation.txt,
sensorTrans.dat (the identity) and default.config, so that every entry
point can be driven through ``--data DIR/{training|test}/<name> -c
DIR/default.config``: PNG decoding, pose files with the scene-centering
offset and the axis correction, and depth to ground-truth coordinates.

The frames are SyntheticSource's of ``--train-seed`` and
``--test-seed`` (keys seed * 100003 + i), rendered on the device: the
reference's own poses for the first 48 of seed 3 and 24 of seed 99
(data/scene_frames.json), drawn ones past them.  RGB is truncated to
8 bits and depth to whole mm, as the reference writes them; the PNGs are
written with the port's codec (utils/native_io.py), so they decode to the
same arrays as the reference's.  Depth is exported registered to the RGB
camera, so default.config sets ``rd 0`` and the room's intrinsics
(f = 525, 640 x 480).

    python -m dsac_tpu_torch.cli.export_synthetic --out DIR \\
        [--train-frames 48] [--test-frames 16] [--name synth]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from dsac_tpu_torch import resolve_device
from dsac_tpu_torch.cli.common import SyntheticSource
from dsac_tpu_torch.config import DataConfig
from dsac_tpu_torch.data.seven_scenes import (write_pose_file,
                                              write_sensor_trans)
from dsac_tpu_torch.data.synthetic import make_scene
from dsac_tpu_torch.utils.logging import blue, green
from dsac_tpu_torch.utils.native_io import write_png

TRANSLATION_M = np.asarray([1.5, 0.7, 2.1])


def export_split(source: SyntheticSource, root: Path,
                 translation_m: np.ndarray) -> None:
    """Write each frame of ``source`` as an RGB PNG, a 16-bit depth PNG
    and a pose file frame-NNNNNN.{png,png,txt}."""
    for sub in ("rgb_noseg", "depth_noseg", "poses"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(len(source)):
        f = source.get(i)
        rgb = np.clip(f.rgb.cpu().numpy(), 0, 255).astype(np.uint8)
        depth = np.clip(f.depth.cpu().numpy(), 0, 65535).astype(np.uint16)
        write_png(root / "rgb_noseg" / f"frame-{i:06d}.png", rgb)
        write_png(root / "depth_noseg" / f"frame-{i:06d}.png", depth)
        write_pose_file(root / "poses" / f"frame-{i:06d}.txt",
                        f.pose.R.cpu().numpy(), f.pose.t.cpu().numpy(),
                        translation_m)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="scene directory to make")
    p.add_argument("--name", default="synth",
                   help="dataset name under training/ and test/")
    p.add_argument("--train-frames", type=int, default=48)
    p.add_argument("--test-frames", type=int, default=16)
    p.add_argument("--train-seed", type=int, default=3,
                   help="viewpoint set of the training split (keys "
                        "seed * 100003 + i)")
    p.add_argument("--test-seed", type=int, default=99,
                   help="the disjoint viewpoint set of the test split")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    scene = make_scene("room", device=device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "translation.txt").write_text(
        " ".join(f"{v}" for v in TRANSLATION_M) + "\n")
    write_sensor_trans(out / "sensorTrans.dat", np.eye(4))
    d = DataConfig()
    (out / "default.config").write_text(
        "# synthetic scene exported by dsac_tpu_torch.cli.export_synthetic\n"
        f"fl {d.focal_length:g}\n"
        f"iw {d.image_width}\nih {d.image_height}\n"
        "rd 0\n")  # depth is exported registered to the RGB camera

    print(blue(f"Exporting {args.train_frames} training / "
               f"{args.test_frames} test frames to {out}"))
    splits = {}
    for split, n, seed in (("training", args.train_frames, args.train_seed),
                           ("test", args.test_frames, args.test_seed)):
        source = SyntheticSource(n, seed, scene)
        export_split(source, out / split / args.name, TRANSLATION_M)
        splits[split] = {"frames": n, "seed": seed,
                         "frame_set": source.frame_set}
    print(green(f"Done. Train with e.g.\n"
                f"  python -m dsac_tpu_torch.cli.train_ransac "
                f"--data {out}/training/{args.name} -c {out}/default.config"
                f" --out runs/{args.name}"))
    result = {"metric": "export_synthetic", "out": str(out),
              "name": args.name, **splits}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
