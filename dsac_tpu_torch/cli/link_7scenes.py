"""Dataset preparation: a raw 7-Scenes download -> the folder layout of
``--data`` (port of dsac_tpu/cli/link_7scenes.py).

Symlinks seq-XX/frame-XXXXXX.{color.png,depth.png,pose.txt} into
{training|test}/<scene>/{rgb_noseg,depth_noseg,poses}/ after the scene's
TrainSplit.txt and TestSplit.txt (the reference's
link_7scenes.py:49-125), as seqXX_frame-XXXXXX.{png,png,txt}.  Linking
again adds only what is missing.

    python -m dsac_tpu_torch.cli.link_7scenes RAW OUT [--scenes chess ...]
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

SCENES = ["chess", "fire", "heads", "office", "pumpkin", "redkitchen",
          "stairs"]


def read_split(path: Path) -> list[int]:
    """The sequence numbers of a split file ("sequence1" per line)."""
    return [int(tok.lower().replace("sequence", ""))
            for tok in path.read_text().split() if tok.strip()]


def link_scene(raw_scene: Path, out_scene: Path) -> None:
    """Link one scene's training and test sequences under ``out_scene``."""
    for split_file, split_name in (("TrainSplit.txt", "training"),
                                   ("TestSplit.txt", "test")):
        out = out_scene / split_name / raw_scene.name
        for sub in ("rgb_noseg", "depth_noseg", "poses"):
            (out / sub).mkdir(parents=True, exist_ok=True)
        for seq in read_split(raw_scene / split_file):
            seq_dir = raw_scene / f"seq-{seq:02d}"
            for frame in sorted(seq_dir.glob("*.color.png")):
                stem = frame.name.replace(".color.png", "")
                prefix = f"seq{seq:02d}_{stem}"
                for src_suffix, sub, dst_suffix in (
                        (".color.png", "rgb_noseg", ".png"),
                        (".depth.png", "depth_noseg", ".png"),
                        (".pose.txt", "poses", ".txt")):
                    src = seq_dir / f"{stem}{src_suffix}"
                    dst = out / sub / f"{prefix}{dst_suffix}"
                    if src.exists() and not dst.exists():
                        os.symlink(src.resolve(), dst)
        print(f"linked {raw_scene.name}/{split_name}: "
              f"{len(list((out / 'rgb_noseg').iterdir()))} frames")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("raw", help="directory of the extracted 7-Scenes scene "
                               "folders")
    p.add_argument("out", help="output dataset root")
    p.add_argument("--scenes", nargs="*", default=SCENES)
    args = p.parse_args(argv)
    for scene in args.scenes:
        raw_scene = Path(args.raw) / scene
        if not raw_scene.exists():
            print(f"skipping {scene}: {raw_scene} not found")
            continue
        link_scene(raw_scene, Path(args.out))


if __name__ == "__main__":
    main()
