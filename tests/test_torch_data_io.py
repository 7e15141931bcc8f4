"""The port's data layer against the reference's: the PNG codec and the
native decoder (utils/native_io.py), SevenScenesDataset and its metadata
readers (data/seven_scenes.py), the short flags and config files
(flags.py), link_7scenes and export_synthetic.

The files are written here, as tests/test_data_io.py writes its own: small
frames (64 x 48, focal 52.5) of the reference's room, with PIL writing the
PNGs.  Decoded arrays, depth registration, camera and scene coordinates,
poses and parsed configs are held to the reference's on the same files,
bit for bit where both sides compute in float64 (1e-6 where a pose is
parsed from text).  The export is held to the reference's export of the
same frames: the same files, the poses to 1e-6, the images to one level
where f32 rendering puts a value on the other side of an integer.
"""

import io
import os
import struct
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

from dsac_tpu import flags as jax_flags
from dsac_tpu.config import DataConfig as JData
from dsac_tpu.data import seven_scenes as jax_seven
from dsac_tpu.data.synthetic import SyntheticScene as JaxScene
from dsac_tpu.utils import native_io as jax_io
from dsac_tpu_torch import flags
from dsac_tpu_torch.config import DataConfig
from dsac_tpu_torch.data import seven_scenes
from dsac_tpu_torch.utils import native_io
from torch_problems import one_torch_thread  # noqa: F401

W, H, F = 64, 48, 52.5
SMALL = dict(focal_length=F, image_width=W, image_height=H)
TRANSLATION = np.asarray([1.5, 0.7, 2.1])


def write_pil(path: Path, image: np.ndarray) -> None:
    if image.dtype == np.uint16:
        Image.fromarray(image.astype(np.int32), mode="I").convert(
            "I;16").save(path)
    else:
        Image.fromarray(image).save(path)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """3 frames of the reference's room at 64 x 48 in the 7-Scenes layout
    (PIL's PNGs), the offset two directories up, a non-identity
    sensorTrans.dat beside it; and the frames' arrays."""
    scene = JaxScene(width=W, height=H, focal=F)
    base = tmp_path_factory.mktemp("scene")
    root = base / "training" / "mini"
    for sub in ("rgb_noseg", "depth_noseg", "poses"):
        (root / sub).mkdir(parents=True)
    (base / "translation.txt").write_text(
        " ".join(map(str, TRANSLATION)) + "\n")
    c, s = np.cos(0.02), np.sin(0.02)
    sensor = np.asarray([[c, 0, s, 25.0], [0, 1, 0, -10.0],
                         [-s, 0, c, 5.0], [0, 0, 0, 1]])
    jax_seven.write_sensor_trans(base / "sensorTrans.dat", sensor)
    frames = []
    for i in range(3):
        pose, rgb, depth, coords = scene.frame(jax.random.PRNGKey(i))
        rgb_u8 = np.asarray(rgb, np.float32).astype(np.uint8)
        depth_u16 = np.asarray(depth).astype(np.uint16)
        write_pil(root / "rgb_noseg" / f"frame-{i:06d}.png", rgb_u8)
        write_pil(root / "depth_noseg" / f"frame-{i:06d}.png", depth_u16)
        jax_seven.write_pose_file(root / "poses" / f"frame-{i:06d}.txt",
                                  np.asarray(pose.R), np.asarray(pose.t),
                                  TRANSLATION)
        frames.append((rgb_u8, depth_u16, np.asarray(coords)))
    return root, frames


# ---- the PNG codec and the decoder ----

def filter_rows(image: np.ndarray, kind: int, bpp: int) -> bytes:
    """PNG rows of one filter type, encoded here from the PNG
    specification (what an encoder writes)."""
    rows = image.reshape(image.shape[0], -1).astype(np.int32)
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for r in rows:
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + ((r - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = r
    return b"".join(out)


def png_of(image: np.ndarray, kind: int) -> bytes:
    """A PNG of ``image`` with every row in filter ``kind``."""
    if image.dtype == np.uint16:
        depth, colour, bpp = 16, 0, 2
        raw = image.astype(">u2").view(np.uint8)
    else:
        depth, colour, bpp = 8, 2, 3
        raw = image
    h, w = image.shape[:2]

    def chunk(k, body):
        return (struct.pack(">I", len(body)) + k + body
                + struct.pack(">I", zlib.crc32(k + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(filter_rows(raw, kind, bpp)))
            + chunk(b"IEND", b""))


FILTERS = ["none", "sub", "up", "average", "paeth"]


@pytest.mark.parametrize("kind", range(5), ids=FILTERS)
def test_png_codec_decodes_each_row_filter(kind):
    """Both ways of undoing the filters (a row at a time, and a diagonal
    at a time for frames with many average or Paeth rows) give the
    image."""
    rng = np.random.default_rng(kind)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    depth = rng.integers(0, 65536, (H, W), dtype=np.uint16)
    for image, bpp in ((rgb, 3), (depth, 2)):
        data = png_of(image, kind)
        np.testing.assert_array_equal(native_io.decode_png(data), image)
        np.testing.assert_array_equal(np.asarray(Image.open(
            io.BytesIO(data))), image)
        rows = native_io._filtered_rows(data)[0]
        for undo in (native_io._unfilter_rows, native_io._unfilter_wavefront):
            got = undo(rows[:, 0], rows[:, 1:], bpp)
            want = (image.reshape(H, -1) if bpp == 3
                    else image.astype(">u2").view(np.uint8))
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", [*range(5), "adaptive"],
                         ids=[*FILTERS, "adaptive"])
def test_png_encoder_writes_each_row_filter(kind, tmp_path):
    """The port's encoder, in each filter and in its adaptive choice
    (the default, as PIL writes), makes files that PIL and the native
    library decode to the image; its rows are the specification's."""
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:H, 0:W]
    smooth = np.stack([x * 3, y * 5, x + y], -1)
    rgb = np.clip(smooth + rng.normal(0, 6, (H, W, 3)), 0, 255).astype(
        np.uint8)
    depth = (1500 + 40 * x + 25 * y + rng.integers(0, 9, (H, W))).astype(
        np.uint16)
    for image, bpp in ((rgb, 3), (depth, 2)):
        path = tmp_path / "frame.png"
        data = native_io.encode_png(image, kind)
        path.write_bytes(data)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), image)
        np.testing.assert_array_equal(native_io.decode_png(data), image)
        reader = jax_io.read_rgb if bpp == 3 else jax_io.read_depth16
        np.testing.assert_array_equal(reader(str(path), W, H), image)
        rows = native_io._filtered_rows(data)[0]
        raw = image.reshape(H, -1) if bpp == 3 else image.astype(
            ">u2").view(np.uint8)
        for r in range(H):  # each row as the specification filters it
            np.testing.assert_array_equal(
                rows[r], np.frombuffer(filter_rows(
                    np.stack([raw[r - 1] if r else np.zeros_like(raw[0]),
                              raw[r]]), rows[r, 0], bpp), np.uint8).reshape(
                        2, -1)[1])
        if kind == "adaptive":  # a mix, as a smooth noisy frame asks
            assert len(set(native_io.row_filters(data).tolist())) > 1


def test_png_codec_matches_pil_and_native(mini, tmp_path):
    """PIL's files (its adaptive filters) decode to the same arrays with
    the port's codec, PIL and the native library; the port's files decode
    in PIL and the native library to the arrays written."""
    root, frames = mini
    rgb, depth, _ = frames[0]
    for path, want in ((root / "rgb_noseg" / "frame-000000.png", rgb),
                       (root / "depth_noseg" / "frame-000000.png", depth)):
        data = path.read_bytes()
        np.testing.assert_array_equal(native_io.decode_png(data), want)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    native_io.write_png(tmp_path / "rgb.png", rgb)
    native_io.write_png(tmp_path / "depth.png", depth)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "rgb.png")
                                             .convert("RGB")), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(
        tmp_path / "depth.png")), depth)
    for path, want in ((tmp_path / "rgb.png", rgb),
                       (tmp_path / "depth.png", depth)):
        reader = jax_io.read_rgb if want.ndim == 3 else jax_io.read_depth16
        np.testing.assert_array_equal(reader(str(path), W, H), want)
    assert native_io.png_size(str(tmp_path / "rgb.png")) == \
        jax_io.png_size(str(tmp_path / "rgb.png")) == (W, H, 3, 8)
    assert native_io.png_size(str(tmp_path / "depth.png")) == (W, H, 1, 16)
    with pytest.raises(IOError):
        native_io.read_rgb(str(tmp_path / "rgb.png"), W + 1, H)


@pytest.fixture(params=["native", "python"])
def decoder(request, monkeypatch):
    """Each decoder the port may run: the native library, or the port's
    codec where it does not load."""
    if request.param == "python":
        monkeypatch.setattr(native_io, "_lib_tried", True)
        monkeypatch.setattr(native_io, "_lib", None)
        monkeypatch.setattr(native_io, "_decoder", "python")
    elif native_io.get_lib() is None:
        pytest.skip("the native library does not load here")
    return request.param


def test_decoders_and_prefetch_match_reference(mini, decoder):
    """read_rgb, read_depth16 and the prefetch loader's order and
    contents (tests/test_data_io.py:55-85), with either decoder."""
    root, frames = mini
    assert native_io.decoder().split(":")[0] == decoder
    rgbs = sorted(str(p) for p in (root / "rgb_noseg").glob("*.png"))
    depths = sorted(str(p) for p in (root / "depth_noseg").glob("*.png"))
    for i in range(3):
        np.testing.assert_array_equal(native_io.read_rgb(rgbs[i], W, H),
                                      jax_io.read_rgb(rgbs[i], W, H))
        np.testing.assert_array_equal(
            native_io.read_depth16(depths[i], W, H),
            jax_io.read_depth16(depths[i], W, H))
    seq = [2, 0, 1, 2]
    loader = native_io.PrefetchLoader(rgbs, depths, seq, W, H, n_threads=2,
                                      capacity=2)
    got = []
    for idx, rgb, depth in loader:
        got.append(idx)
        np.testing.assert_array_equal(rgb, frames[idx][0])
        np.testing.assert_array_equal(depth, frames[idx][1])
    assert got == seq
    loader.close()


# ---- SevenScenesDataset ----

def datasets(root, register, **cfg):
    return (seven_scenes.SevenScenesDataset(
                root, config=DataConfig(**SMALL, **cfg),
                register_depth=register),
            jax_seven.SevenScenesDataset(
                root, config=JData(**SMALL, **cfg), register_depth=register))


def test_metadata_readers_match_reference(mini, tmp_path):
    root, _ = mini
    base = root.parent.parent
    np.testing.assert_array_equal(
        seven_scenes.read_translation(base / "translation.txt"),
        jax_seven.read_translation(base / "translation.txt"))
    np.testing.assert_array_equal(
        seven_scenes.read_sensor_trans(base / "sensorTrans.dat"),
        jax_seven.read_sensor_trans(base / "sensorTrans.dat"))
    m = np.linalg.inv(np.eye(4) + 0.01 * np.arange(16).reshape(4, 4))
    seven_scenes.write_sensor_trans(tmp_path / "a.dat", m)
    jax_seven.write_sensor_trans(tmp_path / "b.dat", m)
    assert (tmp_path / "a.dat").read_bytes() == \
        (tmp_path / "b.dat").read_bytes()


@pytest.mark.parametrize("register", [False, True],
                         ids=["as_written", "registered"])
def test_dataset_matches_reference(mini, register):
    """Metadata found two directories up, poses, depth with and without
    registration (a non-identity sensorTrans.dat and a depth focal length
    of its own), camera and scene coordinates, and the accessors' tuple."""
    root, frames = mini
    ours, theirs = datasets(root, register, secondary_focal_length=F * 1.1,
                            raw_x_shift=1.5)
    assert len(ours) == len(theirs) == 3
    np.testing.assert_array_equal(ours.translation, theirs.translation)
    np.testing.assert_array_equal(ours.sensor_trans, theirs.sensor_trans)
    for i in range(3):
        R, t = ours.get_pose(i)
        rR, rt = theirs.get_pose(i)
        np.testing.assert_array_equal(R, rR)
        np.testing.assert_array_equal(t, rt)
        for name in ("get_rgb", "get_depth", "get_eye", "get_obj"):
            np.testing.assert_array_equal(getattr(ours, name)(i),
                                          getattr(theirs, name)(i),
                                          err_msg=f"{name}({i})")
        rgb, depth, (R2, t2) = ours[i]
        np.testing.assert_array_equal(rgb, frames[i][0])
        np.testing.assert_array_equal(R2, R)
        assert np.array_equal(depth, frames[i][1]) != register
    depth = ours.get_depth(0)
    if register:
        assert not np.array_equal(depth, frames[0][1])
        np.testing.assert_array_equal(ours.map_depth_to_rgb(frames[0][1]),
                                      theirs.map_depth_to_rgb(frames[0][1]))
    np.testing.assert_array_equal(ours.px_to_eye(depth),
                                  theirs.px_to_eye(depth))
    seq = [1, 2, 0]
    got = [(i, r, d) for i, r, d in ours.prefetch(seq, n_threads=2)]
    want = [(i, r, d) for i, r, d in theirs.prefetch(seq, n_threads=2)]
    assert [g[0] for g in got] == [w[0] for w in want] == seq
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])


# ---- flags ----

CONFIG = ("# a 7-Scenes scene\nrI 256\nrRI 8\nrB 100\nrSS 0.01\nrT2D 10\n"
          "rT3D 100\nrdraw 1\nfl 585.5\nsfl 585\nxs 2\nys -1.5\niw 640\n"
          "ih 480\nrd 1\nomodel obj_model.net\nunknown_key 7\n")


@pytest.mark.parametrize("argv", [
    [], ["-rI", "64", "-rdraw", "0", "-fl", "500"],
    ["-c", "CFG", "-rd", "0", "-iw", "320", "-omodel", "x.net"],
    ["-c", "CFG.config", "-rT2D", "12.5", "-sscript", "s.lua"],
], ids=["defaults", "cli", "config_name", "config_file"])
def test_flags_match_reference(tmp_path, monkeypatch, argv):
    """The same config file and argv through both parsers: every field of
    the config and the string settings; a ./default.config is read when
    -c is absent, as the reference reads it."""
    (tmp_path / "CFG.config").write_text(CONFIG)
    (tmp_path / "default.config").write_text("rI 128\nfl 600\n")
    monkeypatch.chdir(tmp_path)
    ours, o_str = flags.load(argv)
    theirs, t_str = jax_flags.load(argv)
    for section in ("pose", "data"):
        a, b = getattr(ours, section), getattr(theirs, section)
        for field in a.__dataclass_fields__:
            if field in b.__dataclass_fields__:
                assert getattr(a, field) == getattr(b, field), field
    assert o_str == t_str
    from dsac_tpu.cli.common import apply_string_flags
    assert flags.apply_string_flags(o_str) == apply_string_flags(t_str)


def test_rdraw_in_both_spellings_and_config(tmp_path):
    """test_ransac's --rdraw and the reference's -rdraw are one setting;
    -c sets a dataset's intrinsics; a stray --option is refused."""
    from dsac_tpu_torch.cli.test_ransac import parse_args
    assert parse_args(["--rdraw", "0"]).rdraw == 0
    assert parse_args(["-rdraw", "0"]).rdraw == 0
    assert parse_args([]).rdraw == 1
    assert parse_args(["-rdraw", "0", "--rdraw", "1"]).rdraw == 1
    (tmp_path / "s.config").write_text("fl 500\niw 320\nih 240\nrd 0\n")
    args = parse_args(["-c", str(tmp_path / "s.config"), "-rI", "64"])
    assert args.cfg.data.camera() == (500.0, 160.0, 120.0)
    assert args.cfg.pose.num_hypotheses == 64 and not args.cfg.data.raw_data
    with pytest.raises(SystemExit):
        parse_args(["--no-such-option", "1"])


# ---- link_7scenes and export_synthetic ----

def test_link_7scenes_matches_reference(tmp_path):
    """The same raw tree linked by both: the same files, linked to the
    same targets; linking again adds nothing."""
    from dsac_tpu.cli import link_7scenes as jax_link
    from dsac_tpu_torch.cli import link_7scenes
    raw = tmp_path / "raw" / "mini7"
    for seq in (1, 2, 3):
        d = raw / f"seq-{seq:02d}"
        d.mkdir(parents=True)
        for i in range(2):
            for suffix in (".color.png", ".depth.png", ".pose.txt"):
                (d / f"frame-{i:06d}{suffix}").write_text(f"{seq}{i}")
    (raw / "TrainSplit.txt").write_text("sequence1\nsequence3\n")
    (raw / "TestSplit.txt").write_text("sequence2\n")
    trees = {}
    for name, mod in (("ours", link_7scenes), ("theirs", jax_link)):
        out = tmp_path / name
        mod.main([str(tmp_path / "raw"), str(out), "--scenes", "mini7",
                  "absent"])
        if name == "ours":
            link_7scenes.link_scene(raw, out)
        trees[name] = sorted(
            (str(p.relative_to(out)), os.readlink(p))
            for p in out.rglob("*") if p.is_symlink())
    assert trees["ours"] == trees["theirs"] and len(trees["ours"]) == 18
    assert link_7scenes.read_split(raw / "TrainSplit.txt") == [1, 3]


def test_export_round_trip_matches_reference(tmp_path):
    """export_synthetic's tree against the reference's export of the same
    frames, read back through SevenScenesDataset: the reference's poses,
    and the ground-truth coordinates from depth and pose against the
    reference's and against the render's (tests/test_data_io.py:228-240):
    integer-mm depth leaves a median error under 10 mm and 95% under
    40 mm."""
    from dsac_tpu_torch.cli.common import SyntheticSource
    from dsac_tpu_torch.data.synthetic import make_scene
    from dsac_tpu.cli import export_synthetic as jax_export
    from dsac_tpu_torch.cli import export_synthetic
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    res = export_synthetic.main(["--out", str(ours), "--train-frames", "1",
                                 "--test-frames", "2", "--device", "cpu"])
    assert res["training"]["frame_set"] == res["test"]["frame_set"] == \
        "reference"
    jax_export.main(["--out", str(theirs), "--train-frames", "1",
                     "--test-frames", "2"])
    files = sorted(str(p.relative_to(ours)) for p in ours.rglob("*"))
    assert files == sorted(str(p.relative_to(theirs))
                           for p in theirs.rglob("*"))
    for name in ("translation.txt", "sensorTrans.dat"):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    assert flags.parse_config_file(ours / "default.config") == \
        jax_flags.parse_config_file(theirs / "default.config")
    cfg = DataConfig(raw_data=False)
    scene = make_scene("room", device="cpu")
    rendered = {split: [f.obj.numpy() for f in map(
        SyntheticSource(n, seed, scene).get, range(n))]
        for split, n, seed in (("training/synth", 1, 3),
                               ("test/synth", 2, 99))}
    for split in ("training/synth", "test/synth"):
        a = seven_scenes.SevenScenesDataset(ours / split, config=cfg)
        b = jax_seven.SevenScenesDataset(theirs / split, config=JData(
            raw_data=False))
        for i in range(len(a)):
            for x, y in zip(a.get_pose(i), b.get_pose(i)):
                np.testing.assert_allclose(x, y, atol=1e-5)
            for getter in ("get_rgb", "get_depth"):
                x = getattr(a, getter)(i).astype(np.int64)
                y = getattr(b, getter)(i).astype(np.int64)
                diff = np.abs(x - y)
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, \
                    (split, i, getter)
            obj, valid = a.get_obj(i), b.get_depth(i) > 0
            for ref in (b.get_obj(i), rendered[split][i]):
                err = np.linalg.norm(obj - ref, axis=-1)[valid]
                assert np.median(err) < 10.0 and (err < 40.0).mean() > 0.95
