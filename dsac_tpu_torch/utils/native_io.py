"""PNG decoding and threaded prefetch of 7-Scenes frames (port of
dsac_tpu/utils/native_io.py): ctypes over the C interface of
native/dsac_io.cpp (``dsac_png_size``, ``dsac_read_png_rgb``,
``dsac_read_png_depth16`` and ``dsac_loader_*``), or, where that library
cannot be loaded, a small PNG codec of the port's own in numpy and the
standard library's zlib.

The library is the repository's ``native/libdsac_io.so``, loaded as it
is (the reference rebuilds it with ``make`` in ``native/``; the port
never writes there).  Where it does not load (it links libpng16, which
a machine may lack), the port's codec decodes: 8-bit RGB and 16-bit
grayscale, non-interlaced, with the five row filters, which is what
7-Scenes and ``export_synthetic`` write.  It also writes those PNGs,
with adaptive row filters as PIL does.
``decoder()`` says which one runs.  This is host IO; frames go to the
device as tensors at the entry points.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_NATIVE_LIB = _REPO / "native" / "libdsac_io.so"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

_lib: ctypes.CDLL | None = None
_lib_tried = False
_decoder = "python"


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    cint = ctypes.c_int
    lib.dsac_png_size.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(cint)] * 4
    lib.dsac_png_size.restype = cint
    lib.dsac_read_png_rgb.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), cint, cint]
    lib.dsac_read_png_rgb.restype = cint
    lib.dsac_read_png_depth16.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16), cint, cint]
    lib.dsac_read_png_depth16.restype = cint
    lib.dsac_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        cint, ctypes.POINTER(cint), cint, cint, cint, cint, cint]
    lib.dsac_loader_create.restype = ctypes.c_void_p
    lib.dsac_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(cint)]
    lib.dsac_loader_next.restype = cint
    lib.dsac_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The native library, loaded once; None where it does not load."""
    global _lib, _lib_tried, _decoder
    if not _lib_tried:
        _lib_tried = True
        try:
            _lib = _bind(_NATIVE_LIB)
            _decoder = f"native:{_NATIVE_LIB.relative_to(_REPO)}"
        except OSError:
            _lib = None
    return _lib


def decoder() -> str:
    """Which decoder runs: ``native:<library>`` or ``python`` (the port's
    codec)."""
    get_lib()
    return _decoder


# ---- the port's PNG codec ----

def _chunks(data: bytes):
    pos = len(_PNG_MAGIC)
    while pos < len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of the PNG specification, elementwise."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filt: np.ndarray, lines: np.ndarray, bpp: int
                   ) -> np.ndarray:
    """Undo the row filters one row at a time: none, sub and up rows
    whole, average and Paeth rows byte by byte, left to right."""
    out = np.empty_like(lines)
    prev = np.zeros(lines.shape[1], np.uint8)
    for y, (kind, line) in enumerate(zip(filt, lines)):
        if kind == 0:
            cur = line
        elif kind == 1:  # sub: a running sum a channel, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # up
            cur = line + prev
        else:  # average, Paeth
            cur = line.tolist()
            up = prev.tolist()
            for x in range(len(cur)):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.asarray(cur, np.uint8)
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_wavefront(filt: np.ndarray, lines: np.ndarray, bpp: int
                        ) -> np.ndarray:
    """Undo the row filters a diagonal at a time.  A pixel's bytes depend
    on its left, upper and upper-left neighbours only, so the pixels of
    one anti-diagonal (y + x = d) depend only on earlier diagonals: each
    diagonal is undone whole, in H + W - 1 steps of numpy.  The image is
    held skewed, pixel (y, x) at s[y + x + 2, y + 1], so that a diagonal
    and its neighbours' are contiguous slices and the skew's zero border
    is the filters' zero outside the image."""
    h = lines.shape[0]
    w = lines.shape[1] // bpp
    ys, xs = np.divmod(np.arange(h * w), w)
    raw = np.zeros((h + w - 1, h, bpp), np.int16)
    raw[ys + xs, ys] = lines.reshape(h * w, bpp)
    s = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    sub, up, avg, paeth = (filt[:, None] == k for k in (1, 2, 3, 4))
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1
        a = s[d + 1, lo + 1:hi + 1]  # (y, x - 1)
        b = s[d + 1, lo:hi]  # (y - 1, x)
        pred = np.where(sub[lo:hi], a, np.where(up[lo:hi], b, 0))
        pred = np.where(avg[lo:hi], (a + b) >> 1, pred)
        c = s[d, lo:hi]  # (y - 1, x - 1)
        pred = np.where(paeth[lo:hi], _paeth(a, b, c), pred)
        pred += raw[d, lo:hi]
        pred &= 0xFF
        s[d + 2, lo + 1:hi + 1] = pred
    return s[ys + xs + 2, ys + 1].astype(np.uint8).reshape(h, w * bpp)


# On the H100 machine's host, the row loop undoes an average or Paeth
# byte in ~0.49 us and the wavefront a diagonal of a 640 x 480 frame in
# 52-65 us (chip_smoke.py data_7scenes, decode_host_ms), so the wavefront
# pays once such rows hold more than ~120 bytes per diagonal.
_WAVEFRONT_BYTES_PER_DIAGONAL = 120


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (none, sub, up, average, Paeth) of
    rows (H, 1 + row bytes), the filter type first: a row at a time, or a
    diagonal at a time where average and Paeth rows, which need the byte
    to their left first, hold many bytes."""
    filt, lines = rows[:, 0], rows[:, 1:]
    if filt.max(initial=0) > 4:
        raise IOError(f"PNG row filter {filt.max()} is not one of the five")
    diagonals = len(rows) + lines.shape[1] // bpp - 1
    if ((filt >= 3).sum() * lines.shape[1]
            > _WAVEFRONT_BYTES_PER_DIAGONAL * diagonals):
        return _unfilter_wavefront(filt, lines, bpp)
    return _unfilter_rows(filt, lines, bpp)


def filter_rows(rows: np.ndarray, bpp: int, kind: int | str = "adaptive"
                ) -> np.ndarray:
    """PNG-filtered rows, (H, 1 + row bytes) uint8 with the filter type
    first: every row in filter ``kind`` (0-4), or, for ``"adaptive"``,
    each row in the filter whose bytes, read as signed, have the least
    sum of magnitudes (libpng's and PIL's heuristic)."""
    x = rows.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    preds = (0, left, up, (left + up) >> 1, _paeth(left, up, upleft))
    kinds = range(5) if kind == "adaptive" else (kind,)
    res = np.stack([(x - preds[k]) & 0xFF for k in kinds])
    if kind == "adaptive":
        cost = np.minimum(res, 256 - res).sum(axis=2)
        choice = cost.argmin(axis=0)
    else:
        choice = np.zeros(len(x), np.int64)
    picked = np.take_along_axis(res, choice[None, :, None], 0)[0]
    filt = np.asarray(kinds)[choice]
    return np.concatenate([filt[:, None], picked], axis=1).astype(np.uint8)


def _filtered_rows(data: bytes) -> tuple[np.ndarray, int, int]:
    """A non-interlaced 8-bit RGB or 16-bit grayscale PNG -> its filtered
    rows (H, 1 + row bytes) uint8, the filter type first; bytes a pixel;
    channels."""
    if not data.startswith(_PNG_MAGIC):
        raise IOError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, colour, _comp, _filt, interlace = header
    if interlace:
        raise IOError("interlaced PNGs are not supported")
    if (depth, colour) == (8, 2):
        channels, bpp = 3, 3
    elif (depth, colour) == (16, 0):
        channels, bpp = 1, 2
    else:
        raise IOError(f"PNG of bit depth {depth} and colour type {colour}: "
                      "only 8-bit RGB and 16-bit grayscale are supported")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8,
                         height * (width * bpp + 1))
    return rows.reshape(height, width * bpp + 1), bpp, channels


def row_filters(data: bytes) -> np.ndarray:
    """The filter type (0-4) of each row of a PNG."""
    return _filtered_rows(data)[0][:, 0]


def decode_png(data: bytes) -> np.ndarray:
    """A non-interlaced 8-bit RGB or 16-bit grayscale PNG -> (H, W, 3)
    uint8 or (H, W) uint16."""
    rows, bpp, channels = _filtered_rows(data)
    out = _unfilter(rows, bpp)
    if channels == 3:
        return out.reshape(len(rows), -1, 3)
    return out.view(">u2").reshape(len(rows), -1).astype(np.uint16)


def encode_png(image: np.ndarray, kind: int | str = "adaptive") -> bytes:
    """(H, W, 3) uint8 or (H, W) uint16 -> PNG bytes (8-bit RGB or 16-bit
    grayscale), rows filtered as ``filter_rows`` says: adaptive, as PIL
    writes them, unless ``kind`` names one filter."""
    image = np.asarray(image)
    if image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        depth, colour, bpp = 8, 2, 3
        rows = image.reshape(image.shape[0], -1)
    elif image.dtype == np.uint16 and image.ndim == 2:
        depth, colour, bpp = 16, 0, 2
        rows = image.astype(">u2").view(np.uint8)
    else:
        raise ValueError("encode_png takes (H, W, 3) uint8 or (H, W) "
                         "uint16")
    h, w = image.shape[:2]
    raw = filter_rows(rows, bpp, kind)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str | Path, image: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(image))


# ---- the decoder the port runs ----

def png_size(path: str) -> tuple[int, int, int, int]:
    """(width, height, channels, bit depth) of a PNG file."""
    lib = get_lib()
    if lib is None:
        data = Path(path).read_bytes()
        w, h, depth, colour = struct.unpack_from(">IIBB", data, 16)
        return w, h, {0: 1, 2: 3, 4: 2, 6: 4}.get(colour, 1), depth
    w, h, c, b = (ctypes.c_int() for _ in range(4))
    rc = lib.dsac_png_size(path.encode(), ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(c), ctypes.byref(b))
    if rc != 0:
        raise IOError(f"dsac_png_size({path}) -> {rc}")
    return w.value, h.value, c.value, b.value


def _checked(image: np.ndarray, path: str, shape: tuple) -> np.ndarray:
    if image.shape != shape:
        raise IOError(f"{path}: {image.shape[:2][::-1]} pixels, not "
                      f"{shape[:2][::-1]}")
    return image


def read_rgb(path: str, width: int, height: int) -> np.ndarray:
    """An 8-bit RGB PNG -> (H, W, 3) uint8."""
    lib = get_lib()
    if lib is None:
        img = decode_png(Path(path).read_bytes())
        if img.ndim != 3:
            raise IOError(f"{path}: not an 8-bit RGB PNG")
        return _checked(img, path, (height, width, 3))
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.dsac_read_png_rgb(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        width, height)
    if rc != 0:
        raise IOError(f"dsac_read_png_rgb({path}) -> {rc}")
    return out


def read_depth16(path: str, width: int, height: int) -> np.ndarray:
    """A 16-bit grayscale PNG -> (H, W) uint16, depth in mm."""
    lib = get_lib()
    if lib is None:
        img = decode_png(Path(path).read_bytes())
        if img.ndim != 2:
            raise IOError(f"{path}: not a 16-bit grayscale PNG")
        return _checked(img, path, (height, width))
    out = np.empty((height, width), np.uint16)
    rc = lib.dsac_read_png_depth16(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        width, height)
    if rc != 0:
        raise IOError(f"dsac_read_png_depth16({path}) -> {rc}")
    return out


class PrefetchLoader:
    """In-order threaded prefetch of RGB (and depth) frames over a file
    sequence: yields (file index, rgb, depth or None) in the order of
    ``sequence``, ``capacity`` frames ahead at most, on ``n_threads``
    threads: the native loader's, or a thread pool over the port's codec.
    """

    def __init__(self, rgb_paths: list[str], depth_paths: list[str] | None,
                 sequence: list[int], width: int, height: int,
                 n_threads: int = 3, capacity: int = 8):
        self.width, self.height = width, height
        self.has_depth = depth_paths is not None
        self._n, self._emitted = len(sequence), 0
        self._lib = get_lib()
        self._handle = self._pool = None
        if self._lib is not None:
            n = len(rgb_paths)
            self._rgb_arr = (ctypes.c_char_p * n)(
                *[p.encode() for p in rgb_paths])
            self._depth_arr = None
            if depth_paths is not None:
                assert len(depth_paths) == n
                self._depth_arr = (ctypes.c_char_p * n)(
                    *[p.encode() for p in depth_paths])
            seq = (ctypes.c_int * len(sequence))(*sequence)
            self._handle = self._lib.dsac_loader_create(
                self._rgb_arr, self._depth_arr, n, seq, len(sequence),
                width, height, n_threads, capacity)
            return

        def load(i):
            rgb = read_rgb(rgb_paths[i], width, height)
            depth = (read_depth16(depth_paths[i], width, height)
                     if depth_paths is not None else None)
            return i, rgb, depth

        self._pool = concurrent.futures.ThreadPoolExecutor(max(1, n_threads))
        self._todo = iter(sequence)
        self._ahead = []
        for _ in range(max(1, capacity)):
            self._submit(load)
        self._load = load

    def _submit(self, load) -> None:
        i = next(self._todo, None)
        if i is not None:
            self._ahead.append(self._pool.submit(load, i))

    def __iter__(self):
        return self

    def __next__(self):
        if self._emitted >= self._n:
            raise StopIteration
        self._emitted += 1
        if self._pool is not None:
            out = self._ahead.pop(0).result()
            self._submit(self._load)
            return out
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        depth = (np.empty((self.height, self.width), np.uint16)
                 if self.has_depth else None)
        idx = ctypes.c_int()
        rc = self._lib.dsac_loader_next(
            self._handle, rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
            if depth is not None else None, ctypes.byref(idx))
        if rc == -1:
            raise StopIteration
        if rc != 0:
            raise IOError(f"frame {idx.value} failed to decode (rc={rc})")
        return idx.value, rgb, depth

    def close(self) -> None:
        if self._handle:
            self._lib.dsac_loader_destroy(self._handle)
            self._handle = None
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
