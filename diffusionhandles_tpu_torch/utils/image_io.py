"""Image and depth I/O and the test set's crop-and-resize.

The counterpart of the JAX package's `utils/image_io.py` (reference:
test/utils.py), with no imageio, OpenCV or PIL:

* PNG is read and written here on `zlib` and `struct`: 8-bit gray,
  gray + alpha, RGB and RGBA, not interlaced; every filter type on read,
  filter 0 on write.
* EXR goes through utils/exr.py.
* `crop_and_resize` rebuilds the JAX package's `cv2.resize` as resampling
  matrices: INTER_AREA (the area overlap of each output pixel, with
  OpenCV's 1e-3 rounding of partial cells) to shrink, INTER_LINEAR
  (half-pixel centres, clamped borders) to enlarge.
"""

from __future__ import annotations

import functools
import pathlib
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> samples a pixel
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _paeth_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        start = y * (stride + 1)
        ftype = raw[start]
        row = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = row
        elif ftype == 1:  # Sub: a running sum per byte of the pixel, mod 256
            cur = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint64).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            cur = row + prior
        elif ftype in (3, 4):
            line = bytearray(row.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(
                line, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(line), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path) -> np.ndarray:
    """PNG file -> uint8 [H, W] (gray) or [H, W, C] (C = 2, 3 or 4)."""
    data = pathlib.Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}; 8-bit gray, gray+alpha, "
                         "RGB or RGBA without interlace is read")
    c = _CHANNELS[ctype]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return pixels.reshape(h, w, c)[..., 0] if c == 1 else \
        pixels.reshape(h, w, c)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, pixels: np.ndarray) -> None:
    """uint8 [H, W] or [H, W, C] (C = 1-4) -> PNG file (filter 0)."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {pixels.dtype}")
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    h, w, c = pixels.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1-4 channels, got {c}")
    rows = np.zeros((h, 1 + w * c), np.uint8)
    rows[:, 1:] = pixels.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    pathlib.Path(path).write_bytes(
        _PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b""))


def load_image(path) -> np.ndarray:
    """Image file -> [C, H, W] float32 in [0, 1] (alpha dropped;
    reference: test/utils.py:8-19)."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img.astype(np.float32).transpose(2, 0, 1) / 255.0


def save_image(img: np.ndarray, path) -> None:
    """[C, H, W] float in [0, 1] -> PNG (test/utils.py:21-31)."""
    img = np.asarray(img)
    out = (np.clip(img, 0.0, 1.0) * 255.0).transpose(1, 2, 0).astype(
        np.uint8)
    if out.shape[-1] == 1:
        out = out[..., 0]
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_png(path, out)


def load_depth(path) -> np.ndarray:
    """Depth file (.exr or PNG) -> [1, H, W] float32
    (test/utils.py:33-42)."""
    path = pathlib.Path(path)
    if path.suffix.lower() == ".exr":
        from diffusionhandles_tpu_torch.utils.exr import read_exr
        depth = read_exr(str(path))
    else:
        depth = read_png(path).astype(np.float32)
    if depth.ndim == 3:
        depth = depth[..., 0]
    return depth.astype(np.float32)[None]


def save_depth(depth: np.ndarray, path) -> None:
    """[1, H, W] or [H, W] float32 -> .exr (test/utils.py:44-52)."""
    from diffusionhandles_tpu_torch.utils.exr import write_exr
    depth = np.asarray(depth, np.float32)
    if depth.ndim == 3:
        depth = depth[0]
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_exr(str(path), depth)


@functools.lru_cache(maxsize=32)
def area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of cv2.INTER_AREA shrinking `in_size` to
    `out_size`: each output pixel averages the source interval
    [i * s, (i + 1) * s) (s = in / out) by overlap, as OpenCV's
    computeResizeAreaTab (partial cells under 1e-3 are dropped)."""
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), np.float64)
    for dx in range(out_size):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, in_size - fsx1)
        sx1 = int(np.ceil(fsx1))
        sx2 = min(int(np.floor(fsx2)), in_size - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            mat[dx, sx1 - 1] = (sx1 - fsx1) / cell
        mat[dx, sx1:sx2] = 1.0 / cell
        if fsx2 - sx2 > 1e-3:
            mat[dx, sx2] = min(min(fsx2 - sx2, 1.0), cell) / cell
    return mat


@functools.lru_cache(maxsize=32)
def linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of cv2.INTER_LINEAR: half-pixel centres, the
    source coordinate clamped to the border."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    t = src - i0
    mat = np.zeros((out_size, in_size), np.float64)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, i0), 1.0 - t)
    np.add.at(mat, (rows, np.minimum(i0 + 1, in_size - 1)), t)
    return mat


def crop_and_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Center-crop [C, H, W] to a square, then resize it to `size`:
    INTER_AREA to shrink, INTER_LINEAR to enlarge (reference:
    test/utils.py:54-58). float32 out."""
    c, h, w = img.shape
    if h != w:
        s = min(h, w)
        top, left = (h - s) // 2, (w - s) // 2
        img = img[:, top:top + s, left:left + s]
        h = s
    if h == size:
        return img
    mat = area_matrix(h, size) if size < h else linear_matrix(h, size)
    out = mat @ np.asarray(img, np.float64) @ mat.T
    return out.astype(np.float32)
