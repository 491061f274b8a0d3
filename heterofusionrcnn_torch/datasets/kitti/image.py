"""Image IO for the KITTI loader without OpenCV or PIL.

The JAX package reads frames with `cv2.imread`, resizes them with
`cv2.resize` and reads image sizes with `PIL.Image.open(...).size`. Here:

- `read_png`: a PNG decoder (stdlib `zlib` and numpy) for 8-bit,
  non-interlaced RGB images, the KITTI camera's format. Lossless, so it
  equals `cv2.imread(path)[..., ::-1]`. Sub and Up rows are unfiltered
  with numpy; Average and Paeth rows, which depend on the pixel to their
  left, byte by byte.
- `resize_bilinear`: `cv2.resize(image, (w, h))` (INTER_LINEAR) for uint8
  images: half-pixel source coordinates in float32, 11-bit fixed-point
  weights rounded one by one, a horizontal pass in integers and OpenCV's
  vectorised vertical pass ((S >> 4) * beta >> 16, then (sum + 2) >> 2).
- `png_size`: (width, height) from the IHDR chunk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def png_size(path: str):
    """(width, height) of a PNG file, as `PIL.Image.open(path).size`."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def _unfilter_sequential(kind: int, line: bytes, prev: bytes, bpp: int) -> bytearray:
    """Average (3) or Paeth (4) unfiltering of one row, byte by byte."""
    out = bytearray(line)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB PNG bytes -> (H, W, 3) RGB uint8."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour != 2 or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace} (8-bit RGB, not interlaced, is read)")
    bpp = 3
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG data size does not match its header")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = np.frombuffer(
                _unfilter_sequential(kind, line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind} in row {y}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG file as (H, W, 3) RGB uint8, equal to
    `cv2.imread(path)[..., ::-1]`."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _linear_coeffs(n_in: int, n_out: int):
    """Source index and the two fixed-point weights of each output index,
    as OpenCV's resize computes them."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    low = s < 0
    f[low], s[low] = 0, 0
    high = s + 1 >= n_in
    f[high], s[high] = 0, n_in - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return s, np.minimum(s + 1, n_in - 1), w0, w1


def resize_bilinear(image: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8, as `cv2.resize(image, (w, h))`."""
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError("resize_bilinear takes (H, W, C) uint8 images")
    sx0, sx1, a0, a1 = _linear_coeffs(image.shape[1], w)
    sy0, sy1, b0, b1 = _linear_coeffs(image.shape[0], h)
    x = image.astype(np.int64)
    horiz = x[:, sx0] * a0[None, :, None] + x[:, sx1] * a1[None, :, None]
    t0 = ((horiz[sy0] >> 4) * b0[:, None, None]) >> 16
    t1 = ((horiz[sy1] >> 4) * b1[:, None, None]) >> 16
    return np.clip((t0 + t1 + 2) >> 2, 0, 255).astype(np.uint8)
