"""A small PNG codec in zlib and numpy: the port's stand-in for OpenCV's
`cv2.imread(path, cv2.IMREAD_GRAYSCALE)` and `cv2.imwrite`.

`read` decodes 8-bit, non-interlaced PNGs of colour type gray (0), RGB
(2), gray + alpha (4) and RGBA (6), with all five row filters (None, Sub,
Up, Average, Paeth); `read_gray` returns them as uint8 [H, W] gray: colour converts
with the BT.601 weights in OpenCV's fixed point (R 4899, G 9617, B 1868
over 2^14), alpha is dropped. Any other PNG (16-bit, palette, interlaced,
a bit depth below 8) raises a ValueError that names the file. EuRoC's and
KITTI odometry's images are 8-bit gray. `write` stores uint8 gray [H, W]
or RGB [H, W, 3] with the Up filter on every row.

Rows that use only None, Sub and Up are undone one row at a time, each row
vectorised (Sub is a running sum modulo 256). Average and Paeth predict a
byte from the reconstructed byte to its left, so within a row they run in
sequence; a file with such rows is undone along anti-diagonals instead:
the rows are sheared so that pixel (y, x) lands in column x + y, and one
step reconstructs every pixel of a column, whose left, upper and
upper-left neighbours all lie in earlier columns (W + H - 1 vectorised
steps in place of W x H scalar ones).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: channels per colour type
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _predict(kinds, a, b, c):
    """The predictor from the left (a), upper (b) and upper-left (c)
    reconstructed bytes, int32; `kinds` holds the rows' masks of filter
    types Sub, Up, Average and Paeth, broadcast against a, b, c."""
    return np.select(kinds, [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)


def _unfilter_rows(ft: np.ndarray, f: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of filter types None, Sub and Up, one vectorised row at a time."""
    out = np.empty_like(f)
    prev = np.zeros(f.shape[1], np.uint8)
    for y, t in enumerate(ft):
        if t == 1:
            row = np.cumsum(f[y].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif t == 2:
            row = f[y] + prev
        else:
            row = f[y]
        out[y] = prev = row
    return out


def _unfilter_diagonal(ft: np.ndarray, f: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters, undone along anti-diagonals. Pixel (y, x)
    sits at R[y + 1, x + y + 1]; row 0 and the columns left of each
    sheared row stay 0, the PNG's bytes above and left of the image."""
    H, n = f.shape
    W = n // bpp
    R = np.zeros((H + 1, W + H + 1, bpp), np.int32)
    F = np.zeros_like(R)
    ys, xs = np.mgrid[0:H, 0:W]
    F[ys + 1, xs + ys + 1] = f.reshape(H, W, bpp)
    kinds = [(ft == t)[:, None, None] for t in (1, 2, 3, 4)]
    for col in range(1, W + H):
        lo, hi = max(1, col - W + 1), min(H, col)
        rows = slice(lo, hi + 1)
        above = slice(lo - 1, hi)
        a, b, c = R[rows, col - 1], R[above, col - 1], R[above, col - 2]
        R[rows, col] = (F[rows, col] + _predict([k[above, 0] for k in kinds], a, b, c)) & 255
    return R[ys + 1, xs + ys + 1].astype(np.uint8).reshape(H, n)


def read(path: str) -> np.ndarray:
    """The PNG at `path` as stored: uint8 [H, W] (gray) or [H, W, C] (gray
    + alpha, RGB, RGBA)."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color, _, _, interlace = header
    what = ("interlaced" if interlace else f"bit depth {depth}" if depth != 8
            else "palette" if color == 3 else f"colour type {color}" if color not in _CHANNELS else None)
    if what:
        raise ValueError(f"{path}: unsupported PNG ({what}); 8-bit gray, gray+alpha, RGB or RGBA only")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + W * bpp)
    ft, f = raw[:, 0], raw[:, 1:]
    if int(ft.max(initial=0)) > 4:
        raise ValueError(f"{path}: unknown row filter {int(ft.max())}")
    img = (_unfilter_rows if int(ft.max(initial=0)) <= 2 else _unfilter_diagonal)(ft, f, bpp)
    return img.reshape(H, W) if bpp == 1 else img.reshape(H, W, bpp)


def read_gray(path: str) -> np.ndarray:
    """The PNG at `path` as uint8 gray [H, W] (cv2.IMREAD_GRAYSCALE)."""
    img = read(path)
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.int32)
    return ((rgb[..., 0] * 4899 + rgb[..., 1] * 9617 + rgb[..., 2] * 1868 + 8192) >> 14).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write(path: str, image: np.ndarray):
    """Write uint8 gray [H, W] or RGB [H, W, 3] as a PNG (Up filter)."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"{path}: write takes uint8 [H, W] or [H, W, 3], got {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    rows = img.reshape(H, -1)
    up = np.concatenate([rows[:1], rows[1:] - rows[:-1]])
    raw = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
                 + _chunk(b"IEND", b""))
