"""8-bit PNG reading and writing with zlib and numpy.

The machine with the card has no PIL, so the label generator reads its
images and writes its label maps with this module. It reads non-interlaced
8-bit grey, RGB and RGBA images with any of the five row filters (None,
Sub, Up, Average, Paeth) and checks every chunk's CRC; it writes the same
three colour types with filter None on every row. Anything else (16-bit,
palette, grey + alpha, interlaced) raises `ValueError`.

Sub and Up rows are unfiltered with numpy; Average and Paeth rows, whose
every byte depends on the one before it, in a Python loop, so images written
with those filters decode at about a megabyte per second.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> channels


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _unfilter_loop(line, prior, bpp: int, paeth: bool) -> bytearray:
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        if paeth:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        out[i] = (x + pred) & 255
    return out


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG image data has {raw.size} bytes, want "
                         f"{h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[y] = line + prior
        elif kind in (3, 4):
            out[y] = np.frombuffer(_unfilter_loop(
                line.tolist(), prior.tolist(), bpp, kind == 4), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, color, compression, filt, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace or compression \
            or filt:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{color}, interlace {interlace} (this reader takes "
                         f"8-bit grey, RGB or RGBA, non-interlaced)")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * ch, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W), (H, W, 3) or (H, W, 4) -> PNG bytes (filter None)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (3, 4)):
        raise ValueError(f"encode_png takes uint8 (H, W[, 3 or 4]), got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color = {1: 0, 3: 2, 4: 6}[1 if img.ndim == 2 else img.shape[2]]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
