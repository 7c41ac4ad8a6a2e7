"""PNG reading and writing with zlib and numpy.

The machine with the card has no PIL, so the label generator, the label
reader and the image reader decode PNG files with this module, to exactly
the pixels that Pillow's `Image.open(f).convert(mode)` gives for mode "L"
or "RGB". Every kind of the PNG standard is read:

  * colour types 0 (grey, bit depths 1, 2, 4, 8, 16), 2 (RGB, 8, 16),
    3 (palette, 1, 2, 4, 8), 4 (grey + alpha, 8, 16), 6 (RGBA, 8, 16);
  * Adam7 interlace, each pass unfiltered at its own width;
  * the five row filters (None, Sub, Up, Average, Paeth); every chunk's
    CRC is checked.

Pillow's rules, which the conversions follow (`_pil_mode`, `_convert`):

  * bit depths 1, 2 and 4 of grey scale to 0-255 (x 255, 85, 17); a
    palette index is never scaled;
  * 16-bit grey opens as "I;16", and "L" or "RGB" clamp it at 255; 16-bit
    RGB, RGBA and grey + alpha keep each sample's high byte;
  * palette -> "L" is `pil_ops.rgb_to_l` of the palette entry, -> "RGB" the
    entry itself; indices past the PLTE read (0, 0, 0); tRNS plays no part
    in either (Pillow drops it);
  * grey + alpha -> "L" is the grey sample, not a luma.

`decode_png(data)` with no mode gives the array of Pillow's own mode of the
file (`np.asarray(Image.open(f))`: bool for 1-bit grey, palette indices,
uint16 for 16-bit grey, (H, W, 2) for grey + alpha). Writing takes 8-bit
grey, RGB and RGBA with filter None on every row.

Sub and Up rows are unfiltered with numpy; Average and Paeth rows, whose
every byte depends on the one before it, in a Python loop, so images written
with those filters decode at about a megabyte per second.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from prismer_tpu_torch.data.pil_ops import to_mode

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}       # colour type -> samples
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
MODES = ("L", "RGB")


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


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered rows -> (h, stride) bytes; bpp is the
    filter's byte distance (1 below 8 bits a pixel)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
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


def _samples(rows: np.ndarray, w: int, depth: int, ch: int) -> np.ndarray:
    """Unfiltered (h, stride) bytes -> (h, w, ch) raw samples: uint8 below
    16 bits (unscaled), uint16 at 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    per = 8 // depth                       # samples a byte, first the high
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w].reshape(h, w, 1).astype(np.uint8)


def _pixels(raw: np.ndarray, w: int, h: int, depth: int, ch: int,
            interlace: int) -> np.ndarray:
    """The inflated IDAT stream -> (h, w, ch) raw samples."""
    bits = depth * ch
    bpp = max(1, bits // 8)
    if not interlace:
        stride = -(-(w * bits) // 8)
        if raw.size != h * (stride + 1):
            raise ValueError(f"PNG image data has {raw.size} bytes, want "
                             f"{h * (stride + 1)}")
        return _samples(_unfilter(raw.reshape(h, stride + 1), bpp), w,
                        depth, ch)
    out = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue                       # an empty pass has no rows
        stride = -(-(pw * bits) // 8)
        size = ph * (stride + 1)
        if raw.size < pos + size:
            raise ValueError(f"PNG image data has {raw.size} bytes, too few "
                             f"for a {w} x {h} image")
        rows = _unfilter(raw[pos:pos + size].reshape(ph, stride + 1), bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, depth, ch)
        pos += size
    if raw.size != pos:
        raise ValueError(f"PNG image data has {raw.size} bytes, want {pos}")
    return out


def _pil_mode(px: np.ndarray, depth: int, color: int):
    """Raw samples -> (Pillow's mode of the file, its pixels as Pillow
    holds them: 0-255 grey for "1" and "L", indices for "P", uint16 for
    "I;16", high bytes for 16-bit colour and grey + alpha)."""
    if color == 3:
        return "P", px[..., 0]
    if color == 0:
        if depth == 16:
            return "I;16", px[..., 0]
        g = px[..., 0]
        if depth < 8:
            g = g * np.uint8(255 // ((1 << depth) - 1))
        return ("1" if depth == 1 else "L"), g
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if color == 4:
        if depth == 16:                    # Pillow reads it as RGBA
            return "RGBA", np.concatenate([px[..., :1]] * 3 + [px[..., 1:]],
                                          axis=-1)
        return "LA", px
    return ("RGB" if color == 2 else "RGBA"), px


def _convert(mode: str, px: np.ndarray, palette: np.ndarray,
             to: str) -> np.ndarray:
    """Pillow's `convert(to)` for "L" or "RGB" of an image of `mode`."""
    if mode == "P":
        px = palette[px]
    elif mode == "I;16":
        px = np.minimum(px, 255).astype(np.uint8)
    elif mode == "LA":
        px = px[..., 0]
    return to_mode(px, to)


def decode_png(data: bytes, mode: Optional[str] = None) -> np.ndarray:
    """PNG bytes -> uint8 pixels as Pillow's `Image.open(f).convert(mode)`
    gives them: (H, W) for "L", (H, W, 3) for "RGB". Without a mode, the
    array of Pillow's own mode of the file (see the module note); for 8-bit
    grey, RGB and RGBA files that is (H, W), (H, W, 3) and (H, W, 4)."""
    if mode is not None and mode not in MODES:
        raise ValueError(f"decode_png: mode {mode!r} (takes one of {MODES})")
    header, idat, plte = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, color, compression, filt, interlace = header
    if depth not in _DEPTHS.get(color, ()) or compression or filt \
            or interlace > 1:
        raise ValueError(f"invalid PNG header: bit depth {depth}, colour "
                         f"type {color}, compression {compression}, filter "
                         f"{filt}, interlace {interlace}")
    palette = None
    if color == 3:
        if plte is None or len(plte) % 3 or not 0 < len(plte) <= 768:
            raise ValueError("palette PNG without a valid PLTE chunk")
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(
            -1, 3)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _pixels(raw, w, h, depth, _CHANNELS[color], interlace)
    pil_mode, px = _pil_mode(px, depth, color)
    if mode is None:
        if pil_mode == "1":
            return px > 0
        return px
    return _convert(pil_mode, px, palette, mode)


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


def read_png(path: str, mode: Optional[str] = None) -> np.ndarray:
    """`decode_png` of the file at `path`."""
    with open(path, "rb") as f:
        return decode_png(f.read(), mode)


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
