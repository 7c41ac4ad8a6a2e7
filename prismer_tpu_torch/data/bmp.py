"""BMP and DIB reading with numpy, equal to Pillow 12's `BmpImagePlugin`.

The machine with the card has no PIL, so `read_rgb` (data/labels.py) reads
BMP files with this module, to exactly the pixels that Pillow's
`Image.open(f).convert("RGB")` gives with `ImageFile.LOAD_TRUNCATED_IMAGES =
True`, and `decode_bmp(data)` with no mode gives the array of Pillow's own
mode (`np.asarray(Image.open(f))`). What is read, as Pillow reads it:

  * a "BM" file, or a bare DIB (a header of 12, 40, 52, 56, 64, 108 or 124
    bytes at the start, Pillow's DibImageFile);
  * OS/2 core headers (12 bytes: 16-bit sizes, 3-byte palette entries) and
    the 40 / 52 / 56 / 64 / 108 / 124-byte headers (4-byte entries); a
    negative height (top byte 0xFF) is a top-down image, else rows run
    bottom-up;
  * 1, 4 and 8 bits with a palette; a palette that is the grey ramp (black
    and white for 2 colours) opens as "1" or "L", whose raw modes then read
    1 or 8 bits a pixel whatever the file's depth, as Pillow does;
  * 16-bit 5-5-5 ("BGR;15"), BI_BITFIELDS 5-6-5 ("BGR;16") and 5-5-5, a
    channel scaled as `v * 255 // max`; 24-bit BGR; 32-bit BGRX, or by its
    BI_BITFIELDS masks one of Pillow's eight layouts (four with alpha open
    as "RGBA");
  * BI_RLE8 and BI_RLE4 as Pillow's BmpRleDecoder runs them: a run is cut
    at the row's end, end-of-line pads the row with index 0, a delta reads
    its offsets from the two bytes after the two it skips, an absolute run
    of RLE4 reads n // 2 bytes, and the data that does not fill the image
    raises.

Raw rows are read whole from the pixel offset; rows missing at the end of
the file stay 0 (index 0, so palette entry 0 in RGB). Since rows run
bottom-up, a cut file loses the top of the image.

Refused with ValueError, naming the feature, where Pillow raises: an unknown
header size, 2-bit and other unsupported depths, BI_JPEG and BI_PNG and
other compressions, bitfields outside Pillow's layouts, a palette of 0 or
more than 65536 colours (more than 256 entries read, unless grey), an empty
image, a header cut short, more pixels than
Pillow's decompression-bomb limit, and RLE data that ends early.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

MAGIC = b"BM"
DIB_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
MODES = ("RGB",)
_MAX_PIXELS = 178956970          # Pillow's Image.MAX_IMAGE_PIXELS * 2
_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
             16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW_BITS = {"P;1": 1, "P;4": 4, "P": 8, "L": 8, "1": 1, "BGR;15": 16,
             "BGR;16": 16, "BGR": 24}
_COMPRESSIONS = {0: "RAW", 1: "RLE8", 2: "RLE4", 3: "BITFIELDS", 4: "JPEG",
                 5: "PNG"}


def is_dib(data: bytes) -> bool:
    """True for the first bytes of a bare DIB, as Pillow's `_dib_accept`."""
    return len(data) >= 4 and \
        struct.unpack("<I", data[:4])[0] in DIB_HEADER_SIZES


def _u32(b: bytes, off: int = 0) -> int:
    return struct.unpack_from("<I", b, off)[0]


def _u16(b: bytes, off: int = 0) -> int:
    return struct.unpack_from("<H", b, off)[0]


class _File:
    """The parts of a file object the plugin uses: read, tell, seek."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out


def _header(f: _File, offset: int):
    """BmpImageFile._bitmap: (width, height, mode, raw mode, decoder, pixel
    offset, stride or RLE4 flag, direction, RGB palette or None)."""
    head = f.read(4)
    if len(head) < 4:
        raise ValueError("BMP header is cut short")
    header_size = _u32(head)
    if header_size < 4:
        raise ValueError(f"BMP header size {header_size} is invalid")
    hd = f.read(header_size - 4)
    if len(hd) < header_size - 4:
        raise ValueError("BMP header is cut short")
    direction = -1
    colors = 0
    masks = None
    if header_size == 12:
        width, height = _u16(hd, 0), _u16(hd, 2)
        bits = _u16(hd, 6)
        compression = 0
        padding = 3
    elif header_size in (40, 52, 56, 64, 108, 124):
        y_flip = hd[7] == 0xFF
        direction = 1 if y_flip else -1
        width = _u32(hd, 0)
        height = 2 ** 32 - _u32(hd, 4) if y_flip else _u32(hd, 4)
        bits = _u16(hd, 10)
        compression = _u32(hd, 12)
        colors = _u32(hd, 28)
        padding = 4
        if compression == 3:
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = [_u32(hd, 36 + 4 * i) for i in range(n)]
                masks += [0] * (4 - n)
            else:
                raw = f.read(12)
                if len(raw) < 12:
                    raise ValueError("BMP bitfield masks are cut short")
                masks = [_u32(raw, 4 * i) for i in range(3)] + [0]
    else:
        raise ValueError(f"BMP header size {header_size} is not supported")
    if width * height > _MAX_PIXELS:
        raise ValueError(f"BMP of {width}x{height} exceeds Pillow's "
                         "decompression-bomb limit")
    colors = colors if colors else 1 << bits
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise ValueError(f"BMP pixel depth {bits} is not supported")
    mode, raw_mode = _BIT2MODE[bits]
    decoder = "raw"
    if compression == 3:
        if bits == 32 and (32, tuple(masks)) in _MASK_MODES:
            raw_mode = _MASK_MODES[(32, tuple(masks))]
            mode = "RGBA" if "A" in raw_mode else mode
        elif bits in (24, 16) and (bits, tuple(masks[:3])) in _MASK_MODES:
            raw_mode = _MASK_MODES[(bits, tuple(masks[:3]))]
        else:
            raise ValueError("BMP bitfields layout is not supported")
    elif compression in (1, 2):
        decoder = "rle"
    elif compression != 0:
        name = _COMPRESSIONS.get(compression, str(compression))
        raise ValueError(f"BMP compression {name} is not supported")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette of {colors} colours is not "
                             "supported")
        pal = f.read(padding * colors)
        indices = (0, 255) if colors == 2 else range(colors)
        grey = all(pal[i * padding:i * padding + 3] == bytes([v & 255]) * 3
                   for i, v in enumerate(indices))
        if grey:
            mode = raw_mode = "1" if colors == 2 else "L"
        else:
            n = len(pal) // padding
            if n > 256:
                raise ValueError(f"BMP palette of {n} entries is more than "
                                 "Pillow's 256")
            bgr = np.frombuffer(pal[:n * padding], np.uint8)
            palette = bgr.reshape(n, padding)[:, 2::-1]
    extra = compression == 2 if decoder == "rle" else \
        ((width * bits + 31) >> 3) & ~3
    return (width, height, mode, raw_mode, decoder, offset or f.pos, extra,
            direction, palette)


def _unpack(rows: np.ndarray, raw_mode: str, width: int) -> np.ndarray:
    """Pillow's unpackers over (n, line bytes) rows -> the mode's array."""
    if raw_mode in ("P;1", "1"):
        out = np.unpackbits(rows, axis=1)[:, :width]
        return out * 255 if raw_mode == "1" else out
    if raw_mode == "P;4":
        out = np.stack([rows >> 4, rows & 15], -1).reshape(len(rows), -1)
        return out[:, :width]
    if raw_mode in ("P", "L"):
        return rows[:, :width]
    if raw_mode in ("BGR;15", "BGR;16"):
        v = rows[:, 0:2 * width:2].astype(np.int32) | \
            (rows[:, 1:2 * width:2].astype(np.int32) << 8)
        if raw_mode == "BGR;15":
            r, g = (v >> 10) & 31, ((v >> 5) & 31) * 255 // 31
        else:
            r, g = (v >> 11) & 31, ((v >> 5) & 63) * 255 // 63
        return np.stack([r * 255 // 31, g, (v & 31) * 255 // 31],
                        -1).astype(np.uint8)
    if raw_mode == "BGR":
        return rows[:, :3 * width].reshape(len(rows), width, 3)[..., ::-1]
    px = rows[:, :4 * width].reshape(len(rows), width, 4)
    order = [raw_mode.index(c) for c in ("RGBA" if "A" in raw_mode else "RGB")]
    return px[..., order]


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool
         ) -> bytes:
    """BmpRleDecoder.decode: the index bytes it hands to the raw decoder,
    file positions counted from the start of the file."""
    out = bytearray()
    x = 0
    dest_length = width * height
    n = len(data)
    while len(out) < dest_length:
        if pos + 2 > n:
            break
        num_pixels, byte = data[pos], data[pos + 1]
        pos += 2
        if num_pixels:
            if x + num_pixels > width:
                num_pixels = max(0, width - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((num_pixels + 1) // 2))[:num_pixels]
            else:
                out += bytes([byte]) * num_pixels
            x += num_pixels
        elif byte == 0:
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise ValueError("BMP RLE delta is cut short")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:
            count = byte // 2 if rle4 else byte
            chunk = data[pos:pos + count]
            pos += len(chunk)
            if rle4:
                out += np.stack([np.frombuffer(chunk, np.uint8) >> 4,
                                 np.frombuffer(chunk, np.uint8) & 15],
                                -1).tobytes()
            else:
                out += chunk
            if len(chunk) < count:
                break
            x += byte
            if pos % 2:
                pos += 1
    return bytes(out)


def decode_bmp(data: bytes, mode: Optional[str] = None) -> np.ndarray:
    """BMP or DIB bytes -> uint8 (H, W, 3) for mode "RGB", or with no mode
    the array of Pillow's own mode (bool for "1", indices for "P", (H, W) for
    "L", (H, W, 3 or 4) for "RGB" / "RGBA")."""
    if mode not in (None,) + MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    f = _File(data)
    if data[:2] == MAGIC:
        head = f.read(14)
        if len(head) < 14:
            raise ValueError("BMP file header is cut short")
        info = _header(f, _u32(head, 10))
    elif is_dib(data):
        info = _header(f, 0)
    else:
        raise ValueError("neither a BMP nor a DIB file")
    width, height, own, raw_mode, decoder, offset, extra, direction, \
        palette = info
    if width == 0 or height == 0:
        raise ValueError("BMP image has no pixels")
    if decoder == "rle":
        if own == "1":
            raise ValueError("BMP RLE data cannot fill a 1-bit image")
        idx = _rle(data, offset, width, height, extra)
        if len(idx) < width * height:
            raise ValueError("BMP RLE data ends before the image is full")
        pix = np.frombuffer(idx[:width * height], np.uint8).reshape(
            height, width)
    else:
        bits = _RAW_BITS.get(raw_mode, 32)
        line = (width * bits + 7) // 8
        channels = {"RGB": 3, "RGBA": 4}.get(own)
        shape = (height, width) + ((channels,) if channels else ())
        pix = np.zeros(shape, np.uint8)
        if extra >= line:
            body = data[offset:] if offset < len(data) else b""
            rows = (len(body) - line) // extra + 1 if len(body) >= line else 0
            rows = min(rows, height)
            if rows:
                buf = np.frombuffer(body[:(rows - 1) * extra + line].ljust(
                    rows * extra, b"\0"), np.uint8).reshape(rows, extra)
                got = _unpack(buf, raw_mode, width)
                if direction < 0:
                    pix[height - rows:] = got[::-1]
                else:
                    pix[:rows] = got
    if decoder == "rle" and direction < 0:
        pix = pix[::-1]
    if mode is None:
        return pix.astype(bool) if own == "1" else np.ascontiguousarray(pix)
    if own in ("1", "L"):
        return np.repeat(pix[..., None], 3, -1)
    if own == "P":
        table = np.zeros((256, 3), np.uint8)
        n = min(len(palette), 256)
        table[:n] = palette[:n]
        return table[pix]
    return np.ascontiguousarray(pix[..., :3])
