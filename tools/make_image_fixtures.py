"""Write the WebP, GIF and BMP fixtures of the port's image readers and the
hashes Pillow gives for them.

    python tools/make_image_fixtures.py [--out tests/data] [--check]

Needs Pillow (the machine with the card has none, so it compares its
readers against the hashes written here). Files go to <out>/webp, <out>/gif
and <out>/bmp, each with an `expected.json` that holds, per file, Pillow's
`convert("RGB")` shape and sha256, its own mode and that mode's shape and
sha256 (`np.asarray(Image.open(f))`, mode "1" hashed as 0 / 1 bytes), with
`ImageFile.LOAD_TRUNCATED_IMAGES` set, and the Pillow (and libwebp)
version. Every file must open under
Pillow; the tool asserts it. `--check` rewrites nothing and fails if the
files or the hashes differ from what this script makes.

What Pillow writes: WebP lossy at several qualities and methods, lossless,
lossy and lossless alpha, animations; GIF with and without interlace and
transparency; BMP in modes 1, L, P and RGB. What it cannot write is built
here:

  * VP8 files whose first partition is re-encoded with a boolean encoder
    (`vp8_rewrite`): the simple loop filter, sharpness 1-7, loop-filter
    deltas by reference frame and mode, per-segment filter levels, and the
    token partition split by macroblock rows into 2, 4 or 8 partitions;
  * WebP containers with a raw (uncompressed) ALPH chunk under each of the
    four filters, with a VP8L-compressed ALPH (a lossless stream's data
    past its 5-byte header), and an animation whose first frame sits at an
    offset on the canvas;
  * GIFs from a small LZW writer (`lzw_codes`): minimum code sizes 2-8,
    clear codes mid-stream, local colour tables, a first frame offset into
    the screen or reaching past it, a transparency index, indices past a
    short colour table, an early end code, GIF87a, extensions and stray
    bytes between blocks, a file cut inside its image data;
  * BMPs written byte by byte (`bmp_file`): 4-bit, RLE4 and RLE8 with
    absolute runs and deltas, 16-bit 5-5-5 and BI_BITFIELDS 5-6-5, 32-bit
    with each of Pillow's bitfield layouts, top-down rows, OS/2 core,
    v2-v5 headers, a bare DIB, a grey palette that opens as "L", a cut file.

One 640 x 480 file of each kind (WebP lossy, WebP lossless, GIF, BMP) is
made from tests/data/jpeg/photo_640x480_q90_420.jpg for timing; the
lossless WebP, the GIF and the BMP from the photo reduced to 16 colours, to
keep the fixtures small.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import re
import struct
import sys
from typing import Dict, List, Tuple

import numpy as np
import PIL
from PIL import Image, ImageFile, features

ImageFile.LOAD_TRUNCATED_IMAGES = True

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "data")
PHOTO = os.path.join(ROOT, "tests", "data", "jpeg",
                     "photo_640x480_q90_420.jpg")
WEBP_SOURCE = os.path.join(ROOT, "prismer_tpu_torch", "native", "webp.cpp")


def photo(w: int, h: int, seed: int) -> np.ndarray:
    """A photo-like RGB image: gradients, discs and fine texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x / max(w - 1, 1) * 200 + 30,
                    y / max(h - 1, 1) * 180 + 40,
                    (x + y) / max(w + h - 2, 1) * 150 + 60], -1)
    for _ in range(8):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(0.05, 0.3) * min(w, h) + 1
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += 12 * np.sin(x / 3.0 + rng.uniform(0, 6))[..., None]
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def big_photo() -> np.ndarray:
    with Image.open(PHOTO) as im:
        return np.asarray(im.convert("RGB"))


def pil_save(arr: np.ndarray, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **kw)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# VP8: a boolean decoder that records every (probability, bit) it reads, a
# boolean encoder (RFC 6386 section 7), and a parse of a key frame's first
# partition and tokens, to write the frame again with other header fields.

def _c_table(name: str) -> List[int]:
    """A uint8 table of the port's webp.cpp, read from its source."""
    src = open(WEBP_SOURCE).read()
    m = re.search(name + r"\[\d+\] = \{([^}]*)\}", src)
    return [int(v) for v in re.findall(r"\d+", m.group(1))]


class BoolDecoder:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.value = (self._byte() << 8) | self._byte()
        self.range, self.bit_count = 255, 0
        self.log: List[Tuple[int, int]] = []

    def _byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        bigsplit = split << 8
        if self.value >= bigsplit:
            out, self.range, self.value = 1, self.range - split, \
                self.value - bigsplit
        else:
            out, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                self.value |= self._byte()
        self.log.append((prob, out))
        return out

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v


class BoolEncoder:
    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def bit(self, prob: int, b: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if b:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if self.bit_count == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bit(128, (v >> i) & 1)

    def signed(self, v: int, n: int):
        self.literal(abs(v), n)
        self.bit(128, v < 0)

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


_ZIGZAG_BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]
_B_TREE = [0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9]


def _parse_header(br: BoolDecoder) -> dict:
    h = {"color_space": br.literal(1), "clamp": br.literal(1)}
    seg = h["segment"] = {"enabled": br.literal(1)}
    if seg["enabled"]:
        seg["update_map"] = br.literal(1)
        seg["update_data"] = br.literal(1)
        if seg["update_data"]:
            seg["absolute"] = br.literal(1)
            seg["quant"] = [br.signed(7) if br.literal(1) else None
                            for _ in range(4)]
            seg["filter"] = [br.signed(6) if br.literal(1) else None
                             for _ in range(4)]
        if seg["update_map"]:
            seg["probs"] = [br.literal(8) if br.literal(1) else None
                            for _ in range(3)]
    h["simple"] = br.literal(1)
    h["level"] = br.literal(6)
    h["sharpness"] = br.literal(3)
    h["lf_delta"] = None
    if br.literal(1):
        h["lf_delta"] = {"update": br.literal(1)}
        if h["lf_delta"]["update"]:
            h["lf_delta"]["ref"] = [br.signed(6) if br.literal(1) else None
                                    for _ in range(4)]
            h["lf_delta"]["mode"] = [br.signed(6) if br.literal(1) else None
                                     for _ in range(4)]
    h["log2_parts"] = br.literal(2)
    h["q"] = br.literal(7)
    h["dq"] = [br.signed(4) if br.literal(1) else None for _ in range(5)]
    h["refresh"] = br.literal(1)
    return h


def _write_header(bw: BoolEncoder, h: dict):
    def opt(v, n):
        bw.literal(v is not None, 1)
        if v is not None:
            bw.signed(v, n)
    bw.literal(h["color_space"], 1)
    bw.literal(h["clamp"], 1)
    seg = h["segment"]
    bw.literal(seg["enabled"], 1)
    if seg["enabled"]:
        bw.literal(seg["update_map"], 1)
        bw.literal(seg["update_data"], 1)
        if seg["update_data"]:
            bw.literal(seg["absolute"], 1)
            for v in seg["quant"]:
                opt(v, 7)
            for v in seg["filter"]:
                opt(v, 6)
        if seg["update_map"]:
            for v in seg["probs"]:
                bw.literal(v is not None, 1)
                if v is not None:
                    bw.literal(v, 8)
    bw.literal(h["simple"], 1)
    bw.literal(h["level"], 6)
    bw.literal(h["sharpness"], 3)
    bw.literal(h["lf_delta"] is not None, 1)
    if h["lf_delta"] is not None:
        bw.literal(h["lf_delta"]["update"], 1)
        if h["lf_delta"]["update"]:
            for v in h["lf_delta"]["ref"] + h["lf_delta"]["mode"]:
                opt(v, 6)
    bw.literal(h["log2_parts"], 2)
    bw.literal(h["q"], 7)
    for v in h["dq"]:
        opt(v, 4)
    bw.literal(h["refresh"], 1)


def _parse_tokens(br: BoolDecoder, proba, mb_w: int, mb_h: int, mbs):
    """Walk every macroblock's tokens (RFC 6386 section 13) and return the
    (probability, bit) pairs of each macroblock row."""
    cat = [[173, 148, 140], [176, 155, 140, 135], [180, 157, 141, 134, 130],
           [254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129]]

    def coeffs(t, ctx, n):
        p = proba[t][_ZIGZAG_BANDS[n]][ctx]
        while n < 16:
            if not br.bit(p[0]):
                return n
            while not br.bit(p[1]):
                n += 1
                p = proba[t][_ZIGZAG_BANDS[n]][0]
                if n == 16:
                    return 16
            nxt = proba[t][_ZIGZAG_BANDS[n + 1]]
            if not br.bit(p[2]):
                p = nxt[1]
            else:
                if not br.bit(p[3]):
                    if br.bit(p[4]):
                        br.bit(p[5])
                elif not br.bit(p[6]):
                    if not br.bit(p[7]):
                        br.bit(159)
                    else:
                        br.bit(165)
                        br.bit(145)
                else:
                    b1 = br.bit(p[8])
                    b0 = br.bit(p[9 + b1])
                    for prob in cat[2 * b1 + b0]:
                        br.bit(prob)
                p = nxt[2]
            br.bit(128)  # sign
            n += 1
        return 16

    rows = []
    top_nz = [[0] * 9 for _ in range(mb_w)]   # 4 Y, 2 U, 2 V, Y2
    for mb_y in range(mb_h):
        left_nz = [0] * 9
        start = len(br.log)
        for mb_x in range(mb_w):
            i4, skip = mbs[mb_y * mb_w + mb_x]
            top = top_nz[mb_x]
            if skip:
                for k in range(8):
                    top[k] = left_nz[k] = 0
                if not i4:
                    top[8] = left_nz[8] = 0
                continue
            first, t = 0, 3
            if not i4:
                nz = coeffs(1, top[8] + left_nz[8], 0)
                top[8] = left_nz[8] = int(nz > 0)
                first, t = 1, 0
            for y in range(4):
                for x in range(4):
                    nz = coeffs(t, top[x] + left_nz[y], first)
                    top[x] = left_nz[y] = int(nz > first)
            for c0 in (4, 6):
                for y in range(2):
                    for x in range(2):
                        nz = coeffs(2, top[c0 + x] + left_nz[c0 + y], 0)
                        top[c0 + x] = left_nz[c0 + y] = int(nz > 0)
        rows.append(br.log[start:])
    return rows


def vp8_rewrite(vp8: bytes, *, simple=None, sharpness=None, log2_parts=None,
                lf_delta=None, seg_filter=None) -> bytes:
    """A VP8 key frame written again with some first-partition fields
    changed; `log2_parts` splits the tokens into 1 << log2_parts
    partitions by macroblock rows."""
    bits = vp8[0] | (vp8[1] << 8) | (vp8[2] << 16)
    first_size = bits >> 5
    width = struct.unpack("<H", vp8[6:8])[0] & 0x3FFF
    height = struct.unpack("<H", vp8[8:10])[0] & 0x3FFF
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    part0 = vp8[10:10 + first_size]
    rest = vp8[10 + first_size:]
    br = BoolDecoder(part0)
    h = _parse_header(br)
    upd, p0 = _c_table("kCoeffsUpdateProba"), _c_table("kCoeffsProba0")
    proba_log_start = len(br.log)
    flat = [br.literal(8) if br.bit(upd[i]) else p0[i] for i in range(1056)]
    proba = [[[flat[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c) * 11 + 11]
               for c in range(3)] for b in range(8)] for t in range(4)]
    use_skip = br.literal(1)
    skip_p = br.literal(8) if use_skip else None
    proba_log = br.log[proba_log_start:]
    # Macroblock modes: recorded as they are, for writing back.
    bmodes = _c_table("kBModesProba")
    seg = h["segment"]
    seg_probs = [255, 255, 255]
    if seg["enabled"] and seg.get("update_map"):
        seg_probs = [255 if v is None else v for v in seg["probs"]]
    modes_start = len(br.log)
    intra_t = [0] * (4 * mb_w)
    mbs = []
    for _ in range(mb_h):
        intra_l = [0] * 4
        for mb_x in range(mb_w):
            if seg["enabled"] and seg.get("update_map"):
                if not br.bit(seg_probs[0]):
                    br.bit(seg_probs[1])
                else:
                    br.bit(seg_probs[2])
            skip = br.bit(skip_p) if use_skip else 0
            i4 = not br.bit(145)
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            if not i4:
                ymode = (1 if br.bit(128) else 3) if br.bit(156) else \
                    (2 if br.bit(163) else 0)
                top = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        prob = bmodes[(top[x] * 10 + ym) * 9:][:9]
                        i = _B_TREE[br.bit(prob[0])]
                        while i > 0:
                            i = _B_TREE[2 * i + br.bit(prob[i])]
                        ym = top[x] = -i
                    intra_l[y] = ym
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            if br.bit(142) and br.bit(114):
                br.bit(183)
            mbs.append((i4, skip))
    modes_log = br.log[modes_start:]

    if h["log2_parts"] != 0:
        raise ValueError("vp8_rewrite takes a one-partition frame")
    row_logs = _parse_tokens(BoolDecoder(rest), proba, mb_w, mb_h, mbs)

    if simple is not None:
        h["simple"] = simple
    if sharpness is not None:
        h["sharpness"] = sharpness
    if lf_delta is not None:
        h["lf_delta"] = {"update": 1, "ref": list(lf_delta[0]),
                         "mode": list(lf_delta[1])}
    if seg_filter is not None:
        seg.update(update_data=1, absolute=seg.get("absolute", 0),
                   quant=seg.get("quant", [None] * 4), filter=list(seg_filter))
        if not seg["enabled"]:
            seg.update(enabled=1, update_map=0, absolute=1, quant=[h["q"]] * 4)
    if log2_parts is not None:
        h["log2_parts"] = log2_parts
    bw = BoolEncoder()
    _write_header(bw, h)
    for prob, b in proba_log + modes_log:
        bw.bit(prob, b)
    new0 = bw.flush()
    n = 1 << h["log2_parts"]
    encs = [BoolEncoder() for _ in range(n)]
    for mb_y, log in enumerate(row_logs):
        for prob, b in log:
            encs[mb_y % n].bit(prob, b)
    tokens = [e.flush() for e in encs]
    size_bytes = b"".join(struct.pack("<I", len(t))[:3] for t in tokens[:-1])
    tag = (bits & 0x1F) | (len(new0) << 5)
    return (struct.pack("<I", tag)[:3] + vp8[3:10] + new0 + size_bytes +
            b"".join(tokens))


# ---------------------------------------------------------------------------
# RIFF containers.

def riff_chunks(data: bytes) -> List[Tuple[bytes, bytes]]:
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + \
        b"\0" * (len(payload) & 1)


def riff(*chunks_: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks_)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(w: int, h: int, flags: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) +
                 struct.pack("<I", w - 1)[:3] + struct.pack("<I", h - 1)[:3])


def image_chunk(webp: bytes, tag=b"VP8 ") -> bytes:
    for t, payload in riff_chunks(webp):
        if t == tag:
            return payload
    raise ValueError(f"no {tag!r} chunk")


def alpha_filter(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's forward alpha filters (dsp/filters.c): the residuals the
    decoder's unfilters undo."""
    a = alpha.astype(np.int32)
    out = a.copy()
    h, w = a.shape
    for y in range(h):
        for x in range(w):
            if y == 0:
                pred = a[0, x - 1] if x else 0
            elif method == 1:
                pred = a[y, x - 1] if x else a[y - 1, 0]
            elif method == 2:
                pred = a[y - 1, x]
            else:
                if x == 0:
                    pred = a[y - 1, 0]
                else:
                    g = a[y, x - 1] + a[y - 1, x] - a[y - 1, x - 1]
                    pred = min(max(g, 0), 255)
            out[y, x] = (a[y, x] - pred) & 255
    return out.astype(np.uint8)


def alph_compressed(alpha: np.ndarray, method: int) -> bytes:
    """An ALPH payload with VP8L compression: a lossless WebP of the
    filtered plane as green, less its 5-byte VP8L header."""
    f = alpha_filter(alpha, method) if method else alpha
    rgb = np.stack([np.zeros_like(f), f, np.zeros_like(f)], -1)
    vp8l = image_chunk(pil_save(rgb, "WEBP", lossless=True, exact=True),
                       b"VP8L")
    return bytes([1 | (method << 2)]) + vp8l[5:]


def webp_files() -> Dict[str, bytes]:
    rng = np.random.default_rng(23)
    files: Dict[str, bytes] = {}
    small = photo(64, 48, 1)
    odd = photo(37, 29, 2)
    for q, m in ((10, 0), (50, 3), (75, 4), (95, 6)):
        files[f"lossy_q{q}_m{m}_64x48.webp"] = pil_save(small, "WEBP",
                                                          quality=q, method=m)
    files["lossy_q80_37x29.webp"] = pil_save(odd, "WEBP", quality=80)
    files["lossy_1x1.webp"] = pil_save(small[:1, :1], "WEBP", quality=80)
    files["lossless_64x48.webp"] = pil_save(small, "WEBP", lossless=True)
    files["lossless_37x29_m0.webp"] = pil_save(odd, "WEBP", lossless=True,
                                               method=0, quality=0)
    pal = rng.integers(0, 256, (5, 3)).astype(np.uint8)
    files["lossless_palette5_37x29.webp"] = pil_save(
        pal[rng.integers(0, 5, (29, 37))], "WEBP", lossless=True)
    alpha = photo(64, 48, 3)[..., 1]
    rgba = np.dstack([small, alpha])
    files["lossy_alpha_64x48.webp"] = pil_save(rgba, "WEBP", quality=70)
    files["lossy_alpha_q30_aq20_64x48.webp"] = pil_save(
        rgba, "WEBP", quality=30, alpha_quality=20)
    files["lossless_alpha_64x48.webp"] = pil_save(rgba, "WEBP", lossless=True)
    files["lossless_alpha_exact_64x48.webp"] = pil_save(
        rgba, "WEBP", lossless=True, exact=True)
    files["meta_icc_exif_xmp_40x30.webp"] = pil_save(
        odd[:30, :37], "WEBP", quality=80, icc_profile=b"\0" * 128,
        exif=b"Exif\0\0" + bytes(32), xmp=b"<x:xmpmeta/>")
    frames = [Image.fromarray(photo(64, 48, s)) for s in (4, 5, 6)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=80, quality=70)
    files["anim_lossy_64x48.webp"] = buf.getvalue()
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=80, lossless=True)
    files["anim_lossless_64x48.webp"] = buf.getvalue()

    # Two bytes inserted into a frame's token data (the RIFF size kept, so
    # the last two bytes fall past it): coefficients that overflow 16 bits
    # in libwebp's SSE2 inverse transform, which wraps them.
    q75 = files["lossy_q75_m4_64x48.webp"]
    files["vp8_coefficients_past_16_bits_64x48.webp"] = \
        q75[:261] + b"\x7a\xbe" + q75[261:]

    # VP8 files that libwebp's encoder, as Pillow drives it, does not write.
    base = image_chunk(pil_save(photo(96, 80, 7), "WEBP", quality=60,
                                method=4))
    variants = {
        "simple_filter": dict(simple=1),
        "simple_filter_sharp3": dict(simple=1, sharpness=3),
        "sharpness2": dict(sharpness=2),
        "sharpness7": dict(sharpness=7),
        "lf_delta": dict(lf_delta=((5, 0, 0, 0), (-9, 0, 0, 0))),
        "segment_filter": dict(seg_filter=(0, 20, 45, 63)),
        "partitions2": dict(log2_parts=1),
        "partitions4": dict(log2_parts=2),
        "partitions8_sharp5": dict(log2_parts=3, sharpness=5),
    }
    for name, kw in variants.items():
        files[f"vp8_{name}_96x80.webp"] = riff(chunk(b"VP8 ",
                                                     vp8_rewrite(base, **kw)))

    # ALPH chunks built here: raw under each filter, and compressed.
    vp8 = image_chunk(pil_save(small, "WEBP", quality=75))
    for method, name in enumerate(("none", "horizontal", "vertical",
                                   "gradient")):
        raw = bytes([method << 2]) + alpha_filter(alpha, method).tobytes() \
            if method else bytes([0]) + alpha.tobytes()
        files[f"alph_raw_{name}_64x48.webp"] = riff(
            vp8x(64, 48, 0x10), chunk(b"ALPH", raw), chunk(b"VP8 ", vp8))
    raw = bytearray(bytes([0]) + alpha.tobytes())
    raw[101:401] = bytes((i * 7) & 255 for i in range(300))
    files["alph_raw_overwritten_64x48.webp"] = riff(
        vp8x(64, 48, 0x10), chunk(b"ALPH", bytes(raw)), chunk(b"VP8 ", vp8))
    for method, name in ((0, "none"), (3, "gradient")):
        files[f"alph_vp8l_{name}_64x48.webp"] = riff(
            vp8x(64, 48, 0x10), chunk(b"ALPH", alph_compressed(alpha, method)),
            chunk(b"VP8 ", vp8))
    # An ALPH chunk without VP8X's alpha flag: the demuxer drops it.
    files["alph_without_flag_64x48.webp"] = riff(
        vp8x(64, 48, 0), chunk(b"ALPH", bytes([0]) + alpha.tobytes()),
        chunk(b"VP8 ", vp8))
    # An animation whose first frame is 32 x 24 at (16, 10) on 64 x 48.
    sub = image_chunk(pil_save(photo(32, 24, 8), "WEBP", quality=70))
    anmf = struct.pack("<I", 8)[:3] + struct.pack("<I", 5)[:3] + \
        struct.pack("<I", 31)[:3] + struct.pack("<I", 23)[:3] + \
        struct.pack("<I", 100)[:3] + bytes([0])
    files["anim_offset_frame_64x48.webp"] = riff(
        vp8x(64, 48, 0x02), chunk(b"ANIM", bytes(4) + bytes(2)),
        chunk(b"ANMF", anmf + chunk(b"VP8 ", sub)))

    big = big_photo()
    files["photo_640x480_lossy_q80.webp"] = pil_save(big, "WEBP", quality=80)
    files["photo_640x480_lossless_16colours.webp"] = pil_save(
        posterize(big), "WEBP", lossless=True)
    return files


def posterize(rgb: np.ndarray) -> np.ndarray:
    im = Image.fromarray(rgb).quantize(16, dither=Image.Dither.NONE)
    return np.asarray(im.convert("RGB"))


# ---------------------------------------------------------------------------
# GIF: an LZW writer whose code widths follow Pillow's decoder.

def lzw_codes(indices, bits: int, clear_period: int = 0):
    """(code, width) pairs: a clear code, the data, an end code; with
    `clear_period`, a clear code after every that many codes."""
    clear, end = 1 << bits, (1 << bits) + 1
    codes = [(clear, bits + 1)]
    used = 0

    def emit(c):
        nonlocal used
        used += 1
        codes.append((c, min(12, (clear + used).bit_length())))

    def fresh():
        return {(i,): i for i in range(clear)}

    table, w, n_out = fresh(), None, 0
    for k in indices:
        k = int(k)
        if w is not None and w + (k,) in table:
            w = w + (k,)
            continue
        if w is not None:
            emit(table[w])
            if clear + used + 1 < 4096:
                table[w + (k,)] = clear + used + 1
            n_out += 1
            if clear_period and n_out % clear_period == 0:
                emit(clear)
                table, used = fresh(), 0
        w = (k,)
    if w is not None:
        emit(table[w])
    emit(end)
    return codes


def pack_codes(codes) -> bytes:
    acc = n = 0
    out = bytearray()
    for c, s in codes:
        acc |= c << n
        n += s
        while n >= 8:
            out.append(acc & 255)
            acc >>= 8
            n -= 8
    if n:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    out = bytearray()
    for i in range(0, len(data), size):
        out += bytes([len(data[i:i + size])]) + data[i:i + size]
    return bytes(out) + b"\0"


def colour_table(entries) -> Tuple[int, bytes]:
    n = len(entries) // 3
    bits = max(1, (n - 1).bit_length())
    return bits - 1, bytes(entries) + bytes(3 * (1 << bits) - len(entries))


def gif_file(w: int, h: int, frame: dict, gpal=None, version=b"GIF89a",
             bg: int = 0, pre: bytes = b"", codes=None) -> bytes:
    out = bytearray(version + struct.pack("<HH", w, h))
    if gpal is not None:
        size, table = colour_table(gpal)
        out += bytes([0x80 | size, bg, 0]) + table
    else:
        out += bytes([0, bg, 0])
    out += pre
    if frame.get("trns") is not None:
        out += b"\x21\xf9\x04" + bytes([1, 0, 0, frame["trns"], 0])
    idx = frame["idx"]
    fh, fw = idx.shape
    flags = 0x40 if frame.get("interlace") else 0
    table = b""
    if frame.get("lpal") is not None:
        size, table = colour_table(frame["lpal"])
        flags |= 0x80 | size
    out += b"," + struct.pack("<HHHH", frame.get("x", 0), frame.get("y", 0),
                              fw, fh) + bytes([flags]) + table
    rows = idx
    if frame.get("interlace"):
        order = (list(range(0, fh, 8)) + list(range(4, fh, 8)) +
                 list(range(2, fh, 4)) + list(range(1, fh, 2)))
        rows = idx[order]
    bits = frame.get("bits", 8)
    if codes is None:
        codes = lzw_codes(rows.ravel(), bits, frame.get("clear_period", 0))
    out += bytes([bits]) + sub_blocks(pack_codes(codes))
    return bytes(out) + b";"


def gif_files() -> Dict[str, bytes]:
    rng = np.random.default_rng(5)
    files: Dict[str, bytes] = {}
    pal16 = rng.integers(0, 256, 48).tolist()
    idx = rng.integers(0, 16, (29, 37)).astype(np.uint8)
    idx[8:14, 5:30] = 3
    q = Image.fromarray(photo(53, 41, 9)).quantize(64)
    for name, kw in (("pil_p_53x41.gif", {}),
                     ("pil_interlaced_53x41.gif", {"interlace": True}),
                     ("pil_transparency_53x41.gif", {"transparency": 5})):
        buf = io.BytesIO()
        q.save(buf, "GIF", **kw)
        files[name] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(photo(53, 41, 9)[..., 0]).save(buf, "GIF")
    files["pil_l_53x41.gif"] = buf.getvalue()
    for bits in (2, 3, 5, 8):
        files[f"lzw_bits{bits}_37x29.gif"] = gif_file(
            37, 29, dict(idx=idx & ((1 << bits) - 1), bits=bits), pal16)
    files["lzw_clear_codes_37x29.gif"] = gif_file(
        37, 29, dict(idx=idx, bits=4, clear_period=7), pal16)
    files["interlaced_37x29.gif"] = gif_file(
        37, 29, dict(idx=idx, bits=4, interlace=True), pal16)
    files["gif87a_37x29.gif"] = gif_file(37, 29, dict(idx=idx, bits=4),
                                         pal16, version=b"GIF87a")
    files["local_table_37x29.gif"] = gif_file(
        37, 29, dict(idx=idx, bits=4, lpal=pal16[::-1]), pal16)
    files["local_table_no_global_37x29.gif"] = gif_file(
        37, 29, dict(idx=idx, bits=4, lpal=pal16), None)
    files["offset_frame_50x40.gif"] = gif_file(
        50, 40, dict(idx=idx, bits=4, x=6, y=5), pal16, bg=9)
    files["offset_frame_transparency_50x40.gif"] = gif_file(
        50, 40, dict(idx=idx, bits=4, x=6, y=5, trns=7), pal16, bg=9)
    files["frame_past_screen_30x20.gif"] = gif_file(
        30, 20, dict(idx=idx, bits=4, x=4, y=3), pal16)
    files["transparency_37x29.gif"] = gif_file(
        37, 29, dict(idx=idx, bits=4, trns=3), pal16)
    files["short_table_37x29.gif"] = gif_file(
        37, 29, dict(idx=(idx * 15).astype(np.uint8), bits=8), pal16[:12])
    files["no_palette_37x29.gif"] = gif_file(
        37, 29, dict(idx=idx * 16, bits=8), None)
    files["grey_ramp_palette_37x29.gif"] = gif_file(
        37, 29, dict(idx=idx, bits=4),
        [v for i in range(16) for v in (i,) * 3])
    codes = lzw_codes(idx.ravel()[:300], 4)
    files["early_end_code_37x29.gif"] = gif_file(
        37, 29, dict(idx=idx, bits=4), pal16, codes=codes)
    files["extensions_and_junk_37x29.gif"] = gif_file(
        37, 29, dict(idx=idx, bits=4), pal16,
        pre=(b"\x21\xfe" + sub_blocks(b"a comment " * 30) +
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00" + b"\x07\x00"))
    big = rng.integers(0, 4, (120, 160)).astype(np.uint8)
    big[30:90] = 2
    whole = gif_file(160, 120, dict(idx=big, bits=2), pal16[:12])
    files["lzw_table_growth_160x120.gif"] = whole
    files["cut_160x120.gif"] = whole[:len(whole) // 2]
    buf = io.BytesIO()
    Image.fromarray(posterize(big_photo())).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=16).save(buf, "GIF")
    files["photo_640x480_16colours.gif"] = buf.getvalue()
    return files


# ---------------------------------------------------------------------------
# BMP written byte by byte.

def bmp_file(w: int, h: int, bits: int, pixels: bytes, palette=None,
             compression: int = 0, header: int = 40, masks=None,
             topdown: bool = False, dib: bool = False) -> bytes:
    pad = 3 if header == 12 else 4
    pal = b"" if palette is None else b"".join(
        bytes([b, g, r]) + b"\0" * (pad - 3) for r, g, b in palette)
    if header == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hdr = struct.pack("<IiiHHIIiiII", header, w, -h if topdown else h, 1,
                          bits, compression, len(pixels), 2835, 2835,
                          len(palette) if palette else 0, 0)
        extra = struct.pack("<4I", *(list(masks) + [0] * 4)[:4]) \
            if header >= 52 and masks else b""
        hdr += (extra + bytes(header))[:header - 40]
        if header == 40 and masks:
            hdr += struct.pack("<3I", *masks[:3])
    body = hdr + pal
    if dib:
        return body + pixels
    return (b"BM" + struct.pack("<IHHI", 14 + len(body) + len(pixels), 0, 0,
                                14 + len(body)) + body + pixels)


def _rows(rows, bits: int, width: int) -> bytes:
    stride = ((width * bits + 31) >> 3) & ~3
    return b"".join(bytes(r).ljust(stride, b"\0") for r in rows)


def _nibbles(row) -> bytes:
    r = list(row) + [0] * (len(row) % 2)
    return bytes((r[i] << 4) | r[i + 1] for i in range(0, len(r), 2))


def rle8(idx: np.ndarray) -> bytes:
    out = bytearray()
    for y, r in enumerate(idx[::-1]):
        x = 0
        if y == 1:  # an absolute run
            out += bytes([0, len(r)]) + bytes(r) + b"\0" * (len(r) & 1)
            out += b"\0\0"
            continue
        while x < len(r):
            n = 1
            while x + n < len(r) and r[x + n] == r[x] and n < 255:
                n += 1
            out += bytes([n, r[x]])
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def rle4(idx: np.ndarray) -> bytes:
    out = bytearray()
    for y, r in enumerate(idx[::-1]):
        if y == 2:  # an absolute run of an even count
            n = len(r) & ~1
            data = _nibbles(r[:n])
            out += bytes([0, n]) + data + b"\0" * (len(data) & 1)
            if n < len(r):
                out += bytes([1, r[-1] << 4])
        else:
            for x in range(0, len(r), 5):
                seg = r[x:x + 5]
                out += bytes([len(seg), (seg[0] << 4) | seg[1 % len(seg)]])
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_files() -> Dict[str, bytes]:
    rng = np.random.default_rng(7)
    files: Dict[str, bytes] = {}
    W, H = 37, 23
    rgb = photo(W, H, 11)
    idx = rng.integers(0, 16, (H, W)).astype(np.uint8)
    idx[5:12, 3:30] = 6
    pal16 = [tuple(v) for v in rng.integers(0, 256, (16, 3)).tolist()]
    pal256 = [tuple(v) for v in rng.integers(0, 256, (256, 3)).tolist()]
    q = Image.fromarray(rgb).quantize(40)
    for mode, im in (("1", Image.fromarray(rgb[..., 0] > 128)),
                     ("l", Image.fromarray(rgb[..., 1])), ("p", q),
                     ("rgb", Image.fromarray(rgb))):
        buf = io.BytesIO()
        im.save(buf, "BMP")
        files[f"pil_{mode}_{W}x{H}.bmp"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "DIB")
    files[f"pil_dib_rgb_{W}x{H}.dib"] = buf.getvalue()
    bits1 = np.packbits(idx[::-1] & 1, axis=1)
    files[f"bits1_{W}x{H}.bmp"] = bmp_file(W, H, 1, _rows(bits1, 1, W),
                                           pal16[:2])
    px4 = _rows([_nibbles(r) for r in idx[::-1]], 4, W)
    files[f"bits4_{W}x{H}.bmp"] = bmp_file(W, H, 4, px4, pal16)
    files[f"bits4_topdown_{W}x{H}.bmp"] = bmp_file(
        W, H, 4, _rows([_nibbles(r) for r in idx], 4, W), pal16, topdown=True)
    files[f"bits4_os2_{W}x{H}.bmp"] = bmp_file(W, H, 4, px4, pal16, header=12)
    for hs in (52, 56, 64, 108, 124):
        files[f"bits4_header{hs}_{W}x{H}.bmp"] = bmp_file(W, H, 4, px4, pal16,
                                                          header=hs)
    files[f"bits4_grey_ramp_{W}x{H}.bmp"] = bmp_file(
        W, H, 4, px4, [(i, i, i) for i in range(16)])
    files[f"bits4_dib_{W}x{H}.dib"] = bmp_file(W, H, 4, px4, pal16, dib=True)
    idx8 = (idx * 13).astype(np.uint8)
    files[f"bits8_short_palette_{W}x{H}.bmp"] = bmp_file(
        W, H, 8, _rows(idx8[::-1], 8, W), pal256[:100])
    files[f"rle8_{W}x{H}.bmp"] = bmp_file(W, H, 8, rle8(idx8), pal256,
                                          compression=1)
    files[f"rle8_topdown_{W}x{H}.bmp"] = bmp_file(
        W, H, 8, rle8(idx8[::-1]), pal256, compression=1, topdown=True)
    files[f"rle8_delta_{W}x{H}.bmp"] = bmp_file(
        W, H, 8, b"\x04\x09\x00\x02\x00\x00\x03\x01" + rle8(idx8), pal256,
        compression=1)
    files[f"rle4_{W}x{H}.bmp"] = bmp_file(W, H, 4, rle4(idx), pal16,
                                          compression=2)
    v16 = rng.integers(0, 65536, (H, W)).astype("<u2")
    px16 = _rows([r.tobytes() for r in v16[::-1]], 8, 2 * W)
    files[f"bits16_555_{W}x{H}.bmp"] = bmp_file(W, H, 16, px16)
    files[f"bits16_565_bitfields_{W}x{H}.bmp"] = bmp_file(
        W, H, 16, px16, compression=3, masks=(0xF800, 0x7E0, 0x1F))
    files[f"bits16_555_bitfields_v4_{W}x{H}.bmp"] = bmp_file(
        W, H, 16, px16, compression=3, masks=(0x7C00, 0x3E0, 0x1F, 0),
        header=108)
    px24 = _rows([r.tobytes() for r in rgb[::-1, :, ::-1]], 24, W)
    files[f"bits24_{W}x{H}.bmp"] = bmp_file(W, H, 24, px24)
    files[f"bits24_cut_{W}x{H}.bmp"] = bmp_file(W, H, 24, px24)[:-1500]
    v32 = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    px32 = b"".join(r.tobytes() for r in v32[::-1])
    files[f"bits32_bgrx_{W}x{H}.bmp"] = bmp_file(W, H, 32, px32)
    for name, m in (("xbgr", (0xFF000000, 0xFF0000, 0xFF00, 0)),
                    ("abgr", (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
                    ("rgba", (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                    ("bgra", (0xFF0000, 0xFF00, 0xFF, 0xFF000000))):
        files[f"bits32_bitfields_{name}_{W}x{H}.bmp"] = bmp_file(
            W, H, 32, px32, compression=3, masks=m, header=124)
    big = posterize(big_photo())
    pq = Image.fromarray(big).quantize(16, dither=Image.Dither.NONE)
    pidx = np.asarray(pq)
    ppal = [tuple(pq.getpalette()[3 * i:3 * i + 3]) for i in range(16)]
    files["photo_640x480_16colours.bmp"] = bmp_file(
        640, 480, 4, _rows([_nibbles(r) for r in pidx[::-1]], 4, 640), ppal)
    return files


# ---------------------------------------------------------------------------

def mutate(data: bytes, rng: np.random.Generator) -> bytes:
    """`data` with 1-4 random edits of one kind: bytes overwritten, runs of
    1-20 bytes deleted, or runs of 1-8 random bytes inserted."""
    d = bytearray(data)
    op = rng.random()
    for _ in range(int(rng.integers(1, 5))):
        p = int(rng.integers(0, max(len(d), 1)))
        if op < 0.6 and d:
            d[p] = int(rng.integers(0, 256))
        elif op < 0.8:
            del d[p:p + int(rng.integers(1, 21))]
        else:
            d[p:p] = rng.integers(0, 256, int(rng.integers(1, 9)),
                                  dtype=np.uint8).tobytes()
    return bytes(d) or b"x"


def own_bytes(arr: np.ndarray) -> np.ndarray:
    """The array whose bytes `mode_sha256` hashes: Pillow's mode-"1" arrays
    hold True as 0xff, so bool arrays are hashed as 0 / 1."""
    return np.ascontiguousarray(arr.astype(np.uint8) if arr.dtype == bool
                                else arr)


def pil_entry(data: bytes) -> dict:
    """Pillow's view of a file; raises where Pillow cannot open it."""
    with Image.open(io.BytesIO(data)) as im:
        im.load()
        own = own_bytes(np.asarray(im))
        mode = im.mode
        rgb = np.asarray(im.convert("RGB"))
    return {"shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "mode": mode, "mode_shape": list(own.shape),
            "mode_sha256": hashlib.sha256(own.tobytes()).hexdigest()}


def build_all() -> Dict[str, Dict[str, bytes]]:
    return {"webp": webp_files(), "gif": gif_files(), "bmp": bmp_files()}


def expected_for(kind: str, files: Dict[str, bytes]) -> dict:
    out = {"pillow": PIL.__version__, "files": {}}
    if kind == "webp":
        out["libwebp"] = features.version("webp")
    for name, data in sorted(files.items()):
        out["files"][name] = pil_entry(data)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    total, bad = 0, []
    for kind, files in build_all().items():
        d = os.path.join(args.out, kind)
        expected = expected_for(kind, files)
        text = json.dumps(expected, indent=1, sort_keys=True) + "\n"
        total += sum(len(v) for v in files.values())
        if args.check:
            for name, data in files.items():
                p = os.path.join(d, name)
                if not os.path.exists(p) or open(p, "rb").read() != data:
                    bad.append(p)
            p = os.path.join(d, "expected.json")
            if not os.path.exists(p) or open(p).read() != text:
                bad.append(p)
            continue
        os.makedirs(d, exist_ok=True)
        for name, data in files.items():
            with open(os.path.join(d, name), "wb") as f:
                f.write(data)
        with open(os.path.join(d, "expected.json"), "w") as f:
            f.write(text)
    print(f"{total} bytes of fixtures")
    if bad:
        print("differ:", *bad, sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
