"""Write the PNG fixtures of the port's decoder and the hashes Pillow gives.

    python tools/make_png_fixtures.py [--out tests/data/png] [--check]

Needs Pillow (the machine with the card has none, so it compares its
decoder against the hashes written here). Pillow writes few of the PNG
kinds, so this script encodes every file itself from seeded numpy samples:
each colour type at each bit depth the standard allows (grey 1, 2, 4, 8
and 16 bits, the 16-bit values past 255; RGB, grey + alpha and RGBA at 8
and 16; palette at 1, 2, 4 and 8 bits, one with tRNS and one whose indices
run past a short PLTE; grey and RGB with tRNS), each plain and Adam7
interlaced, at odd sizes and at two sizes where some Adam7 passes are
empty, the rows cycling through the five filter types.

`expected.json` holds, for each file, the sha256 and shape of Pillow's
`Image.open(f).convert("L")` and `convert("RGB")` pixels and of the file's
own mode (`np.asarray(Image.open(f))`, with its dtype), and the Pillow
version. `--check` rewrites nothing and fails if the files or the hashes
differ from what this script makes.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys
import warnings
import zlib
from typing import Dict, Tuple

import numpy as np
import PIL
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests",
                   "data", "png")
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# name -> (colour type, bit depth, (w, h), extra: "trns" | "short" | None)
KINDS: Dict[str, Tuple[int, int, Tuple[int, int], str]] = {
    "grey1": (0, 1, (37, 23), None),
    "grey2": (0, 2, (29, 17), None),
    "grey4": (0, 4, (21, 13), None),
    "grey8": (0, 8, (19, 11), None),
    "grey8_trns": (0, 8, (9, 7), "trns"),
    "grey16": (0, 16, (17, 9), None),
    "rgb8": (2, 8, (15, 11), None),
    "rgb8_trns": (2, 8, (9, 7), "trns"),
    "rgb16": (2, 16, (13, 7), None),
    "pal1": (3, 1, (33, 19), None),
    "pal2": (3, 2, (27, 15), None),
    "pal4": (3, 4, (23, 13), None),
    "pal8": (3, 8, (19, 11), None),
    "pal8_trns": (3, 8, (17, 9), "trns"),
    "pal4_short": (3, 4, (11, 9), "short"),
    "la8": (4, 8, (15, 9), None),
    "la16": (4, 16, (11, 7), None),
    "rgba8": (6, 8, (13, 9), None),
    "rgba16": (6, 16, (9, 7), None),
    # sizes at which some Adam7 passes are empty
    "rgb8_tiny": (2, 8, (3, 2), None),
    "pal2_tiny": (3, 2, (1, 1), None),
}


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def filter_row(kind: int, row: np.ndarray, prior: np.ndarray,
               bpp: int) -> np.ndarray:
    """PNG row filter (spec section 9) applied to one row of bytes."""
    row, prior = row.astype(np.int64), prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) // 2
    else:
        p = left + prior - upleft
        pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prior, upleft))
    return ((row - pred) % 256).astype(np.uint8)


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, stride) bytes, big-endian, sub-byte
    samples packed from the high bits."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat
    per = 8 // depth
    flat = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % per)))
    flat = flat.reshape(h, -1, per)
    out = np.zeros(flat.shape[:2], np.uint8)
    for i in range(per):
        out |= flat[:, :, i] << (8 - depth * (i + 1))
    return out


def encode(samples: np.ndarray, depth: int, color: int, interlace: int,
           plte: bytes = None, trns: bytes = None) -> bytes:
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data, k = [], 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = pack_rows(sub, depth)
        prior = np.zeros(rows.shape[1], np.uint8)
        for row in rows:
            data.append(bytes([k % 5]) + filter_row(k % 5, row, prior,
                                                    bpp).tobytes())
            prior, k = row, k + 1
    extra = (chunk(b"PLTE", plte) if plte is not None else b"") + (
        chunk(b"tRNS", trns) if trns is not None else b"")
    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, interlace))
            + extra + chunk(b"IDAT", zlib.compress(b"".join(data), 9))
            + chunk(b"IEND", b""))


def samples_of(color: int, depth: int, w: int, h: int, seed: int,
               entries: int) -> np.ndarray:
    """Smooth ramps with some noise, over the whole range of the depth (a
    palette's over `entries` indices)."""
    rng = np.random.default_rng(seed)
    top = entries - 1 if color == 3 else (1 << depth) - 1
    ch = CHANNELS[color]
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([(x / max(w - 1, 1) + c * y / max(h - 1, 1)) % 1.0
                     for c in range(ch)], -1)
    noise = rng.uniform(-0.08, 0.08, base.shape)
    return np.clip(np.rint((base + noise) * top), 0, top).astype(np.int64)


def fixtures() -> Dict[str, bytes]:
    out = {}
    for seed, (name, (color, depth, (w, h), extra)) in enumerate(
            KINDS.items()):
        entries = min(1 << depth, 40) if color == 3 else 0
        plte = trns = None
        if color == 3:
            rng = np.random.default_rng(100 + seed)
            n = entries // 2 if extra == "short" else entries
            plte = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
            if extra == "trns":
                trns = rng.integers(0, 256, n // 2).astype(np.uint8).tobytes()
        elif extra == "trns":
            trns = struct.pack(">" + "H" * CHANNELS[color],
                               *([7] * CHANNELS[color]))
        s = samples_of(color, depth, w, h, seed, entries)
        for interlace in (0, 1):
            tag = "_adam7" if interlace else ""
            out[f"{name}_{w}x{h}{tag}.png"] = encode(s, depth, color,
                                                     interlace, plte, trns)
    return out


def digest_bytes(arr: np.ndarray) -> bytes:
    """The bytes hashed: a bool array's as 0 / 1 (Pillow's "1" images hold
    0 / 255 behind numpy's bool)."""
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    return np.ascontiguousarray(arr).tobytes()


def _digest(arr: np.ndarray) -> dict:
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(digest_bytes(arr)).hexdigest()}


def expected(files: Dict[str, bytes]) -> dict:
    entries = {}
    with warnings.catch_warnings():
        # Pillow warns that a palette's tRNS bytes are dropped by "RGB"
        warnings.simplefilter("ignore")
        for name, data in sorted(files.items()):
            im = Image.open(io.BytesIO(data))
            entries[name] = {
                "pil_mode": im.mode,
                "own": _digest(np.asarray(im)),
                "L": _digest(np.asarray(im.convert("L"))),
                "RGB": _digest(np.asarray(im.convert("RGB"))),
            }
    return {"pillow": PIL.__version__, "files": entries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--check", action="store_true",
                    help="compare with the files on disk; write nothing")
    args = ap.parse_args(argv)
    files = fixtures()
    want = expected(files)
    total = sum(map(len, files.values()))
    if args.check:
        bad = [n for n, d in files.items()
               if not os.path.exists(os.path.join(args.out, n))
               or open(os.path.join(args.out, n), "rb").read() != d]
        with open(os.path.join(args.out, "expected.json")) as f:
            if json.load(f) != want:
                bad.append("expected.json")
        print(f"{len(files)} fixtures, {total} bytes; differ: {bad or 'none'}")
        return 1 if bad else 0
    os.makedirs(args.out, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
    with open(os.path.join(args.out, "expected.json"), "w") as f:
        json.dump(want, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(files)} fixtures ({total} bytes) and expected.json "
          f"to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
