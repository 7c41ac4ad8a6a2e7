"""Write the JPEG fixtures of the port's decoder and the hashes Pillow gives.

    python tools/make_jpeg_fixtures.py [--out tests/data/jpeg] [--check]

Needs Pillow (the machine with the card has none, so it compares its
decoder against the hashes written here). Every file is made from seeded
numpy pixels and encoded by Pillow; the variants Pillow cannot write are
made by editing the markers of a file it wrote:

  * 4:4:0 (Y sampled 1x2): a 4:2:2 file's SOF with the sampling factors
    swapped and the width and height exchanged; the MCU count is the same,
    so the scan decodes as a valid (if scrambled) 4:4:0 image;
  * YCCK: a CMYK file's Adobe transform set to 2;
  * RGB: a 4:4:4 file with its JFIF segment replaced by an Adobe segment of
    transform 0 (the samples are then read as R, G, B);
  * CMYK without an Adobe segment;
  * truncated streams: a file cut part-way through its entropy-coded data
    (Pillow ends it with EOI; the missing blocks read 128).

`expected.json` holds each file's shape and the sha256 of
`Image.open(f).convert("RGB")`'s pixels with `LOAD_TRUNCATED_IMAGES`, and
the Pillow and libjpeg versions. `--check` rewrites nothing and fails if
the files or the hashes differ from what this script makes.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys
from typing import Dict

import numpy as np
import PIL
from PIL import Image, ImageFile, features

ImageFile.LOAD_TRUNCATED_IMAGES = True

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests",
                   "data", "jpeg")


def photo(w: int, h: int, seed: int) -> np.ndarray:
    """A photo-like RGB image: smooth gradients, discs and fine texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x / max(w - 1, 1) * 200 + 30,
                    y / max(h - 1, 1) * 180 + 40,
                    (x + y) / max(w + h - 2, 1) * 150 + 60], -1)
    for _ in range(12):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(0.05, 0.3) * min(w, h) + 1
        inside = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        img[inside] = rng.uniform(0, 255, 3)
    img += 12 * np.sin(x / 3.0 + rng.uniform(0, 6))[..., None]
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def save(arr: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def segments(data: bytes):
    """(offset, marker, length incl. marker) of the header segments up to
    and including SOS."""
    pos, out = 2, []
    while pos < len(data):
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0] + 2
        out.append((pos, marker, length))
        if marker == 0xDA:
            return out
        pos += length
    raise ValueError("no SOS")


def replace_segment(data: bytes, marker: int, new: bytes) -> bytes:
    for pos, m, length in segments(data):
        if m == marker:
            return data[:pos] + new + data[pos + length:]
    raise ValueError(f"no marker {marker:#x}")


def drop_segment(data: bytes, marker: int) -> bytes:
    return replace_segment(data, marker, b"")


def adobe(transform: int) -> bytes:
    body = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)
    return b"\xff\xee" + struct.pack(">H", len(body) + 2) + body


def as_440(data: bytes) -> bytes:
    """4:2:2 file -> the same scan read as 4:4:0 (see the module note)."""
    for pos, m, length in segments(data):
        if m == 0xC0:
            sof = bytearray(data[pos:pos + length])
            h, w = struct.unpack(">HH", sof[5:9])
            sof[5:9] = struct.pack(">HH", w, h)
            assert sof[11] == 0x21, hex(sof[11])
            sof[11] = 0x12
            return data[:pos] + bytes(sof) + data[pos + length:]
    raise ValueError("no SOF0")


def with_adobe_transform(data: bytes, transform: int) -> bytes:
    return replace_segment(data, 0xEE, adobe(transform))


def cut(data: bytes, fraction: float) -> bytes:
    """The first `fraction` of the entropy-coded data of the first scan."""
    sos = segments(data)[-1]
    start = sos[0] + sos[2]
    return data[:start + int((len(data) - start) * fraction)]


def last_scan_cut(data: bytes, fraction: float) -> bytes:
    """A progressive file cut part-way through its last scan."""
    last = data.rfind(b"\xff\xda")
    length = struct.unpack(">H", data[last + 2:last + 4])[0]
    start = last + 2 + length
    return data[:start + int((len(data) - 2 - start) * fraction)]


def fixtures() -> Dict[str, bytes]:
    big = photo(640, 480, 0)
    small = photo(64, 48, 1)
    odd = photo(17, 9, 2)
    f = {
        "photo_640x480_q90_420.jpg": save(big, quality=90, subsampling=2),
        "photo_640x480_progressive.jpg": save(photo(640, 480, 3), quality=85,
                                              subsampling=2,
                                              progressive=True),
        "grey_33x31.jpg": save(photo(33, 31, 4), "L", quality=80),
        "grey_progressive_40x24.jpg": save(photo(40, 24, 5), "L",
                                           quality=75, progressive=True),
        "ycc444_64x48.jpg": save(small, quality=92, subsampling=0),
        "ycc422_64x48.jpg": save(small, quality=75, subsampling=1),
        "ycc420_64x48_q50.jpg": save(small, quality=50, subsampling=2),
        "ycc440_48x64.jpg": as_440(save(small, quality=80, subsampling=1)),
        "restart_100x75_420.jpg": save(photo(100, 75, 6), quality=80,
                                       subsampling=2,
                                       restart_marker_blocks=3),
        "restart_rows_progressive_70x50.jpg": save(
            photo(70, 50, 7), quality=80, subsampling=2, progressive=True,
            restart_marker_rows=1),
        "odd_1x1.jpg": save(photo(1, 1, 8), quality=90, subsampling=2),
        "odd_2x3_420.jpg": save(photo(2, 3, 9), quality=90, subsampling=2),
        "odd_17x9_420.jpg": save(odd, quality=90, subsampling=2),
        "odd_17x9_422.jpg": save(odd, quality=90, subsampling=1),
        "odd_17x9_444.jpg": save(odd, quality=90, subsampling=0),
        "cmyk_adobe_40x30.jpg": save(photo(40, 30, 10), "CMYK", quality=85),
        "cmyk_plain_40x30.jpg": drop_segment(
            save(photo(40, 30, 11), "CMYK", quality=85), 0xEE),
        "ycck_40x30.jpg": with_adobe_transform(
            save(photo(40, 30, 12), "CMYK", quality=85), 2),
        "adobe_rgb_40x30.jpg": replace_segment(
            save(photo(40, 30, 13), quality=85, subsampling=0), 0xE0,
            adobe(0)),
        "truncated_640x480.jpg": cut(save(photo(640, 480, 14), quality=90,
                                          subsampling=2), 0.55),
        "truncated_restart_100x75.jpg": cut(
            save(photo(100, 75, 15), quality=85, subsampling=2,
                 restart_marker_blocks=2), 0.6),
        "truncated_progressive_last_scan_64x48.jpg": last_scan_cut(
            save(photo(64, 48, 16), quality=85, subsampling=2,
                 progressive=True), 0.5),
    }
    return f


def pil_pixels(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def expected(files: Dict[str, bytes]) -> dict:
    out = {"pillow": PIL.__version__, "libjpeg": features.version("jpg"),
           "libjpeg_turbo": features.version_feature("libjpeg_turbo"),
           "files": {}}
    for name, data in sorted(files.items()):
        px = pil_pixels(data)
        out["files"][name] = {"shape": list(px.shape),
                              "sha256": hashlib.sha256(px.tobytes())
                              .hexdigest()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    files = fixtures()
    exp = expected(files)
    if args.check:
        bad = [n for n, d in files.items()
               if open(os.path.join(args.out, n), "rb").read() != d]
        with open(os.path.join(args.out, "expected.json")) as f:
            if json.load(f)["files"] != exp["files"]:
                bad.append("expected.json")
        print("differ:", bad or "none")
        return 1 if bad else 0
    os.makedirs(args.out, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
    with open(os.path.join(args.out, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(map(len, files.values()))
    print(f"wrote {len(files)} files, {total} bytes, to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
