"""Write the JPEG fixtures of the port's decoder and the hashes Pillow gives.

    python tools/make_jpeg_fixtures.py [--out tests/data/jpeg] [--check]

Needs Pillow (the machine with the card has none, so it compares its
decoder against the hashes written here), and for the arithmetic-coded
files `gcc` and the system libjpeg's headers and library. Every file is made
from seeded numpy pixels and encoded by Pillow; the variants Pillow cannot
write are made by editing the markers of a file it wrote:

  * 4:4:0 (Y sampled 1x2): a 4:2:2 file's SOF with the sampling factors
    swapped and the width and height exchanged; the MCU count is the same,
    so the scan decodes as a valid (if scrambled) 4:4:0 image;
  * YCCK: a CMYK file's Adobe transform set to 2;
  * RGB: a 4:4:4 file with its JFIF segment replaced by an Adobe segment of
    transform 0 (the samples are then read as R, G, B);
  * CMYK without an Adobe segment;
  * truncated streams: a file cut part-way through its entropy-coded data
    (Pillow ends it with EOI; the missing blocks read 128);
  * progressive files cut at a scan boundary or inside a scan, which
    libjpeg smooths ("smoothed" in expected.json);

or transcoded or written here:

  * arithmetic-coded twins (SOF9 / SOF10) of Huffman fixtures, with the
    same coefficients, by tools/jpeg_arith_twin.c built against the system
    libjpeg ("source" names the Huffman file). Pillow decodes a twin to its
    source's pixels while the twin's data lies within Pillow's first 64 KiB
    read; libjpeg's arithmetic decoder cannot wait for more, so past that
    (arith_640x480_q90_420.jpg) and in a cut twin the rows not yet handed
    to Pillow stay black;
  * lossless files (SOF3) from `lossless_jpeg`, a numpy encoder.

`expected.json` holds each file's shape, the sha256 of
`Image.open(f).convert("RGB")`'s pixels with `LOAD_TRUNCATED_IMAGES`, its
"kind" (huffman, arithmetic or lossless), "smoothed" and, for a twin,
"source", and the Pillow and libjpeg versions. `--check` rewrites nothing
and fails if the files or the hashes differ from what this script makes.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
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


def scan_cut(data: bytes, scan: int, fraction: float = 0.0) -> bytes:
    """A file cut `fraction` of the way into the entropy-coded data of scan
    `scan` (0-based); fraction 0 cuts just before that scan's SOS."""
    starts, at = [], data.find(b"\xff\xda")
    while at >= 0:
        starts.append(at)
        at = data.find(b"\xff\xda", at + 2)
    if not fraction:
        return data[:starts[scan]]
    at = starts[scan]
    begin = end = at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]
    while not (data[end] == 0xFF and data[end + 1] not in range(0xD0, 0xD8)
               and data[end + 1] != 0):  # the first marker after the data
        end += 1
    return data[:begin + int((end - begin) * fraction)]


class ArithTwin:
    """tools/jpeg_arith_twin.c, built once into a temporary directory."""

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory()
        self.exe = os.path.join(self.dir.name, "jpeg_arith_twin")
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "jpeg_arith_twin.c")
        subprocess.run(["gcc", "-O2", "-o", self.exe, src, "-ljpeg"],
                       check=True)

    def __call__(self, data: bytes, *args: str) -> bytes:
        src = os.path.join(self.dir.name, "in.jpg")
        dst = os.path.join(self.dir.name, "out.jpg")
        with open(src, "wb") as f:
            f.write(data)
        subprocess.run([self.exe, src, dst, *args], check=True)
        with open(dst, "rb") as f:
            return f.read()


# the arithmetic twins: name -> (Huffman source, transcoder arguments)
TWINS = {
    "arith_restart_100x75_420.jpg": ("restart_100x75_420.jpg",
                                     ("restart", "3")),
    "arith_progressive_64x48_q50.jpg": ("ycc420_64x48_q50.jpg",
                                        ("progressive",)),
    "arith_dac_64x48_444.jpg": ("ycc444_64x48.jpg", ("dac", "2", "5", "12")),
    "arith_progressive_dac_restart_70x50.jpg": (
        "restart_rows_progressive_70x50.jpg",
        ("progressive", "restart", "5", "dac", "1", "3", "2")),
    "arith_grey_33x31.jpg": ("grey_33x31.jpg", ()),
    "arith_cmyk_40x30.jpg": ("cmyk_adobe_40x30.jpg", ("restart", "4")),
    "arith_ycck_progressive_40x30.jpg": ("ycck_40x30.jpg", ("progressive",)),
    "arith_640x480_q90_420.jpg": ("photo_640x480_q90_420.jpg", ()),
    "arith_640x480_q85_420.jpg": ("photo_640x480_progressive.jpg", ()),
}


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
    twin = ArithTwin()
    for name, (source, args) in TWINS.items():
        f[name] = twin(f[source], *args)
    f["arith_truncated_100x75.jpg"] = cut(f["arith_restart_100x75_420.jpg"],
                                          0.6)
    f["arith_progressive_cut_70x50.jpg"] = scan_cut(
        f["arith_progressive_dac_restart_70x50.jpg"], 4)
    # smoothed: progressive files cut before their last scans
    prog = save(photo(48, 40, 17), quality=85, subsampling=2,
                progressive=True)
    f.update({
        "smoothed_dc_only_48x40.jpg": scan_cut(prog, 1),
        "smoothed_scan3_48x40.jpg": scan_cut(prog, 3),
        "smoothed_mid_scan5_48x40.jpg": scan_cut(prog, 5, 0.4),
        "smoothed_grey_mid_scan2_40x24.jpg": scan_cut(
            f["grey_progressive_40x24.jpg"], 2, 0.7),
        "smoothed_cmyk_scan2_33x17.jpg": scan_cut(
            save(photo(33, 17, 18), "CMYK", quality=80, progressive=True), 2),
        "smoothed_640x480.jpg": scan_cut(f["photo_640x480_progressive.jpg"],
                                         6),
    })
    lossless = photo(40, 30, 19)
    f.update({
        "lossless_grey_psv1_33x31.jpg": lossless_jpeg(photo(33, 31, 20)[..., 1],
                                                     1),
        "lossless_grey_psv6_pt3_restart_33x31.jpg": lossless_jpeg(
            photo(33, 31, 21)[..., 0], 6, pt=3, restart_rows=4),
        "lossless_rgb_psv4_restart_40x30.jpg": lossless_jpeg(
            lossless, 4, restart_rows=3),
        "lossless_rgb_psv7_pt3_scans_40x30.jpg": lossless_jpeg(
            lossless, 7, pt=3, scans=[(0,), (1,), (2,)]),
    })
    return f


def kind(name: str) -> str:
    if name.startswith("arith_"):
        return "arithmetic"
    return "lossless" if name.startswith("lossless_") else "huffman"


# ---- lossless (SOF3) encoder ------------------------------------------------
# Annex K.3's luminance DC table: categories 0-11 cover every difference of
# 8-bit samples (at most 9 bits, from predictor 4).
STD_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)  # stuffed zero
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:  # pad with one bits
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _predict(s: np.ndarray, y: int, first: bool, psv: int,
             pt: int) -> np.ndarray:
    """T.81 H.1.2.1 predictions of row `y` of samples `s` (already shifted
    by Pt); `first` is the first row of the scan or of a restart interval."""
    row = s[y]
    pred = np.empty_like(row)
    if first:
        pred[0] = 1 << (7 - pt)
        pred[1:] = row[:-1]
        return pred
    up = s[y - 1]
    pred[0] = up[0]
    ra, rb, rc = row[:-1], up[1:], up[:-1]
    pred[1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                7: (ra + rb) >> 1}[psv]
    return pred


def lossless_jpeg(img: np.ndarray, psv: int, pt: int = 0,
                  restart_rows: int = 0, ids=None, sampling=None,
                  markers: bytes = b"", scans=None) -> bytes:
    """A lossless (SOF3, 8-bit, Huffman) JPEG of uint8 `img` (H, W) or
    (H, W, C): predictor `psv` (1-7), point transform `pt`, a restart
    marker every `restart_rows` MCU rows, component `ids` (default 1, or
    'R', 'G', 'B', ...), per-component (h, v) `sampling` (a component
    sampled below the maximum keeps every h-th column and v-th row),
    `markers` (e.g. an Adobe segment) written before the frame, and
    `scans`, tuples of the component indices each scan codes (default one
    interleaved scan of all). The samples past a component's edge inside
    an MCU are coded as zero differences."""
    img = img if img.ndim == 3 else img[..., None]
    height, width, nc = img.shape
    ids = ids or ((1,) if nc == 1 else tuple(b"RGBK"[:nc]))
    sampling = sampling or [(1, 1)] * nc
    scans = scans or [tuple(range(nc))]
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    planes = [img[::vmax // v, ::hmax // h, ci].astype(np.int64) >> pt
              for ci, (h, v) in enumerate(sampling)]
    codes, code, k = {}, 0, 0
    for length, count in enumerate(STD_DC_BITS, 1):
        for _ in range(count):
            codes[k] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    sof = struct.pack(">BHHB", 8, height, width, nc) + b"".join(
        bytes([i, (h << 4) | v, 0]) for i, (h, v) in zip(ids, sampling))
    dht = bytes([0x00]) + bytes(STD_DC_BITS) + bytes(range(12))
    out = (b"\xff\xd8" + markers + _segment(0xC4, dht)
           + _segment(0xC3, sof))
    for comps in scans:
        one = len(comps) == 1
        diffs = []
        for ci in comps:  # the predictor restarts at each MCU row of a reset
            s = planes[ci]
            d = np.empty_like(s)
            rows_per_mcu = 1 if one else sampling[ci][1]
            for y in range(s.shape[0]):
                mcu_row = y // rows_per_mcu
                first = y % rows_per_mcu == 0 and (
                    mcu_row == 0
                    or (restart_rows and mcu_row % restart_rows == 0))
                d[y] = s[y] - _predict(s, y, first, psv, pt)
            diffs.append(((d + 0x8000) & 0xFFFF) - 0x8000)
        bw = _BitWriter()

        def put(diff: int) -> None:
            cat = abs(diff).bit_length()
            bw.put(*codes[cat])
            if cat:
                bw.put(diff if diff > 0 else diff - 1, cat)

        data = bytearray()
        rows = diffs[0].shape[0] if one else mcuy
        for r in range(rows):
            if restart_rows and r and r % restart_rows == 0:
                bw.flush()
                rst = 0xD0 + (r // restart_rows - 1) % 8
                data += bw.out + bytes([0xFF, rst])
                bw.out = bytearray()
            if one:
                for diff in diffs[0][r]:
                    put(int(diff))
                continue
            for mx in range(mcux):
                for d, ci in zip(diffs, comps):
                    h, v = sampling[ci]
                    for yy in range(v):
                        for xx in range(h):
                            y, x = r * v + yy, mx * h + xx
                            inside = y < d.shape[0] and x < d.shape[1]
                            put(int(d[y, x]) if inside else 0)
        bw.flush()
        data += bw.out
        per_row = diffs[0].shape[1] if one else mcux
        if restart_rows:
            out += _segment(0xDD, struct.pack(">H", restart_rows * per_row))
        sos = bytes([len(comps)]) + b"".join(
            bytes([ids[ci], 0]) for ci in comps) + bytes([psv, 0, pt])
        out += _segment(0xDA, sos) + bytes(data)
    return out + b"\xff\xd9"


def pil_pixels(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def expected(files: Dict[str, bytes]) -> dict:
    out = {"pillow": PIL.__version__, "libjpeg": features.version("jpg"),
           "libjpeg_turbo": features.version_feature("libjpeg_turbo"),
           "files": {}}
    for name, data in sorted(files.items()):
        px = pil_pixels(data)
        entry = {"shape": list(px.shape),
                 "sha256": hashlib.sha256(px.tobytes()).hexdigest(),
                 "kind": kind(name),
                 "smoothed": "smoothed" in name or "progressive_cut" in name}
        if name in TWINS:
            entry["source"] = TWINS[name][0]
        out["files"][name] = entry
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
