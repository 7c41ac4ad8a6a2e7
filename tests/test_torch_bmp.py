"""The port's BMP reader (prismer_tpu_torch.data.bmp, numpy) against Pillow
12's `Image.open(f)` bit for bit, in "RGB" (`convert("RGB")`) and in
Pillow's own mode ("1", "L", "P", "RGB", "RGBA"), with
`ImageFile.LOAD_TRUNCATED_IMAGES = True` as the JAX package sets it.

Every committed fixture (tests/data/bmp, written by
tools/make_image_fixtures.py: Pillow's own files, and files written byte by
byte with 1 / 4 / 8 / 16 / 24 / 32 bits, RLE4 and RLE8 with absolute runs
and deltas, bitfields, top-down rows, OS/2 and v2-v5 headers, a bare DIB,
a grey palette, a cut file) must decode to Pillow's pixels and to
`expected.json`'s hashes. Files that Pillow refuses (BI_JPEG, BI_PNG, 2-bit,
RLE data that ends early, ...) raise ValueError.
"""

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from prismer_tpu_torch.data import bmp

ImageFile.LOAD_TRUNCATED_IMAGES = True

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "bmp"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())["files"]
sys.path.insert(0, str(ROOT / "tools"))
import make_image_fixtures as fx  # noqa: E402


def pil(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        im.load()
        return np.asarray(im.convert("RGB")), im.mode, np.asarray(im)


def sha(arr: np.ndarray) -> str:
    return hashlib.sha256(fx.own_bytes(arr).tobytes()).hexdigest()


def test_fixture_set_is_complete():
    names = sorted(p.name for p in FIXTURES.iterdir()
                   if p.suffix in (".bmp", ".dib"))
    assert names == sorted(EXPECTED)
    for kind in ("bits1", "bits4_", "rle4", "rle8", "bits16_565_bitfields",
                 "bits32_bitfields", "topdown", "os2", "header124", "dib",
                 "grey_ramp", "cut", "photo_640x480"):
        assert any(kind in n for n in EXPECTED), kind


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_equals_pillow(name):
    data = (FIXTURES / name).read_bytes()
    e = EXPECTED[name]
    rgb, mode, own = pil(data)
    got = bmp.decode_bmp(data, "RGB")
    np.testing.assert_array_equal(got, rgb)
    assert list(got.shape) == e["shape"] and sha(got) == e["sha256"]
    got_own = bmp.decode_bmp(data)
    assert got_own.dtype == own.dtype
    np.testing.assert_array_equal(got_own, own)
    assert sha(got_own) == e["mode_sha256"]


@pytest.mark.parametrize("keep", [60, 300, 1000, 2500])
def test_cut_files_equal_pillow(keep):
    """Rows run bottom-up: a cut file keeps the bottom rows; the rest read
    palette entry 0."""
    for name in ("bits4_37x23.bmp", "bits24_37x23.bmp",
                 "bits32_bitfields_bgra_37x23.bmp"):
        data = (FIXTURES / name).read_bytes()[:keep]
        try:
            rgb, _, own = pil(data)
        except Exception:
            with pytest.raises(ValueError):
                bmp.decode_bmp(data, "RGB")
            continue
        np.testing.assert_array_equal(bmp.decode_bmp(data, "RGB"), rgb)
        np.testing.assert_array_equal(bmp.decode_bmp(data), own)


def _with_header_field(name: str, offset: int, fmt: str, value) -> bytes:
    data = bytearray((FIXTURES / name).read_bytes())
    struct.pack_into(fmt, data, 14 + offset, value)
    return bytes(data)


REFUSED = {
    "bi_jpeg": lambda: _with_header_field("bits24_37x23.bmp", 16, "<I", 4),
    "bi_png": lambda: _with_header_field("bits24_37x23.bmp", 16, "<I", 5),
    "two_bits": lambda: _with_header_field("bits4_37x23.bmp", 14, "<H", 2),
    "bitfields_8_bits": lambda: _with_header_field("bits4_37x23.bmp", 16,
                                                   "<I", 3),
    "bitfields_layout": lambda: fx.bmp_file(
        4, 4, 16, bytes(32), compression=3, masks=(0xF00, 0xF0, 0xF)),
    "header_size_20": lambda: _with_header_field("bits24_37x23.bmp", 0,
                                                 "<I", 20),
    "header_cut": lambda: (FIXTURES / "bits24_37x23.bmp").read_bytes()[:30],
    "zero_width": lambda: _with_header_field("bits24_37x23.bmp", 4, "<i", 0),
    "palette_too_large": lambda: _with_header_field("bits4_37x23.bmp", 32,
                                                    "<I", 70000),
    "palette_over_256_entries": lambda: _with_header_field(
        "bits8_short_palette_37x23.bmp", 32, "<I", 300),
    "rle8_cut": lambda: (FIXTURES / "rle8_37x23.bmp").read_bytes()[:-200],
    "rle4_ends_early": lambda: fx.bmp_file(
        8, 8, 4, b"\x08\x12\x00\x00\x00\x01", [(1, 2, 3)] * 16,
        compression=2),
    "rle8_black_and_white": lambda: fx.bmp_file(
        8, 2, 8, b"\x08\x01\x00\x00" * 2 + b"\x00\x01",
        [(0, 0, 0), (255, 255, 255)], compression=1),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_pil_refuses_what_the_port_refuses(case):
    data = REFUSED[case]()
    with pytest.raises(Exception):
        pil(data)
    with pytest.raises(ValueError, match="BMP"):
        bmp.decode_bmp(data, "RGB")


@pytest.mark.parametrize("seed", range(3))
def test_mutated_fixtures_agree_with_pillow(seed):
    """Fixtures with random bytes overwritten, deleted or inserted: where
    Pillow decodes, the port gives its pixels; where it raises, so does the
    port (ValueError); nothing crashes."""
    rng = np.random.default_rng(seed)
    names = sorted(n for n in EXPECTED
                   if (FIXTURES / n).stat().st_size < 60000)
    for _ in range(40):
        data = fx.mutate((FIXTURES / names[rng.integers(len(names))])
                         .read_bytes(), rng)
        try:
            want = pil(data)[0]
        except Exception:
            with pytest.raises(ValueError):
                bmp.decode_bmp(data, "RGB")
            continue
        np.testing.assert_array_equal(bmp.decode_bmp(data, "RGB"), want)
