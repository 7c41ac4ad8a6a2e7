"""The port's JPEG decoder (prismer_tpu_torch.native, C++ built with g++)
against Pillow's `Image.open(f).convert("RGB")` bit for bit, with
`ImageFile.LOAD_TRUNCATED_IMAGES = True` as the JAX package's label reader
sets it.

Every committed fixture (tests/data/jpeg, written by
tools/make_jpeg_fixtures.py: Huffman, arithmetic-coded, lossless and cut
progressive files) and a parametrised set that Pillow encodes here
(quality 50 / 75 / 95 x subsampling 4:4:4 / 4:2:2 / 4:2:0 x baseline /
progressive, with restart markers) must decode to Pillow's pixels;
`expected.json`, which the machine with the card (no Pillow) checks its
decodes against, must hold Pillow's own hashes. Streams the decoder refuses
or finds corrupt raise `ValueError`. tests/test_torch_jpeg_kinds.py holds
the arithmetic, lossless and smoothing cases made at test time.
"""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from prismer_tpu_torch import native

ImageFile.LOAD_TRUNCATED_IMAGES = True

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())["files"]


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def photo(w: int, h: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1),
                    (x * 7 + y * 3) % 256.0], -1)
    img += rng.normal(0, 25, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(arr, mode="RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def test_fixture_set_is_complete_and_small():
    files = sorted(p.name for p in FIXTURES.glob("*.jpg"))
    assert files == sorted(EXPECTED)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1 << 20
    big = [n for n, e in EXPECTED.items() if e["shape"] == [480, 640, 3]]
    assert len(big) >= 2


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_equals_pil_and_expected_hash(name):
    data = (FIXTURES / name).read_bytes()
    want = pil_rgb(data)
    assert list(want.shape) == EXPECTED[name]["shape"]
    assert hashlib.sha256(want.tobytes()).hexdigest() == \
        EXPECTED[name]["sha256"], "expected.json is not Pillow's hash"
    assert native.decode_jpeg_shape(data) == want.shape[:2]
    np.testing.assert_array_equal(native.decode_jpeg(data), want)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_pil_encoded_equals_pil(quality, subsampling, progressive):
    arr = photo(61, 45, quality * 10 + subsampling)
    # Pillow cannot write restart markers into every progressive file;
    # restarts every row of MCUs do
    kw = ({"restart_marker_rows": 1} if progressive
          else {"restart_marker_blocks": 3})
    data = encode(arr, quality=quality, subsampling=subsampling,
                  progressive=progressive, **kw)
    assert b"\xff\xdd" in data
    np.testing.assert_array_equal(native.decode_jpeg(data), pil_rgb(data))


@pytest.mark.parametrize("mode", ["L", "CMYK"])
@pytest.mark.parametrize("size", [(1, 1), (2, 2), (3, 5), (17, 9), (40, 23)])
def test_grey_cmyk_and_odd_sizes_equal_pil(mode, size):
    for progressive in (False, True):
        data = encode(photo(*size, seed=size[0]), mode, quality=85,
                      progressive=progressive)
        np.testing.assert_array_equal(native.decode_jpeg(data),
                                      pil_rgb(data))


@pytest.mark.parametrize("fraction", [0.2, 0.5, 0.9])
def test_truncated_equals_pil(fraction):
    data = encode(photo(96, 64, 3), quality=90, subsampling=2,
                  restart_marker_blocks=5)
    cut = data[:int(len(data) * fraction)]
    want = pil_rgb(cut)
    np.testing.assert_array_equal(native.decode_jpeg(cut), want)


def test_corrupt_and_refused_streams_raise():
    data = encode(photo(16, 16, 4), quality=80)
    with pytest.raises(ValueError, match="not a JPEG"):
        native.decode_jpeg(b"\x89PNG\r\n\x1a\n" + data)
    with pytest.raises(ValueError, match="hierarchical"):
        native.decode_jpeg(data.replace(b"\xff\xc0", b"\xff\xc5", 1))
    sof = data.index(b"\xff\xc0")
    twelve = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        native.decode_jpeg(twelve)
    sos = data.index(b"\xff\xda")
    table2 = data[:sos + 6] + b"\x22" + data[sos + 7:]   # Y's tables 2 / 2
    with pytest.raises(ValueError, match="Huffman table 2"):
        native.decode_jpeg(table2)
    with pytest.raises(ValueError):
        native.decode_jpeg(data[:sof + 6])       # cut inside the SOF


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_undefined_tables_default_to_the_standard_ones(mode):
    """A baseline file without DHT segments (Motion-JPEG frames) decodes
    with Annex K.3's tables, as libjpeg-turbo substitutes them; Pillow
    writes exactly those tables, so dropping its DHT segments keeps the
    stream valid."""
    data = encode(photo(40, 24, 6), mode, quality=80, subsampling=2)
    while b"\xff\xc4" in data[:data.index(b"\xff\xda")]:
        at = data.index(b"\xff\xc4")
        length = int.from_bytes(data[at + 2:at + 4], "big")
        data = data[:at] + data[at + 2 + length:]
    np.testing.assert_array_equal(native.decode_jpeg(data), pil_rgb(data))


def test_progressive_cut_before_its_last_scans_is_refused():
    """A progressive stream cut before its last scans is refused only where
    Pillow refuses it: inside the segments up to its first scan. Cut in a
    later scan, libjpeg smooths the blocks whose first AC coefficients are
    incomplete, and the port decodes it to Pillow's pixels."""
    data = encode(photo(48, 40, 5), quality=85, progressive=True)
    first_scan = data.index(b"\xff\xda")
    second_scan = data.index(b"\xff\xda", first_scan + 2)
    with pytest.raises(ValueError, match="truncated inside a marker"):
        native.decode_jpeg(data[:first_scan + 6])
    with pytest.raises(OSError):
        pil_rgb(data[:first_scan + 6])
    cut = data[:second_scan + 40]
    np.testing.assert_array_equal(native.decode_jpeg(cut), pil_rgb(cut))


def test_build_is_keyed_by_the_source():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert native.build() == path and path.exists()
