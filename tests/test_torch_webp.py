"""The port's WebP decoder (prismer_tpu_torch.native.decode_webp, webp.cpp
built with g++) against Pillow 12's `Image.open(f)` bit for bit, in "RGB"
(`convert("RGB")`) and in Pillow's own mode ("RGB" or "RGBA"), with
`ImageFile.LOAD_TRUNCATED_IMAGES = True` as the JAX package sets it.

Every committed fixture (tests/data/webp, written by
tools/make_image_fixtures.py: lossy files at several qualities and methods,
VP8 frames re-encoded with the simple filter, sharpness, loop-filter
deltas, segment levels and 2 / 4 / 8 token partitions, lossless files,
lossy and lossless alpha, raw and compressed ALPH chunks, animations) must
decode to Pillow's pixels and to `expected.json`'s hashes, which the machine
with the card (no Pillow) checks against. Files that Pillow refuses (a cut
file, a broken compressed ALPH, a VP8 inter frame, ...) raise ValueError.
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

from prismer_tpu_torch import native

ImageFile.LOAD_TRUNCATED_IMAGES = True

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "webp"
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
    assert sorted(p.name for p in FIXTURES.glob("*.webp")) == sorted(EXPECTED)
    kinds = {"lossy_", "lossless_", "vp8_simple", "vp8_sharpness",
             "vp8_partitions8", "vp8_lf_delta", "vp8_segment_filter",
             "vp8_coefficients_past_16_bits",
             "lossy_alpha", "lossless_alpha", "alph_raw_", "alph_vp8l_",
             "anim_", "photo_640x480_lossy", "photo_640x480_lossless"}
    for kind in kinds:
        assert any(n.startswith(kind) for n in EXPECTED), kind


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_equals_pillow(name):
    data = (FIXTURES / name).read_bytes()
    e = EXPECTED[name]
    rgb, mode, own = pil(data)
    got = native.decode_webp(data, "RGB")
    np.testing.assert_array_equal(got, rgb)
    assert list(got.shape) == e["shape"] and sha(got) == e["sha256"]
    got_own = native.decode_webp(data)
    np.testing.assert_array_equal(got_own, own)
    assert native.webp_info(data)[2] == mode == e["mode"]
    assert sha(got_own) == e["mode_sha256"]


@pytest.mark.parametrize("seed", range(6))
def test_pillow_encoded_equals_pillow(seed):
    """Random sizes, lossy and lossless, with and without alpha."""
    rng = np.random.default_rng(100 + seed)
    w, h = int(rng.integers(1, 90)), int(rng.integers(1, 70))
    img = fx.photo(w, h, seed)
    if seed % 2:
        img = np.dstack([img, rng.integers(0, 256, (h, w), dtype=np.uint8)])
    kw = ({"lossless": True, "method": int(rng.integers(0, 7)),
           "quality": int(rng.integers(0, 101))} if seed % 3 == 0 else
          {"quality": int(rng.integers(0, 101)),
           "method": int(rng.integers(0, 7))})
    data = fx.pil_save(img, "WEBP", **kw)
    rgb, _, own = pil(data)
    np.testing.assert_array_equal(native.decode_webp(data, "RGB"), rgb)
    np.testing.assert_array_equal(native.decode_webp(data), own)


def test_overwritten_raw_alpha_leaves_rgb_alone():
    """Pillow's RGB does not read the ALPH chunk: the same VP8 frame under
    a raw ALPH chunk with bytes overwritten gives the same RGB."""
    a = (FIXTURES / "alph_raw_none_64x48.webp").read_bytes()
    b = (FIXTURES / "alph_raw_overwritten_64x48.webp").read_bytes()
    np.testing.assert_array_equal(native.decode_webp(a, "RGB"),
                                  native.decode_webp(b, "RGB"))
    assert not np.array_equal(native.decode_webp(a), native.decode_webp(b))


def _rebuild(data: bytes, edit) -> bytes:
    """The file's chunks, each passed through `edit(tag, payload)`."""
    chunks = [fx.chunk(t, p) for t, p in
              (edit(t, p) for t, p in fx.riff_chunks(data)) if t is not None]
    return fx.riff(*chunks)


def _fixture(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


def _cut_alph(tag, payload):
    return tag, payload[:len(payload) // 3] if tag == b"ALPH" else payload


def _inter_frame(tag, payload):
    if tag == b"VP8 ":
        payload = bytes([payload[0] | 1]) + payload[1:]
    return tag, payload


def _vp8l_version(tag, payload):
    if tag == b"VP8L":
        payload = payload[:4] + bytes([payload[4] | 0x20]) + payload[5:]
    return tag, payload


def _small_canvas(tag, payload):
    if tag == b"VP8X":
        payload = payload[:4] + struct.pack("<I", 39)[:3] + payload[7:]
    return tag, payload


def _drop_image(tag, payload):
    return (None, None) if tag in (b"VP8 ", b"ALPH") else (tag, payload)


def _first_partition_too_long(tag, payload):
    if tag == b"VP8 ":
        bits = payload[0] | (payload[1] << 8) | (payload[2] << 16)
        bits = (bits & 0x1F) | ((len(payload)) << 5)
        payload = struct.pack("<I", bits)[:3] + payload[3:]
    return tag, payload


def _bad_alph_method(tag, payload):
    if tag == b"ALPH":
        payload = bytes([payload[0] | 3]) + payload[1:]
    return tag, payload


REFUSED = {
    "cut_lossy": lambda: _fixture("lossy_q75_m4_64x48.webp")[:700],
    "cut_lossless": lambda: _fixture("lossless_64x48.webp")[:-40],
    "cut_one_byte": lambda: _fixture("anim_lossy_64x48.webp")[:-1],
    "cut_in_riff_header": lambda: _fixture("lossy_1x1.webp")[:15],
    "compressed_alph_cut_short": lambda: _rebuild(
        _fixture("alph_vp8l_gradient_64x48.webp"), _cut_alph),
    "alph_bad_method": lambda: _rebuild(
        _fixture("alph_raw_none_64x48.webp"), _bad_alph_method),
    "vp8_inter_frame": lambda: _rebuild(
        _fixture("lossy_q10_m0_64x48.webp"), _inter_frame),
    "vp8_first_partition_past_end": lambda: _rebuild(
        _fixture("lossy_q50_m3_64x48.webp"), _first_partition_too_long),
    "vp8l_version": lambda: _rebuild(_fixture("lossless_64x48.webp"),
                                     _vp8l_version),
    "frame_outside_canvas": lambda: _rebuild(
        _fixture("anim_offset_frame_64x48.webp"), _small_canvas),
    "vp8x_without_image": lambda: _rebuild(
        _fixture("alph_raw_none_64x48.webp"), _drop_image),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_pil_refuses_what_the_port_refuses(case):
    data = REFUSED[case]()
    with pytest.raises(Exception):
        pil(data)
    with pytest.raises(ValueError, match="WebP"):
        native.decode_webp(data, "RGB")


def test_not_a_webp_file_raises():
    with pytest.raises(ValueError, match="RIFF WEBP"):
        native.decode_webp(b"RIFF\x10\0\0\0WAVEfmt " + bytes(16))


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
                native.decode_webp(data, "RGB")
            continue
        np.testing.assert_array_equal(native.decode_webp(data, "RGB"), want)
