"""The port's GIF reader (prismer_tpu_torch.native.decode_gif, gif.cpp built
with g++) against Pillow 12's `Image.open(f)` bit for bit: the first frame
in "RGB" (`convert("RGB")`) and in Pillow's own mode ("P" indices, or "L"),
with `ImageFile.LOAD_TRUNCATED_IMAGES = True` as the JAX package sets it.

Every committed fixture (tests/data/gif, written by
tools/make_image_fixtures.py: Pillow's own files and LZW streams written
there with minimum code sizes 2-8, clear codes mid-stream, interlace, local
tables, offset frames with and without transparency, a frame past the
screen, a short colour table, an early end code, a cut file) must decode to
Pillow's pixels and to `expected.json`'s hashes. The frame's outside and
the rows a cut file never reaches hold the transparency index, or 0 (not
the background colour); `convert("RGB")` ignores transparency. Files that
Pillow refuses raise ValueError.
"""

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from prismer_tpu_torch import native

ImageFile.LOAD_TRUNCATED_IMAGES = True

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "gif"
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
    assert sorted(p.name for p in FIXTURES.glob("*.gif")) == sorted(EXPECTED)
    for kind in ("interlaced", "local_table", "offset_frame_transparency",
                 "frame_past_screen", "short_table", "cut_", "lzw_bits2",
                 "lzw_clear_codes", "early_end_code", "photo_640x480"):
        assert any(kind in n for n in EXPECTED), kind


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_equals_pillow(name):
    data = (FIXTURES / name).read_bytes()
    e = EXPECTED[name]
    rgb, mode, own = pil(data)
    got = native.decode_gif(data, "RGB")
    np.testing.assert_array_equal(got, rgb)
    assert list(got.shape) == e["shape"] and sha(got) == e["sha256"]
    got_own = native.decode_gif(data)
    np.testing.assert_array_equal(got_own, own)
    assert native.gif_info(data)[2] == mode == e["mode"]
    assert sha(got_own) == e["mode_sha256"]


def test_outside_the_frame_is_the_transparency_index_or_zero():
    for name, fill in (("offset_frame_50x40.gif", 0),
                       ("offset_frame_transparency_50x40.gif", 7)):
        own = native.decode_gif((FIXTURES / name).read_bytes())
        assert (own[:5] == fill).all() and (own[:, :6] == fill).all()


@pytest.mark.parametrize("frac", [0.2, 0.45, 0.7, 0.95])
def test_cut_files_equal_pillow(frac):
    whole = (FIXTURES / "lzw_table_growth_160x120.gif").read_bytes()
    data = whole[:int(len(whole) * frac)]
    rgb, _, own = pil(data)
    np.testing.assert_array_equal(native.decode_gif(data, "RGB"), rgb)
    np.testing.assert_array_equal(native.decode_gif(data), own)


@pytest.mark.parametrize("seed", range(4))
def test_random_streams_equal_pillow(seed):
    """LZW streams of random sizes, code sizes, clear periods and blocks."""
    rng = np.random.default_rng(200 + seed)
    bits = int(rng.integers(2, 9))
    h, w = int(rng.integers(1, 60)), int(rng.integers(1, 80))
    idx = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
    idx[:, : w // 2] = idx[0, 0]
    pal = rng.integers(0, 256, 3 * int(rng.integers(1, 1 << bits))).tolist()
    data = fx.gif_file(w + 3, h + 2, dict(idx=idx, bits=bits, x=2, y=1,
                                          clear_period=int(rng.integers(0, 9)),
                                          interlace=bool(seed % 2)), pal)
    rgb, _, own = pil(data)
    np.testing.assert_array_equal(native.decode_gif(data, "RGB"), rgb)
    np.testing.assert_array_equal(native.decode_gif(data), own)


def _fixture(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


REFUSED = {
    "no_image": lambda: _fixture("gif87a_37x29.gif")[:13 + 48] + b";",
    "header_only": lambda: _fixture("gif87a_37x29.gif")[:13 + 48],
    "descriptor_cut": lambda: _fixture("gif87a_37x29.gif")[:13 + 48 + 5],
    "code_size_missing": lambda: _fixture("gif87a_37x29.gif")[:13 + 48 + 10],
    "zero_height_frame": lambda: fx.gif_file(
        20, 20, dict(idx=np.zeros((0, 5), np.uint8), bits=2, x=3)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_pil_refuses_what_the_port_refuses(case):
    data = REFUSED[case]()
    with pytest.raises(Exception):
        pil(data)
    with pytest.raises(ValueError, match="GIF"):
        native.decode_gif(data, "RGB")


def test_not_a_gif_raises():
    with pytest.raises(ValueError, match="GIF87a"):
        native.decode_gif(b"GIF90a" + bytes(20))


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
                native.decode_gif(data, "RGB")
            continue
        np.testing.assert_array_equal(native.decode_gif(data, "RGB"), want)
