"""The port's PNG reader (prismer_tpu_torch.data.png) against Pillow bit for
bit on every PNG kind.

The fixtures (tests/data/png, written by tools/make_png_fixtures.py) cover
each colour type at each bit depth the standard allows, with and without
Adam7 interlace, palettes with tRNS and with indices past a short PLTE, and
16-bit grey values past 255. Each must decode to Pillow's
`Image.open(f).convert("L")`, `convert("RGB")` and own-mode pixels;
`expected.json`, which the machine with the card (no Pillow) checks its
decodes against, must hold Pillow's own hashes.
"""

import hashlib
import io
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from prismer_tpu_torch.data import png

FIXTURES = Path(__file__).resolve().parent / "data" / "png"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())["files"]


def pil_pixels(data: bytes, mode):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # a palette's tRNS bytes dropped
        im = Image.open(io.BytesIO(data))
        return np.asarray(im if mode is None else im.convert(mode))


def test_fixture_set_is_complete_and_small():
    files = sorted(p.name for p in FIXTURES.glob("*.png"))
    assert files == sorted(EXPECTED)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 64 << 10
    kinds = {e["pil_mode"] for e in EXPECTED.values()}
    assert kinds == {"1", "L", "I;16", "RGB", "RGBA", "P", "LA"}
    assert sum(n.endswith("_adam7.png") for n in files) == len(files) // 2
    big = [n for n in files if n.startswith("grey16")
           and int(pil_pixels((FIXTURES / n).read_bytes(), None).max()) > 255]
    assert big


@pytest.mark.parametrize("mode", ["L", "RGB", None])
@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_equals_pil_and_expected_hash(name, mode):
    data = (FIXTURES / name).read_bytes()
    want = pil_pixels(data, mode)
    got = png.decode_png(data, mode)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    entry = EXPECTED[name]["own" if mode is None else mode]
    assert entry["shape"] == list(want.shape)
    assert entry["dtype"] == str(want.dtype)
    if got.dtype == np.bool_:           # hashed as 0 / 1 bytes
        got = got.astype(np.uint8)
    assert entry["sha256"] == hashlib.sha256(
        np.ascontiguousarray(got).tobytes()).hexdigest()


def test_read_png_takes_the_mode(tmp_path):
    name = next(n for n in sorted(EXPECTED) if n.startswith("pal4_"))
    (tmp_path / "x.png").write_bytes((FIXTURES / name).read_bytes())
    for mode in ("L", "RGB"):
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "x.png"),
                                                   mode),
                                      pil_pixels((FIXTURES / name)
                                                 .read_bytes(), mode))
    with pytest.raises(ValueError, match="mode 'RGBA'"):
        png.read_png(str(tmp_path / "x.png"), "RGBA")
