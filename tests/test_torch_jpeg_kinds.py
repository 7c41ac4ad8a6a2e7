"""The kinds of JPEG beyond Huffman DCT files: arithmetic coding, lossless
files and the block smoothing of progressive files cut short, in the port's
decoder (prismer_tpu_torch.native) against Pillow's
`Image.open(f).convert("RGB")` with `LOAD_TRUNCATED_IMAGES`, as the JAX
package reads its images.

The arithmetic twins and the lossless encoder come from
tools/make_jpeg_fixtures.py, which tests/test_torch_jpeg.py checks the
committed fixtures against. Here: every twin decodes to its Huffman
source's pixels as far as Pillow decodes it; the numpy SOF3 encoder's files
over predictors, point transforms, restarts, sampling and scans; progressive
files cut at every scan boundary and inside scans; every kind the port still
refuses is one Pillow yields no pixels for; and the port's
`load_expert_labels` equals the JAX package's on the new kinds.
"""

import importlib.util
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from prismer_tpu_torch import native

ImageFile.LOAD_TRUNCATED_IMAGES = True

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "jpeg"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())["files"]
_spec = importlib.util.spec_from_file_location(
    "make_jpeg_fixtures", ROOT / "tools" / "make_jpeg_fixtures.py")
mjf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mjf)


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def fixture(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


def assert_equals_pil(data: bytes) -> None:
    np.testing.assert_array_equal(native.decode_jpeg(data), pil_rgb(data))


def scan_starts(data: bytes):
    starts, at = [], data.find(b"\xff\xda")
    while at >= 0:
        starts.append(at)
        at = data.find(b"\xff\xda", at + 2)
    return starts


TWINS = sorted(n for n, e in EXPECTED.items() if "source" in e)


def test_expected_json_names_every_kind():
    kinds = {e["kind"] for e in EXPECTED.values()}
    assert kinds == {"huffman", "arithmetic", "lossless"}
    assert any(e["smoothed"] for e in EXPECTED.values())
    assert set(TWINS) == set(mjf.TWINS)


@pytest.mark.parametrize("name", TWINS)
def test_arith_twin_decodes_to_its_source(name):
    """A twin holds its source's coefficients. Pillow hands libjpeg the file
    in 64 KiB reads, and libjpeg's arithmetic decoder cannot wait for the
    next: past the first read Pillow keeps the rows it had and the rest stay
    black, which the port follows."""
    twin = fixture(name)
    got = native.decode_jpeg(twin)
    np.testing.assert_array_equal(got, pil_rgb(twin))
    source = pil_rgb(fixture(EXPECTED[name]["source"]))
    if len(twin) <= 65536:
        np.testing.assert_array_equal(got, source)
        return
    same = (got == source).all(axis=(1, 2))
    rows = int(np.argmin(same))
    assert 0 < rows < got.shape[0] and same[:rows].all()
    assert rows % 16 == 14  # 4:2:0: all rows but the last row group
    assert (got[rows:] == 0).all()


@pytest.mark.parametrize("name", ["arith_restart_100x75_420.jpg",
                                  "arith_progressive_dac_restart_70x50.jpg",
                                  "arith_cmyk_40x30.jpg"])
def test_arith_cut_equals_pil(name):
    """Cut inside a scan, a single-scan file keeps the rows libjpeg had
    handed Pillow and a multi-scan one none; cut at a scan boundary, a
    progressive file is smoothed."""
    data = fixture(name)
    for fraction in (0.3, 0.55, 0.8, 0.97):
        assert_equals_pil(data[:int(len(data) * fraction)])
    for start in scan_starts(data)[1:]:
        assert_equals_pil(data[:start])


@pytest.mark.parametrize("pt", [0, 3])
@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("channels", [1, 3])
def test_lossless_encoder_equals_pil(channels, psv, pt):
    img = mjf.photo(23, 17, psv * 10 + pt)
    img = img[..., 0] if channels == 1 else img
    data = mjf.lossless_jpeg(img, psv, pt=pt, restart_rows=2)
    want = pil_rgb(data)
    exact = (img >> pt) << pt
    np.testing.assert_array_equal(
        want, np.repeat(exact[..., None], 3, -1) if channels == 1 else exact)
    np.testing.assert_array_equal(native.decode_jpeg(data), want)


@pytest.mark.parametrize("case", [
    dict(sampling=[(2, 2), (1, 1), (1, 1)]),
    dict(sampling=[(2, 1), (1, 1), (1, 1)], restart_rows=3),
    dict(sampling=[(1, 2), (1, 1), (1, 1)], scans=[(0,), (1, 2)]),
    dict(scans=[(0,), (1,), (2,)], restart_rows=4),
    dict(ids=(1, 2, 3)),
    dict(cmyk=True),
    dict(cmyk=True, markers=mjf.adobe(0)),
], ids=["h2v2", "h2v1_restart", "h1v2_scans", "scans_restart", "ids123",
        "cmyk", "cmyk_adobe0"])
def test_lossless_layouts_equal_pil(case):
    """Subsampled components upsample by box (no "fancy" filter at DCT size
    1); a lossless file without JFIF / Adobe markers is RGB whatever its
    component ids; four components read as Adobe CMYK."""
    img = mjf.photo(29, 21, 3)
    if case.pop("cmyk", False):
        img = np.concatenate([img, img[..., :1]], -1)
    data = mjf.lossless_jpeg(img, 5, pt=1, **case)
    assert_equals_pil(data)
    for fraction in (0.5, 0.9):
        assert_equals_pil(data[:int(len(data) * fraction)])


@pytest.mark.parametrize("mode,subsampling,size", [
    ("RGB", 2, (48, 40)), ("RGB", 1, (17, 9)), ("RGB", 0, (16, 16)),
    ("L", 0, (33, 70)), ("CMYK", 0, (21, 13))])
def test_progressive_cut_at_every_scan_equals_pil(mode, subsampling, size):
    """Block smoothing at every scan boundary and inside every scan: only the
    DC scan (the DC and the first nine AC coefficients estimated from a 5 x 5
    window), AC scans that stop early, rows the last scan did not reach, and
    components two blocks wide."""
    data = mjf.save(mjf.photo(*size, sum(size)), mode, quality=85,
                    subsampling=subsampling, progressive=True)
    starts = scan_starts(data)
    for k, start in enumerate(starts[1:], 1):
        assert_equals_pil(data[:start])
        for fraction in (0.3, 0.7):
            assert_equals_pil(mjf.scan_cut(data, k, fraction))


def _refused():
    base = mjf.save(mjf.photo(16, 16, 4), quality=80)
    sof = base.index(b"\xff\xc0")
    sos = base.index(b"\xff\xda")
    lossless = mjf.lossless_jpeg(mjf.photo(20, 12, 5), 1, restart_rows=2)
    dri = lossless.index(b"\xff\xdd")
    jfif = mjf._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    two = bytearray(base[:sof + 10] + base[sof + 13:])  # drop the third
    two[sof + 3] -= 3
    two[sof + 9] = 2
    frac = bytearray(base)
    frac[sof + 11], frac[sof + 14] = 0x31, 0x21  # Y 3x1, Cb 2x1, Cr 1x1
    return {
        "12-bit": (base[:sof + 4] + b"\x0c" + base[sof + 5:], "12-bit"),
        "hierarchical": (base.replace(b"\xff\xc0", b"\xff\xc5", 1),
                         "hierarchical"),
        "lossless arithmetic": (
            lossless.replace(b"\xff\xc3", b"\xff\xcb", 1), "SOF11"),
        "2 components": (bytes(two), "2 components"),
        "fractional sampling": (bytes(frac), "fractional"),
        "undefined Huffman table 2": (
            base[:sos + 6] + b"\x22" + base[sos + 7:], "Huffman table 2"),
        "lossless YCbCr": (mjf.lossless_jpeg(mjf.photo(20, 12, 5), 1,
                                             markers=jfif), "YCbCr"),
        "lossless restart inside a row": (
            lossless[:dri + 4]
            + (int.from_bytes(lossless[dri + 4:dri + 6], "big") + 1)
            .to_bytes(2, "big") + lossless[dri + 6:], "restart interval"),
        "cut in the header": (base[:sos + 5], "truncated inside a marker"),
    }


REFUSED = _refused()


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_pil_refuses_what_the_port_refuses(kind):
    """Each kind the port refuses makes Pillow raise, and with
    LOAD_TRUNCATED_IMAGES (which hides libjpeg's errors) Pillow either
    raises or returns an image libjpeg wrote no row of (zeros: black)."""
    data, message = REFUSED[kind]
    with pytest.raises(ValueError, match=message):
        native.decode_jpeg(data)
    ImageFile.LOAD_TRUNCATED_IMAGES = False
    try:
        with pytest.raises((OSError, SyntaxError)):
            Image.open(io.BytesIO(data)).load()
    finally:
        ImageFile.LOAD_TRUNCATED_IMAGES = True
    try:
        px = pil_rgb(data)
    except (OSError, SyntaxError):
        return
    assert not px.any()


def test_load_expert_labels_equals_jax(tmp_path):
    from prismer_tpu.data import labels as jax_labels
    from prismer_tpu_torch.data import labels

    names = ["arith_restart_100x75_420.jpg",
             "lossless_rgb_psv4_restart_40x30.jpg",
             "smoothed_mid_scan5_48x40.jpg", "arith_truncated_100x75.jpg"]
    (tmp_path / "coco").mkdir()
    for name in names:
        shutil.copy(FIXTURES / name, tmp_path / "coco" / name)
    for name in names:
        got, _, _ = labels.load_expert_labels(str(tmp_path), str(tmp_path),
                                              name, "coco", "none")
        want, _, _ = jax_labels.load_expert_labels(
            str(tmp_path), str(tmp_path), name, "coco", "none")
        np.testing.assert_array_equal(got, np.asarray(want))
