"""The slice against the JAX package: WebP, GIF and BMP files saved under
`.jpg` names, as web-scraped caption corpora hold them, open in the port as
Pillow opens them in the JAX package, by their first bytes.

On a tiny dataset tree (one WebP, one GIF, one BMP, one bare DIB and a
JPEG, all named `.jpg`, beside expert label PNGs), the port's
`load_expert_labels` gives the images and label arrays that
`prismer_tpu.data.labels.load_expert_labels` gives (through `np.asarray`),
and the port's generator input, `list_images` + `read_rgb`, gives what the
JAX generator's `list_images` + `Image.open(p).convert("RGB")` gives.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from prismer_tpu_torch.data import labels
from prismer_tpu_torch.experts import generate

ImageFile.LOAD_TRUNCATED_IMAGES = True

DATA = Path(__file__).resolve().parent / "data"
SOURCES = {"scraped_webp.jpg": "webp/lossy_alpha_64x48.webp",
           "scraped_anim.jpg": "webp/anim_offset_frame_64x48.webp",
           "scraped_gif.jpg": "gif/offset_frame_transparency_50x40.gif",
           "scraped_bmp.jpg": "bmp/rle4_37x23.bmp",
           "scraped_dib.jpg": "bmp/bits4_dib_37x23.dib",
           "plain.jpg": "jpeg/odd_17x9_420.jpg"}
EXPERTS = ["depth", "normal", "seg_coco", "edge", "obj_detection"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("formats")
    rng = np.random.default_rng(23)
    for name, src in SOURCES.items():
        (root / "data" / "cc3m").mkdir(parents=True, exist_ok=True)
        shutil.copy(DATA / src, root / "data" / "cc3m" / name)
        with Image.open(root / "data" / "cc3m" / name) as im:
            w, h = im.size
        stem = name[:-4]
        for exp in EXPERTS[:4]:
            shape = (h, w, 3) if exp == "normal" else (h, w)
            out = root / "labels" / exp / "cc3m" / f"{stem}.png"
            out.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 134, shape, dtype=np.uint8)
                            ).save(out)
    return root


def assert_same(got, want, path):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif want is None:
        assert got is None, path
    else:
        want = np.asarray(want)
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_load_expert_labels_equals_jax(tree):
    from prismer_tpu.data import labels as jax_labels
    data, lab = str(tree / "data"), str(tree / "labels")
    for name in SOURCES:
        for experts in ("none", EXPERTS):
            got = labels.load_expert_labels(data, lab, name, "cc3m", experts)
            want = jax_labels.load_expert_labels(data, lab, name, "cc3m",
                                                 experts)
            assert_same(got[0], want[0], f"{name} image")
            assert_same(got[1], want[1], f"{name} labels")
            assert_same(got[2], want[2], f"{name} info")


def test_generator_input_equals_jax(tree):
    from prismer_tpu.experts import generate as jax_generate
    files = generate.list_images(str(tree / "data"))
    assert files == jax_generate.list_images(str(tree / "data"))
    assert len(files) == len(SOURCES)
    for path in files:
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(labels.read_rgb(path), want)


def test_read_rgb_names_what_it_found(tmp_path):
    path = tmp_path / "tiff_under_jpg_name.jpg"
    path.write_bytes(b"II*\x00" + bytes(60))
    with pytest.raises(ValueError, match="49 49 2a 00"):
        labels.read_rgb(str(path))
