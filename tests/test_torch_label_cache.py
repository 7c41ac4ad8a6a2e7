"""The decoded-label cache, the two overrides and the expert inputs from
JPEG files, held against the JAX package on the CPU.

* PRISMER_LABEL_CACHE (`data.labels._open_label_png`): a round trip; an
  entry older than its PNG, of another ndim or unreadable falls through to
  a decode; an entry the JAX package wrote is read back, and the JAX
  package reads the port's; `load_expert_labels` records equal JAX's with
  the variable set in both, cold and warm;
* PRISMER_FEATURES and PRISMER_WORKER_TYPE give the JAX package's tables
  and worker type;
* the experts' `resize_norm` on the port's JPEG decode equals the JAX
  `_resize_norm` under PRISMER_NATIVE_LOADER=0 (PIL's decode and BILINEAR
  resize) bit for bit, on every JPEG fixture.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageFile

from prismer_tpu.data import features as jax_features
from prismer_tpu.data import labels as jax_labels
from prismer_tpu.data import loader as jax_loader
from prismer_tpu.experts import model_bank as jax_model_bank
from prismer_tpu_torch import native
from prismer_tpu_torch.data import features, labels, loader
from prismer_tpu_torch.experts import model_bank

torch.set_num_threads(2)

JPEGS = Path(__file__).resolve().parent / "data" / "jpeg"
EXPERTS = ["depth", "normal", "seg_coco", "edge", "obj_detection",
           "ocr_detection"]


@pytest.fixture(autouse=True)
def _plain_jax_loader(monkeypatch):
    # the JAX package's PIL path (its native libpng / libjpeg path is the
    # default where it is built; the port follows PIL)
    monkeypatch.setenv("PRISMER_NATIVE_LOADER", "0")
    monkeypatch.delenv("PRISMER_LABEL_CACHE", raising=False)


def _png(path: Path, arr: np.ndarray, mtime_ns: int = None) -> str:
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)
    if mtime_ns is not None:
        os.utime(path, ns=(mtime_ns, mtime_ns))
    return str(path)


def _age(path: str, mtime_ns: int) -> None:
    os.utime(path, ns=(mtime_ns, mtime_ns))


T0 = 1_700_000_000 * 10 ** 9          # a fixed mtime, in ns


def test_cache_round_trip(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    grey = rng.integers(0, 256, (13, 17), dtype=np.uint8)
    rgb = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    monkeypatch.setenv("PRISMER_LABEL_CACHE", str(tmp_path / "cache"))
    for arr, mode in ((grey, "L"), (rgb, "RGB")):
        src = _png(tmp_path / "labels" / f"{mode}.png", arr, T0)
        got = labels._open_label_png(src, mode)
        entry = labels._cache_npy_path(src)
        assert entry == os.path.join(str(tmp_path / "cache"),
                                     os.path.abspath(src).lstrip(os.sep)
                                     + ".npy")
        np.testing.assert_array_equal(got, arr)
        np.testing.assert_array_equal(np.load(entry), arr)
        assert not [p for p in os.listdir(os.path.dirname(entry))
                    if p.endswith(".tmp")]
        # a hit reads the entry and decodes nothing
        monkeypatch.setattr(labels, "read_png", _no_decode)
        np.testing.assert_array_equal(labels._open_label_png(src, mode), arr)
        monkeypatch.undo()
        monkeypatch.setenv("PRISMER_LABEL_CACHE", str(tmp_path / "cache"))


def _no_decode(*a, **k):
    raise AssertionError("decoded although the cache entry is valid")


def test_newer_png_or_other_ndim_invalidates_the_entry(tmp_path, monkeypatch):
    monkeypatch.setenv("PRISMER_LABEL_CACHE", str(tmp_path / "cache"))
    old = np.full((6, 5), 7, np.uint8)
    new = np.full((6, 5), 9, np.uint8)
    src = _png(tmp_path / "a.png", old, T0)
    labels._open_label_png(src, "L")
    entry = labels._cache_npy_path(src)
    _age(entry, T0 + 10)
    _png(tmp_path / "a.png", new, T0 + 10)      # same mtime: still a hit
    np.testing.assert_array_equal(labels._open_label_png(src, "L"), old)
    _age(src, T0 + 11)                          # 1 ns newer: a miss
    np.testing.assert_array_equal(labels._open_label_png(src, "L"), new)
    np.testing.assert_array_equal(np.load(entry), new)
    # an entry of another ndim is not the mode's: "RGB" decodes
    _age(entry, T0 + 20)
    got = labels._open_label_png(src, "RGB")
    np.testing.assert_array_equal(got, np.repeat(new[..., None], 3, -1))


@pytest.mark.parametrize("content", [b"", b"not an npy file",
                                     b"\x93NUMPY\x01\x00v\x00{'descr'"])
def test_unreadable_entry_falls_back_to_decoding(tmp_path, monkeypatch,
                                                 content):
    monkeypatch.setenv("PRISMER_LABEL_CACHE", str(tmp_path / "cache"))
    arr = np.arange(30, dtype=np.uint8).reshape(5, 6)
    src = _png(tmp_path / "b.png", arr, T0)
    entry = Path(labels._cache_npy_path(src))
    entry.parent.mkdir(parents=True)
    entry.write_bytes(content)
    _age(str(entry), T0 + 5)
    np.testing.assert_array_equal(labels._open_label_png(src, "L"), arr)
    np.testing.assert_array_equal(np.load(entry), arr)   # written anew


def test_entries_are_shared_with_the_jax_package(tmp_path, monkeypatch):
    """Same layout: an entry the JAX package wrote is the port's hit (the
    PNG is then rewritten with other pixels but an older mtime, so only the
    entry holds the first pixels), and the other way round."""
    monkeypatch.setenv("PRISMER_LABEL_CACHE", str(tmp_path / "cache"))
    rng = np.random.default_rng(1)
    for writer, reader, name in (
            (jax_labels._open_label_png, labels._open_label_png, "j"),
            (labels._open_label_png, jax_labels._open_label_png, "p")):
        first = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
        src = _png(tmp_path / f"{name}.png", first, T0)
        np.testing.assert_array_equal(np.asarray(writer(src, "RGB")), first)
        _png(tmp_path / f"{name}.png", first[::-1].copy(), T0 - 10)
        np.testing.assert_array_equal(np.asarray(reader(src, "RGB")), first)


def _tree(root: Path):
    rng = np.random.default_rng(2)
    data, lab = root / "data", root / "labels"
    images = []
    for k in range(3):
        w, h = 23 + 4 * k, 17 + 2 * k
        rel = f"val2014/x{k}.jpg"
        (data / "coco" / "val2014").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            data / "coco" / rel, "JPEG", quality=90)
        for exp in EXPERTS:
            arr = rng.integers(0, 256, (h, w, 3) if exp == "normal"
                               else (h, w), dtype=np.uint8)
            img = Image.fromarray(arr)
            if exp == "depth" and k == 1:          # a palette label file
                img = img.convert("RGB").quantize(16)
            out = lab / exp / "coco" / rel.replace(".jpg", ".png")
            out.parent.mkdir(parents=True, exist_ok=True)
            img.save(out)
        (lab / "obj_detection" / "coco" / rel.replace(".jpg", ".json")
         ).write_text(json.dumps({"3": 5}))
        images.append(rel)
    return str(data), str(lab), images


def test_records_equal_jax_with_the_cache_set(tmp_path, monkeypatch):
    data, lab, images = _tree(tmp_path)

    def records(load, cache):
        if cache:
            monkeypatch.setenv("PRISMER_LABEL_CACHE", cache)
        else:
            monkeypatch.delenv("PRISMER_LABEL_CACHE", raising=False)
        out = []
        for rel in images:
            image, labs, info = load(data, lab, rel, "coco", EXPERTS)
            out.append((np.asarray(image),
                        {k: np.asarray(v) for k, v in labs.items()}, info))
        return out

    want = records(jax_labels.load_expert_labels, None)
    for load, cache in ((labels.load_expert_labels, str(tmp_path / "c1")),
                        (jax_labels.load_expert_labels,
                         str(tmp_path / "c2"))):
        for epoch in range(2):                  # cold, then warm
            got = records(load, cache)
            for (gi, gl, ginfo), (wi, wl, winfo) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                assert gl.keys() == wl.keys() and ginfo == winfo
                for k in wl:
                    assert gl[k].dtype == wl[k].dtype
                    np.testing.assert_array_equal(gl[k], wl[k], err_msg=k)
    port_entries = sorted(p.relative_to(tmp_path / "c1")
                          for p in (tmp_path / "c1").rglob("*.npy"))
    jax_entries = sorted(p.relative_to(tmp_path / "c2")
                         for p in (tmp_path / "c2").rglob("*.npy"))
    # five label PNGs a record: no OCR sidecar, so its PNG is not read
    assert port_entries == jax_entries and len(port_entries) == 3 * 5


def test_features_override_equals_jax(tmp_path, monkeypatch):
    z = dict(np.load(features.ASSET))
    z["coco_features"] = z["coco_features"][::-1] * 2
    z["background"] = z["background"] + 1
    path = tmp_path / "features.npz"
    np.savez(path, **z)
    monkeypatch.setenv("PRISMER_FEATURES", str(path))
    got, want = features.FeatureTables(), jax_features.FeatureTables()
    np.testing.assert_array_equal(got.seg_table("seg_coco"),
                                  want.seg_table("seg_coco"))
    np.testing.assert_array_equal(got.background, z["background"])
    explicit = features.FeatureTables(str(features.ASSET))
    assert not np.array_equal(explicit.background, got.background)


@pytest.mark.parametrize("env", [None, "thread", "process"])
@pytest.mark.parametrize("worker_type", ["auto", "thread", "process"])
def test_worker_type_override_equals_jax(monkeypatch, env, worker_type):
    if env is None:
        monkeypatch.delenv("PRISMER_WORKER_TYPE", raising=False)
    else:
        monkeypatch.setenv("PRISMER_WORKER_TYPE", env)
    for n in (1, 4):
        got = loader.DataLoader([0] * 8, 2, train=False, num_workers=n,
                                worker_type=worker_type)
        want = jax_loader.DataLoader([0] * 8, 2, train=False, num_workers=n,
                                     worker_type=worker_type)
        assert got.worker_type == want.worker_type


def test_worker_type_override_refuses_other_values(monkeypatch):
    monkeypatch.setenv("PRISMER_WORKER_TYPE", "fiber")
    with pytest.raises(ValueError, match="PRISMER_WORKER_TYPE"):
        loader.DataLoader([0] * 8, 2, train=False)


@pytest.mark.parametrize("name", sorted(p.name for p in JPEGS.glob("*.jpg")))
def test_jpeg_resize_norm_equals_jax_pil_path(name, monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)
    path = str(JPEGS / name)
    with open(path, "rb") as f:
        pixels = native.decode_jpeg(f.read())
    for size in (64, 37):
        for mean, std in ((0.5, 0.5),
                          (model_bank.IMAGENET_MEAN, model_bank.IMAGENET_STD),
                          (model_bank.IMAGENET_MEAN, (1.0, 1.0, 1.0))):
            got = model_bank.resize_norm(size, mean, std)(pixels)
            want = jax_model_bank._resize_norm(size, mean, std)(
                Image.open(path))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)

