"""The label generator of the PyTorch port
(prismer_tpu_torch.experts.generate) and its host-side pieces against the
JAX package, PIL and cv2 on the CPU: all seven tasks.

Both generators run over the same folder of PIL-written PNGs with both
`load_expert_model`s replaced by the same tiny Mask2Former weights; the
label PNGs must hold the same ids except at pixels whose low-resolution
source is a near tie (top-2 gap of JAX's semantic logits <= 1e-4), which
are counted. The PNG codec, the preprocess (PIL's BILINEAR resize, / 255,
pixel statistics) and the NEAREST resize of the id maps are held to PIL
bit for bit.

Depth, normal and edge run both generators over the same PNGs with the
same tiny weights (tests/test_torch_expert_*.py's models): labels may
differ by one grey level where fp32 noise crosses a truncation (counted,
at most 2 % of a label's pixels); their host post-processing is bit-equal
on the same prediction. The object- and OCR-detection generators are held
the same way in tests/test_torch_expert_objdet.py and _ocr.py, with the
helpers here.
"""

import argparse
import io
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from prismer_tpu.experts import generate as jax_generate
from prismer_tpu.experts import model_bank as jax_bank
from prismer_tpu_torch.convert.from_jax import load_jax_variables
from prismer_tpu_torch.data import pil_warp, png
from prismer_tpu_torch.experts import generate as port_generate
from prismer_tpu_torch.experts import model_bank as port_bank
from prismer_tpu_torch.experts.segmentation import mask2former as pm

from test_torch_segmentation import TINY, TinyMaskFormer, seeded

torch.set_num_threads(2)

RES = 80
GAP = 1e-4
# (folder, name, PIL mode, (W, H)): grey, RGB and RGBA, up- and downscaled
IMAGES = [("a", "0.png", "RGB", (97, 61)), ("a", "1.png", "L", (64, 80)),
          ("a", "2.png", "RGBA", (50, 50)), ("b", "3.png", "RGB", (120, 90)),
          ("b", "4.png", "RGB", (33, 47))]


def _image(rng, mode, size):
    w, h = size
    ch = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 255 // max(w - 1, 1) + yy * 97 // max(h - 1, 1))[..., None]
    img = (base + rng.integers(0, 60, (h, w, ch))) % 256
    return img.astype(np.uint8)[..., 0] if ch == 1 else img.astype(np.uint8)


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for folder, name, mode, size in IMAGES:
        os.makedirs(root / "data" / folder, exist_ok=True)
        Image.fromarray(_image(rng, mode, size), mode).save(
            root / "data" / folder / name)
    return root


def _args(root, out):
    return argparse.Namespace(data_path=str(root / "data"),
                              save_path=str(out), batch_size=3,
                              image_size=RES, shard_id=0, num_shards=1,
                              device="cpu")


def test_segmentation_labels_match_jax_generator(image_root, tmp_path,
                                                 monkeypatch):
    model = TinyMaskFormer(TINY)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, RES, RES, 3)))
    variables = seeded(shapes, 11)
    jax_sems = []

    @jax.jit
    def apply(v, x):
        return model.apply(v, x)

    def jax_apply(v, x):
        out = apply(v, x)
        jax_sems.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax_generate, "load_expert_model",
                        lambda task, image_size: (
                            jax_apply, jax.tree.map(jnp.asarray, variables),
                            jax_bank._resize_norm(image_size,
                                                  port_bank.SEG_MEAN,
                                                  port_bank.SEG_STD)))
    port = pm.MaskFormer(device="cpu", **TINY).eval()
    load_jax_variables(port, variables)
    monkeypatch.setattr(port_generate, "load_expert_model",
                        lambda task, image_size, device: (
                            port, port_bank.resize_norm(
                                image_size, port_bank.SEG_MEAN,
                                port_bank.SEG_STD)))
    args = _args(image_root, tmp_path / "jax")
    jax_generate.run_segmentation(args, "seg_coco")
    port_generate.run_batched(_args(image_root, tmp_path / "port"),
                                   "seg_coco")

    sem = np.concatenate(jax_sems)
    top2 = np.sort(sem, axis=1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= GAP          # (N, RES/4, RES/4)
    near_ties = 0
    for k, (folder, name, _, size) in enumerate(IMAGES):
        rel = os.path.join("seg_coco", "data", folder, name)
        want = np.asarray(Image.open(tmp_path / "jax" / rel))
        got = png.read_png(str(tmp_path / "port" / rel))
        assert got.shape == want.shape == size[::-1] and got.dtype == np.uint8
        src_tie = pil_warp.resize_nearest_u8(tie[k].astype(np.uint8), size)
        near_ties += int(src_tie.sum())
        differ = got != want
        assert not (differ & (src_tie == 0)).any(), (name, differ.sum())
    print(f"label pixels over near ties: {near_ties}")
    assert near_ties < 0.05 * sum(w * h for *_, (w, h) in IMAGES)


def test_jpeg_and_png_inputs_give_equal_labels(tmp_path, monkeypatch):
    """The generator over JPEG files (the port's decoder) and over the
    pixels PIL decodes from them, written as PNG: the same label maps."""
    rng = np.random.default_rng(3)
    for k, (size, sub) in enumerate([((97, 61), 2), ((64, 80), 0),
                                     ((33, 47), 1)]):
        img = Image.fromarray(_image(rng, "RGB", size))
        for kind in ("jpg", "png"):
            os.makedirs(tmp_path / kind / "data" / "images", exist_ok=True)
        img.save(tmp_path / "jpg" / "data" / "images" / f"{k}.jpg", quality=85,
                 subsampling=sub, progressive=k == 1)
        Image.open(tmp_path / "jpg" / "data" / "images" / f"{k}.jpg").convert(
            "RGB").save(tmp_path / "png" / "data" / "images" / f"{k}.png")
    port = pm.MaskFormer(device="cpu", **TINY).eval()
    load_jax_variables(port, seeded(jax.eval_shape(
        TinyMaskFormer(TINY).init, jax.random.key(0),
        jnp.zeros((1, RES, RES, 3))), 13))
    monkeypatch.setattr(port_generate, "load_expert_model",
                        lambda task, image_size, device: (
                            port, port_bank.resize_norm(
                                image_size, port_bank.SEG_MEAN,
                                port_bank.SEG_STD)))
    for kind in ("jpg", "png"):
        port_generate.run_batched(
            _args(tmp_path / kind, tmp_path / f"out_{kind}"), "seg_coco")
    for k in range(3):
        got, want = (png.read_png(str(tmp_path / f"out_{kind}" / "seg_coco"
                                      / "data" / "images" / f"{k}.png"))
                     for kind in ("jpg", "png"))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,shape", [("L", (23, 31)), ("RGB", (17, 9, 3)),
                                        ("RGBA", (8, 40, 4))])
def test_png_round_trip_and_pil_reads_it(mode, shape):
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    data = png.encode_png(img)
    np.testing.assert_array_equal(png.decode_png(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)


def _filter_row(kind, row, prior, bpp):
    """PNG row filter (spec section 9) applied to one row of bytes."""
    row, prior = row.astype(np.int64), prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) // 2
    else:
        p = left + prior - upleft
        pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prior, upleft))
    return ((row - pred) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode,ch,color", [("L", 1, 0), ("RGB", 3, 2),
                                           ("RGBA", 4, 6)])
def test_png_decodes_all_five_filter_types_as_pil_does(mode, ch, color):
    h, w = 15, 13
    img = np.random.default_rng(2).integers(0, 256, (h, w * ch)).astype(
        np.uint8)
    rows, prior = [], np.zeros(w * ch, np.uint8)
    for y in range(h):
        kind = y % 5
        rows.append(bytes([kind]) + _filter_row(kind, img[y], prior,
                                                 ch).tobytes())
        prior = img[y]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))
    want = np.asarray(Image.open(io.BytesIO(data)).convert(mode))
    np.testing.assert_array_equal(want.reshape(h, w * ch), img)
    np.testing.assert_array_equal(png.decode_png(data), want)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_decodes_pil_adaptive_filters(mode, tmp_path):
    img = _image(np.random.default_rng(3), mode, (70, 45))
    Image.fromarray(img, mode).save(tmp_path / "x.png")
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "x.png")), img)


def test_png_refuses_what_it_does_not_read(tmp_path):
    # every PNG kind is read (tests/test_torch_png.py); a header the
    # standard does not allow (RGB at 4 bits a sample) is refused
    data = bytearray(png.encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[24] = 4
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="bit depth 4, colour type 2"):
        png.decode_png(bytes(data))
    data = bytearray(png.encode_png(np.zeros((4, 4), np.uint8)))
    data[40] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))


@pytest.mark.parametrize("mode,size", [("RGB", (640, 480)), ("RGB", (500, 375)),
                                       ("RGB", (480, 640)), ("L", (333, 500)),
                                       ("RGBA", (200, 150)),
                                       ("RGB", (480, 480))])
def test_preprocess_equals_jax_resize_norm(mode, size):
    """Bit-exact: PIL's fixed-point BILINEAR resize (antialiased when
    shrinking) replicated in numpy, then / 255 and the pixel statistics."""
    img = _image(np.random.default_rng(4), mode, size)
    want = jax_bank._resize_norm(480, port_bank.SEG_MEAN, port_bank.SEG_STD)(
        Image.fromarray(img, mode))
    got = port_bank.resize_norm(480, port_bank.SEG_MEAN,
                                port_bank.SEG_STD)(img)
    assert got.dtype == np.float32 and got.shape == (480, 480, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((120, 120), (640, 480)),
                                     ((120, 120), (500, 375)),
                                     ((120, 120), (480, 640)),
                                     ((20, 20), (97, 61)),
                                     ((37, 53), (13, 29))])
def test_nearest_resize_equals_pil(src, dst):
    ids = np.random.default_rng(5).integers(0, 133, src).astype(np.uint8)
    want = np.asarray(Image.fromarray(ids, "L").resize(dst, Image.NEAREST))
    np.testing.assert_array_equal(pil_warp.resize_nearest_u8(ids, dst), want)


def test_jpeg_input_raises(tmp_path, monkeypatch):
    """JPEG input is read by the port's decoder; a kind it refuses, as
    Pillow does (12-bit samples: a baseline file whose SOF says 12), raises
    before anything is written."""
    os.makedirs(tmp_path / "data" / "a")
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "JPEG")
    data = buf.getvalue()
    sof = data.index(b"\xff\xc0")
    data = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    (tmp_path / "data" / "a" / "x.jpg").write_bytes(data)
    monkeypatch.setattr(port_generate, "load_expert_model",
                        lambda task, image_size, device: (None, None))
    with pytest.raises(ValueError, match="12-bit JPEG samples"):
        port_generate.run_batched(_args(tmp_path, tmp_path / "out"),
                                       "seg_coco")
    assert not (tmp_path / "out" / "seg_coco").exists()


def test_main_runs_on_the_cpu_when_asked(image_root, tmp_path, monkeypatch):
    port = pm.MaskFormer(device="cpu", **TINY).eval()
    load_jax_variables(port, seeded(jax.eval_shape(
        TinyMaskFormer(TINY).init, jax.random.key(0),
        jnp.zeros((1, RES, RES, 3))), 12))
    seen = {}

    def load(task, image_size, device):
        seen.update(task=task, image_size=image_size, device=str(device))
        return port, port_bank.resize_norm(image_size, port_bank.SEG_MEAN,
                                           port_bank.SEG_STD)

    monkeypatch.setattr(port_generate, "load_expert_model", load)
    config = tmp_path / "cfg.yaml"
    config.write_text(f"data_path: {image_root / 'data'}\n"
                      f"save_path: '{tmp_path / 'out'}'  # labels\n")
    assert port_generate.main(["--task", "seg_ade", "--config", str(config),
                               "--image_size", str(RES), "--batch_size", "2",
                               "--shard_id", "1", "--num_shards", "2",
                               "--device", "cpu"]) == 0
    assert seen == dict(task="seg_ade", image_size=RES, device="cpu")
    written = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "out")
                     for d, _, fs in os.walk(tmp_path / "out") for f in fs)
    assert written == ["seg_ade/data/a/1.png", "seg_ade/data/b/3.png"]


def test_main_refuses_the_card_when_there_is_none(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for task in port_generate.TASKS:
        with pytest.raises(SystemExit):
            port_generate.main(["--task", task, "--data_path",
                                str(tmp_path)])
    with pytest.raises(ValueError, match="unknown expert task"):
        port_bank.load_expert_model("depth_v2", 64, "cpu")


def test_main_runs_the_model_in_fp32_and_restores_tf32(image_root, tmp_path,
                                                       monkeypatch):
    """The generator pins fp32 for its run, as the JAX package computes
    its convolutions: inside the model's forward both TF32 flags read
    False, whatever they were before; main() restores them afterwards."""
    seen = []

    class Recording(torch.nn.Module):
        """Records the flags, returns 133-class logits at a quarter of the
        input size."""

        def forward(self, x):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            b, h, w, _ = x.shape
            return torch.zeros(b, 133, h // 4, w // 4)

    def load(task, image_size, device):
        return Recording(), port_bank.resize_norm(
            image_size, port_bank.SEG_MEAN, port_bank.SEG_STD)

    monkeypatch.setattr(port_generate, "load_expert_model", load)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert port_generate.main([
        "--task", "seg_coco", "--data_path", str(image_root / "data"),
        "--save_path", str(tmp_path / "out"), "--image_size", str(RES),
        "--batch_size", "2", "--device", "cpu"]) == 0
    assert seen and set(seen) == {(False, False)}
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (True, True)
    monkeypatch.undo()
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


# ---------------------------------------------------------------------------
# depth, normal, edge, obj_detection and ocr_detection
# ---------------------------------------------------------------------------

EXPERT_RES = 64
# a pixel of a depth / normal / edge label may differ by one grey level
# where fp32 noise crosses a truncation boundary; at most this share of a
# label's pixels may
LEVEL_SHARE = 0.02


def _expert_args(root, out, **kw):
    return argparse.Namespace(**{**vars(_args(root, out)), "batch_size": 8,
                                 "image_size": EXPERT_RES, **kw})


def _jax_loader(apply, variables, task):
    mean, std = port_bank.PIXEL_STATS[task]

    def load(task_, image_size):
        assert task_ == task
        return apply, variables, jax_bank._resize_norm(image_size, mean, std)

    return load


def _port_loader(model, task):
    def load(task_, image_size, device):
        assert task_ == task and str(device) == "cpu"
        return model, port_bank.resize_norm(image_size,
                                            *port_bank.PIXEL_STATS[task])

    return load


def _dense_models(task):
    from prismer_tpu.experts.depth import model as jd
    from prismer_tpu.experts.edge import model as je
    from prismer_tpu.experts.normal import model as jn
    from prismer_tpu_torch.experts.depth import model as pd
    from prismer_tpu_torch.experts.edge import model as pe
    from prismer_tpu_torch.experts.normal import model as pn
    if task == "depth":
        kw = dict(features=32, vit_dim=64, vit_layers=4, vit_heads=2,
                  hooks=(1, 3))
        return jd.DPTDepthModel(**kw), pd.DPTDepthModel(device="cpu", **kw)
    if task == "normal":
        return jn.NNET(), pn.NNET(device="cpu")
    return je.DexiNed(), pe.DexiNed(device="cpu")


def _read_label(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("task", ["depth", "normal", "edge"])
def test_dense_labels_match_jax_generator(task, image_root, tmp_path,
                                          monkeypatch):
    """Both generators over the PIL-written PNGs with the same tiny weights
    (the port through `main --device cpu`): equal label files, but for
    pixels one grey level apart, at most LEVEL_SHARE of each label."""
    from torch_expert_util import seeded
    jax_model, port = _dense_models(task)
    variables = seeded(jax.eval_shape(
        jax_model.init, jax.random.key(0),
        jnp.zeros((1, EXPERT_RES, EXPERT_RES, 3))), 21)
    load_jax_variables(port, variables)
    monkeypatch.setattr(jax_generate, "load_expert_model", _jax_loader(
        jax.jit(jax_model.apply), variables, task))
    monkeypatch.setattr(port_generate, "load_expert_model",
                        _port_loader(port.eval(), task))
    getattr(jax_generate, f"run_{task}")(
        _expert_args(image_root, tmp_path / "jax"))
    assert port_generate.main([
        "--task", task, "--data_path", str(image_root / "data"),
        "--save_path", str(tmp_path / "port"), "--batch_size", "8",
        "--image_size", str(EXPERT_RES), "--device", "cpu"]) == 0
    assert port_generate.LAST_RUN["images"] == len(IMAGES)
    off = 0
    for folder, name, _, (w, h) in IMAGES:
        rel = os.path.join(task, "data", folder, name)
        want = _read_label(tmp_path / "jax" / rel)
        got = png.read_png(str(tmp_path / "port" / rel))
        assert got.dtype == np.uint8
        assert got.shape == want.shape == ((h, w, 3) if task == "normal"
                                           else (h, w))
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, (name, diff.max())
        assert (diff > 0).mean() <= LEVEL_SHARE, (name, (diff > 0).mean())
        off += int((diff > 0).sum())
    print(f"{task}: {off} label pixels one level apart")


@pytest.mark.parametrize("value", [0.0, 0.6, 1.5, 254.6, 254.9999, 255.0,
                                   255.5, 300.0, -3.0, -0.5, np.nan])
def test_f_to_l_is_pil_mode_f_to_l(value):
    x = np.full((2, 3), value, np.float32)
    want = np.asarray(Image.fromarray(x).convert("L"))
    np.testing.assert_array_equal(port_generate.f_to_l(x), want)


@pytest.mark.parametrize("task", ["depth", "normal", "edge"])
def test_dense_post_is_bit_equal_on_the_same_prediction(task):
    """The host post-processing, fed one float32 prediction: the label PIL
    and numpy make in the JAX generator, bit for bit."""
    rng = np.random.default_rng(8)
    size = (97, 61)
    if task == "depth":
        pred = rng.gamma(2.0, 3.0, (64, 64)).astype(np.float32)
        want = jax_generate._depth_post(pred, size)
    elif task == "normal":
        pred = rng.uniform(-1.2, 1.2, (64, 64, 3)).astype(np.float32)
        want = jax_generate._normal_post([pred], size)
    else:
        pred = rng.normal(0, 4, (64, 64)).astype(np.float32)
        want = jax_generate._edge_post(pred, size)
    got = port_generate.DENSE_POST[task](pred, size)
    np.testing.assert_array_equal(got, np.asarray(want))
