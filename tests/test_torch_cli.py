"""The port's command-line drivers (prismer_tpu_torch.cli) and profiling
harness on the CPU, against the JAX package's (prismer_tpu.cli,
prismer_tpu.train.profiling).

One module-scoped tree of tiny data sets (COCO-Karpathy captions with
depth + seg_coco labels, VQAv2, few-shot ImageNet, the pretrain COCO
list, a demo folder) and a synthetic tokenizer on disk. Each driver's
`main` runs in process with `--device cpu` on prismer_tiny at 64 px for
one epoch, from a YAML file that the port's reader parses.

Equalities: `prepare_train_batch` of the four drivers array for array
against the JAX drivers' batch preparation; `train_caption.evaluate`
string for string against the JAX one on the same fp32 weights (made from
numpy seed 0 in the JAX tree, saved by the JAX `save_params_npz`, loaded by
the port's `common.load_pretrained`); the `demo_vis` figure pixel for pixel
below the header strip against the JAX figure, and the header against
Pillow drawing the same text with the bitmap font; `_checksum` against the
JAX `_checksum` to fp32 rounding.
"""

import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw, ImageFont

from prismer_tpu.cli import demo_vis as jax_demo_vis
from prismer_tpu.cli import train_caption as jax_caption_cli
from prismer_tpu.cli import train_vqa as jax_vqa_cli
from prismer_tpu.config import build_prismer_config as jax_build_config
from prismer_tpu.data import create_dataset as jax_create_dataset
from prismer_tpu.data import create_loader as jax_create_loader
from prismer_tpu.models.prismer import Prismer as JaxPrismer
from prismer_tpu.tokenizer import synthetic_tokenizer as jax_synthetic
from prismer_tpu.train import profiling as jax_profiling
from prismer_tpu.train.checkpoint import save_params_npz as jax_save_npz
from prismer_tpu_torch.cli import (common, demo, demo_vis, train_caption,
                                   train_classification, train_pretrain,
                                   train_vqa)
from prismer_tpu_torch.config import build_prismer_config
from prismer_tpu_torch.convert.from_jax import to_jax_variables
from prismer_tpu_torch.data import create_dataset, create_loader
from prismer_tpu_torch.models.prismer import build_random_prismer
from prismer_tpu_torch.tokenizer import synthetic_tokenizer
from prismer_tpu_torch.train import profiling
from prismer_tpu_torch.train.checkpoint import save_tree_npz
from tests.test_torch_model import seeded_variables

torch.set_num_threads(2)

TINY = """\
image_resolution: 64
prismer_model: 'prismer_tiny'
freeze: 'freeze_vision'
batch_size_train: 2
batch_size_test: 2
init_lr: 1.0e-4
weight_decay: 0.05
min_lr: 0
max_epoch: {epochs}
"""
PREFIX = "a toy"
LABELLED = ["depth", "seg_coco"]
# COCO test names: the reference's `.strip(".jpg")` strips characters, so
# '...5gg.jpg' parses as 5, where removing the suffix would fail
TEST_IMAGES = ["val2014/COCO_val2014_000000000042.jpg",
               "val2014/COCO_val2014_000000000005gg.jpg",
               "val2014/gpj_7.jpg"]
CLASSES = ["goldfish", "hammer", "the tabby cat"]


def _jpeg(path, rng, w=80, h=60):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        path, quality=90)


def _labels(label_root, dataset, image, rng, w=80, h=60):
    stem = os.path.splitext(image)[0]
    for exp, hi in (("depth", 256), ("seg_coco", 134)):
        path = label_root / exp / dataset / f"{stem}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, hi, (h, w), dtype=np.uint8)).save(
            path)


def _tokenizer_dir(root):
    tok_dir = root / "tok"
    tok_dir.mkdir()
    tok = synthetic_tokenizer()
    (tok_dir / "vocab.json").write_text(json.dumps(tok.vocab))
    merges = ["#version: 0.2"] + [
        f"{a} {b}" for (a, b), _ in sorted(tok.bpe_ranks.items(),
                                           key=lambda kv: kv[1])]
    (tok_dir / "merges.txt").write_text("\n".join(merges) + "\n")
    return tok_dir


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    data = root / "data"
    labels = root / "labels"
    train, test, gt = [], [], {"images": [], "annotations": []}
    for i in range(4):
        image = f"train2014/COCO_train2014_{i:012d}.jpg"
        _jpeg(data / "vqav2" / image, rng)
        _labels(labels, "vqav2", image, rng)
        train.append({"image": image, "caption": f"a toy object {i}"})
    for image in TEST_IMAGES:
        _jpeg(data / "vqav2" / image, rng)
        _labels(labels, "vqav2", image, rng)
        image_id = train_caption.coco_image_id(image)
        test.append({"image": image})
        gt["images"].append({"id": image_id})
        gt["annotations"].append({"image_id": image_id, "id": image_id,
                                  "caption": "A toy object."})
    (data / "coco_karpathy_train.json").write_text(json.dumps(train))
    (data / "coco_karpathy_test.json").write_text(json.dumps(test))
    (data / "coco_karpathy_test_gt.json").write_text(json.dumps(gt))

    answers = ["toy", "car", "dog", "tree"]
    (data / "vqav2_train_val.json").write_text(json.dumps([
        {"dataset": "vqa", "image": r["image"], "answer": answers[i],
         "question": f"what is object {i}?", "weight": 0.5 + 0.25 * i}
        for i, r in enumerate(train)]))
    (data / "vqav2_test.json").write_text(json.dumps([
        {"dataset": "vqa", "image": r["image"], "question_id": 1000 + i,
         "question": f"what is object {i}?"} for i, r in enumerate(test)]))
    (data / "answer_list.json").write_text(json.dumps(answers))

    for split in ("imagenet_train", "imagenet"):
        for c in CLASSES[:2]:
            for j in range(2):
                _jpeg(data / split / c / f"{c}_{j}.JPEG", rng, 48, 48)
    (data / "imagenet" / "imagenet_answer.json").write_text(
        json.dumps([c.title() for c in CLASSES]))
    (data / "imagenet" / "imagenet_class.json").write_text(
        json.dumps({c: i for i, c in enumerate(CLASSES)}))

    for name in ("a.jpg", "b.jpg"):
        image = f"helpers/images/{name}"
        _jpeg(root / image, rng)
        _labels(root / "helpers" / "labels", "helpers", f"images/{name}",
                rng)

    tok_dir = _tokenizer_dir(root)

    def write(name, text):
        (root / name).write_text(text)
        return str(root / name)

    def caption_yaml(epochs, experts):
        return ("# keyed like configs/caption.yaml\ncoco:\n"
                + "".join(f"  {line}\n" for line in (
                    f"dataset: 'coco'\ndata_path: '{data}'\n"
                    f"label_path: '{labels}'\nexperts: {experts}\n"
                    f"prefix: '{PREFIX}'  # prompt\n"
                    + TINY.format(epochs=epochs)).splitlines())
                + "demo:\n"
                + "".join(f"  {line}\n" for line in (
                    f"dataset: 'demo'\ndata_path: '{root / 'helpers'}'\n"
                    f"label_path: '{root / 'helpers' / 'labels'}'\n"
                    f"experts: {experts}\nprefix: '{PREFIX}'\n"
                    + TINY.format(epochs=1)).splitlines()))

    cfgs = {
        "caption": write("caption.yaml", caption_yaml(1, LABELLED)),
        "caption2": write("caption2.yaml", caption_yaml(2, LABELLED)),
        "vqa": write("vqa.yaml", (
            f"datasets: ['vqav2']\ndata_path: '{data}'\n"
            f"label_path: '{labels}'\nexperts: 'none'\nk_test: 2\n"
            f"inference: 'rank'\n" + TINY.format(epochs=1))),
        "vqa_gen": write("vqa_gen.yaml", (
            f"datasets: ['vqav2']\ndata_path: '{data}'\n"
            f"label_path: '{labels}'\nexperts: 'none'\n"
            f"inference: 'generate'\n" + TINY.format(epochs=1))),
        "classification": write("classification.yaml", (
            f"data_path: '{data}'\nlabel_path: '{labels}'\n"
            f"experts: 'none'\ndataset: 'imagenet'\nshots: 1\nk_test: 2\n"
            f"prefix: 'a photo of'\n" + TINY.format(epochs=1))),
        "pretrain": write("pretrain.yaml", (
            f"datasets: ['coco']\ncoco_data_path: '{data}'\n"
            f"label_path: '{labels}'\nexperts: 'none'\n"
            f"warmup_lr: 1.0e-6\nwarmup_steps: 1\n"
            + TINY.format(epochs=1).replace("freeze_vision",
                                            "freeze_lang_vision"))),
    }
    return SimpleNamespace(root=root, data=data, labels=labels,
                           tok_dir=tok_dir, cfgs=cfgs, answers=answers)


def run(module, tree, name, *extra):
    cfg = tree.cfgs[name]
    return module.main(["--config", cfg, "--exp_name", name,
                        "--mixed_precision", "fp32",
                        "--tokenizer_dir", str(tree.tok_dir),
                        "--logging_dir", str(tree.root / "logging"),
                        "--results_dir", str(tree.root / "results"),
                        "--device", "cpu", *extra])


# ---------------------------------------------------------------------------
# batch preparation against the JAX drivers
# ---------------------------------------------------------------------------

def _records():
    rng = np.random.default_rng(3)
    return {
        "experts": {"rgb": rng.integers(0, 255, (3, 64, 64, 3), np.uint8),
                    "depth": rng.normal(size=(3, 64, 64, 1)).astype(
                        np.float32),
                    "seg_coco": {"ids": rng.integers(0, 255, (3, 64, 64),
                                                     np.uint8),
                                 "table": rng.normal(size=(3, 256, 64))
                                 .astype(np.float32)}},
        "caption": ["a picture of a dog on the grass", "a toy",
                    "a picture of " + "many red cars " * 12],
        "question": ["what is on the mat?", "is it red",
                     "how many " + "cars " * 40 + "are there?"],
        "answer": ["the cat", "no", "two"],
        "weight": np.asarray([1.0, 0.2, 0.5], np.float32),
    }


def _assert_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_batch(got[k], want[k])
            continue
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("driver", ["caption", "vqa", "classification",
                                    "pretrain"])
def test_prepare_train_batch_matches_jax(driver):
    tok, jtok = synthetic_tokenizer(), jax_synthetic()
    batch = _records()
    prompt_len = 3
    if driver == "vqa":
        got = train_vqa.prepare_train_batch(batch, tok, device="cpu")
        want = jax_vqa_cli.prepare_train_batch(batch, jtok)
        assert np.asarray(want["weights"]).tolist() == [1.0,
                                                        np.float32(0.2), 0.5]
    elif driver == "pretrain":    # the JAX driver's inline prep: no prompt
        got = train_pretrain.prepare_train_batch(batch, tok, 1, "cpu")
        want = jax_caption_cli.prepare_train_batch(batch, jtok, 0, 1)
    else:   # classification tokenizes as the caption driver does
        module = (train_caption if driver == "caption"
                  else train_classification)
        got = module.prepare_train_batch(batch, tok, prompt_len, 1, "cpu")
        want = jax_caption_cli.prepare_train_batch(batch, jtok, prompt_len,
                                                   1)
    _assert_batch(got, want)
    assert (got["targets"] == -100).any()


# ---------------------------------------------------------------------------
# caption evaluation against the JAX driver on the same weights
# ---------------------------------------------------------------------------

def test_caption_evaluate_matches_jax(tree, tmp_path):
    config = {"dataset": "coco", "data_path": str(tree.data),
              "label_path": str(tree.labels), "experts": ["depth"],
              "image_resolution": 64, "prismer_model": "prismer_tiny",
              "freeze": "freeze_vision", "prefix": PREFIX,
              "dtype": "float32"}
    jcfg = jax_build_config(config)
    jmodel = JaxPrismer(jcfg)
    res, ch = jcfg.vision.label_resolution, 1
    ones = jnp.ones((1, 4), jnp.int32)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0),
        {"rgb": jnp.zeros((1, 64, 64, 3)),
         "depth": jnp.zeros((1, res, res, ch))}, ones, ones)
    params = seeded_variables(shapes, 0)["params"]
    # ids past the synthetic tokenizer's 277 tokens would all decode to
    # '<unk>': keep the captions inside its vocabulary
    params["text_decoder"]["lm_head"]["bias"][len(jax_synthetic().vocab):] \
        -= 30.0
    stats = jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: x + (str(p[-1].key) == "var"), stats)
    npz = str(tmp_path / "weights.npz")
    jax_save_npz(npz, params)
    args = SimpleNamespace(target_dataset="coco", device="cpu")

    _, jtest = jax_create_dataset("caption", config)
    jloader = jax_create_loader(jtest, 2, num_workers=1, train=False)
    want = jax_caption_cli.evaluate(
        jmodel, {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)},
        jloader, jax_synthetic(), config, args)

    model = build_random_prismer(build_prismer_config(config), 1, "cpu")
    loaded = common.load_pretrained(npz, model.cfg, model)
    assert "text_decoder.lm_head.bias" in loaded
    _, test = create_dataset("caption", config)
    loader = create_loader(test, 2, num_workers=1, train=False)
    got = train_caption.evaluate(model, loader, synthetic_tokenizer(),
                                 config, args)
    assert got == want, (got, want)
    assert sorted(r["image_id"] for r in got) == [5, 7, 42]
    assert all(r["caption"].endswith(".") and "unk" not in r["caption"]
               for r in got)
    assert len({r["caption"] for r in got}) > 1


def test_load_pretrained_refuses_foreign_files(tree, tmp_path):
    model = build_random_prismer(build_prismer_config(
        {"experts": "none", "image_resolution": 64,
         "prismer_model": "prismer_tiny", "dtype": "float32"}), 0, "cpu")
    np.savez(tmp_path / "foreign.npz", **{"['other']['w']": np.zeros(3)})
    with pytest.raises(ValueError, match="no matching params"):
        common.load_pretrained(str(tmp_path / "foreign.npz"), model.cfg,
                               model)
    with pytest.raises(ValueError, match="unknown pretrained format"):
        common.load_pretrained(str(tmp_path / "w.ckpt"), model.cfg, model)
    # the collection-keyed layout of the converter CLI loads too
    before = model.text_decoder.lm_head.bias.clone()
    path = str(tmp_path / "port.npz")
    save_tree_npz(path, to_jax_variables(
        {"text_decoder.lm_head.bias": before + 1}))
    values = common.load_pretrained(path, model.cfg, model)
    assert torch.equal(model.text_decoder.lm_head.bias, before + 1)
    assert set(values) == {"text_decoder.lm_head.bias"}


# ---------------------------------------------------------------------------
# the drivers' main, in process on the CPU
# ---------------------------------------------------------------------------

def test_train_caption_main_trains_evaluates_and_resumes(tree, capsys):
    run(train_caption, tree, "caption")
    out = capsys.readouterr().out
    assert out.count("Epoch 000 | loss ") == 1 and "| CIDEr " in out
    scores = json.loads(out.strip().splitlines()[-1])
    assert "CIDEr" in scores and np.isfinite(scores["CIDEr"])
    res = json.loads((tree.root / "results"
                      / "caption_results_caption_coco.json").read_text())
    assert sorted(r["image_id"] for r in res) == [5, 7, 42]
    assert all(isinstance(r["caption"], str) for r in res)
    ckpt = tree.root / "logging" / "caption_caption" / "state"
    assert ckpt.exists()
    rec = json.loads((ckpt.parent / "metrics.jsonl").read_text()
                     .splitlines()[0])
    assert rec["epoch"] == 0 and "CIDEr" in rec and "train_loss" in rec
    meta = torch.load(ckpt, weights_only=True)["metadata"]
    assert meta["epoch"] == 0 and "best_cider" in meta

    # --evaluate does not train: no epoch, the checkpoint untouched
    stamp = ckpt.stat().st_mtime_ns
    run(train_caption, tree, "caption", "--from_checkpoint", "--evaluate")
    out = capsys.readouterr().out
    assert "resuming from epoch 1" in out and "Epoch" not in \
        out.replace("resuming from epoch", "")
    assert "CIDEr" in json.loads(out.strip().splitlines()[-1])
    assert ckpt.stat().st_mtime_ns == stamp

    # --from_checkpoint resumes at the next epoch (max_epoch 2 here)
    os.rename(tree.root / "logging" / "caption_caption",
              tree.root / "logging" / "caption_caption2")
    run(train_caption, tree, "caption2", "--from_checkpoint")
    out = capsys.readouterr().out
    assert "resuming from epoch 1" in out
    assert "Epoch 001 | loss " in out and "Epoch 000" not in out


def test_train_vqa_main_rank_and_generate(tree, capsys):
    run(train_vqa, tree, "vqa")
    out = capsys.readouterr().out
    assert "Epoch 000 | loss " in out
    path = tree.root / "results" / "vqa_results_vqa.json"
    assert f"wrote {path} (3 answers)" in out
    res = json.loads(path.read_text())
    assert [r["question_id"] for r in res] == [1000, 1001, 1002]
    assert all(r["answer"] in tree.answers for r in res)
    ckpt = tree.root / "logging" / "vqa_vqa" / "state"
    assert torch.load(ckpt, weights_only=True)["metadata"] == {"epoch": 0}

    run(train_vqa, tree, "vqa_gen", "--evaluate")
    out = capsys.readouterr().out
    assert "Epoch" not in out
    res = json.loads((tree.root / "results"
                      / "vqa_results_vqa_gen.json").read_text())
    assert len(res) == 3 and all(isinstance(r["answer"], str) for r in res)
    assert not (tree.root / "logging" / "vqa_vqa_gen").exists()


def test_train_classification_main(tree, capsys):
    run(train_classification, tree, "classification")
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("Epoch 000")][0]
    acc = float(line.split("| acc ")[1].split()[0])
    assert 0.0 <= acc <= 1.0
    ckpt = tree.root / "logging" / "classification_classification" / "state"
    assert ckpt.exists() == (acc > 0)
    run(train_classification, tree, "classification", "--evaluate")
    out = capsys.readouterr().out
    assert out.startswith("accuracy: ") and "Epoch" not in out


def test_train_pretrain_main_freezes_lang_and_vision(tree, capsys):
    run(train_pretrain, tree, "pretrain")
    out = capsys.readouterr().out
    assert "Epoch 000 | loss " in out
    payload = torch.load(tree.root / "logging" / "pretrain_pretrain"
                         / "state", weights_only=True)
    assert payload["metadata"] == {"epoch": 0} and payload["step"] == 2
    n_train = len(payload["optimizer"]["param_groups"][0]["params"])
    model = build_random_prismer(build_prismer_config(
        {"experts": "none", "image_resolution": 64,
         "prismer_model": "prismer_tiny", "freeze": "freeze_lang_vision",
         "dtype": "float32"}), 0, "cpu")
    from prismer_tpu_torch.train.optim import TRAIN, freeze_labels
    labels = freeze_labels([n for n, _ in model.named_parameters()],
                           "freeze_lang_vision")
    assert n_train == sum(v == TRAIN for v in labels.values()) < len(labels)


def test_demo_main_writes_captions_beside_images(tree, capsys):
    demo.main(["--config", tree.cfgs["caption"], "--mixed_precision", "fp32",
               "--tokenizer_dir", str(tree.tok_dir), "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2
    for line in out:
        path, cap = line.split(": ", 1)
        assert (tree.root / "helpers" / "images").samefile(
            os.path.dirname(path))
        with open(os.path.splitext(path)[0] + ".txt") as f:
            assert f.read() == cap


class _Stop(Exception):
    pass


@pytest.mark.parametrize("module", [train_caption, train_vqa,
                                    train_classification, train_pretrain,
                                    demo])
@pytest.mark.parametrize("flag,mode", [("--multihost", "dp"),
                                       ("--shard_grad_op", "zero2"),
                                       ("--full_shard", "zero3")])
def test_multi_process_flags_select_their_mode(tree, module, flag, mode,
                                               monkeypatch):
    """Each flag parses in every driver and selects its train step's mode;
    --multihost opens the process group (runtime.init) before anything
    else of the run, on the run's --device."""
    seen, inits = [], []
    real_setup = common.setup

    def setup(args, *a, **kw):
        seen.append((common.train_mode(args), args.multihost))
        real_setup(args, *a, **kw)
        raise _Stop

    monkeypatch.setattr(common, "setup", setup)
    monkeypatch.setattr(common.runtime, "init", inits.append)
    with pytest.raises(_Stop):
        run(module, tree, "caption", flag)
    assert seen == [(mode, flag == "--multihost")]
    assert inits == (["cpu"] if flag == "--multihost" else [])


@pytest.mark.parametrize("module", [train_caption, train_vqa,
                                    train_classification, train_pretrain,
                                    demo])
def test_drivers_refuse_to_start_without_cuda(module, capsys):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as e:
        module.main([])
    assert e.value.code == 2
    assert "no CUDA device: pass --device cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        module.main(["--help"])
    assert e.value.code == 0 and "--device" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# demo_vis against the JAX figure
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vis_tree(tmp_path_factory):
    """An image and labels of every panel kind: plasma depth, RGB normal,
    grey edge, palette id maps; ocr_detection missing; a caption."""
    root = tmp_path_factory.mktemp("vis")
    rng = np.random.default_rng(5)
    image = root / "helpers" / "images" / "img_1.jpg"
    _jpeg(image, rng, 90, 70)
    rel = "helpers/images/img_1.png"
    kinds = {"depth": (70, 90), "normal": (70, 90, 3), "edge": (70, 90),
             "seg_coco": (35, 45), "seg_ade": (70, 90),
             "obj_detection": (70, 90)}
    for exp, shape in kinds.items():
        path = root / "labels" / exp / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        hi = {"seg_coco": 134, "seg_ade": 256, "obj_detection": 8}.get(
            exp, 256)
        arr = rng.integers(0, hi, shape, dtype=np.uint8)
        if exp == "obj_detection":
            arr[arr == 7] = 255
        mode = "RGB" if exp == "normal" else "L"
        Image.fromarray(arr, mode).save(path)
    (image.parent / "img_1.txt").write_text("a toy car on a road\n")
    return root, str(image)


def test_demo_vis_equals_jax_figure(vis_tree, tmp_path, monkeypatch,
                                    capsys):
    root, image = vis_tree
    panel = 40
    jax_out, port_out = tmp_path / "jax.png", tmp_path / "port.png"
    monkeypatch.setattr(sys, "argv", [
        "demo_vis", "--image", image, "--label_path", str(root / "labels"),
        "--out", str(jax_out), "--panel", str(panel)])
    jax_demo_vis.main()
    # the figure is host work: no --device, and no CUDA needed
    assert not torch.cuda.is_available()
    demo_vis.main(["--image", image, "--label_path", str(root / "labels"),
                   "--out", str(port_out), "--panel", str(panel)])
    assert f"wrote {port_out}" in capsys.readouterr().out
    want = np.asarray(Image.open(jax_out).convert("RGB"))
    got = np.asarray(Image.open(port_out))
    assert got.shape == want.shape
    top = demo_vis.PAD + demo_vis.HEADER
    np.testing.assert_array_equal(got[top:], want[top:])
    assert (got[top:top + panel, -demo_vis.PAD - panel:-demo_vis.PAD]
            == 32).all()      # the missing ocr_detection panel

    header = Image.new("RGB", (want.shape[1], top), (255, 255, 255))
    draw = ImageDraw.Draw(header)
    font = ImageFont.load_default_imagefont()
    names = ["rgb", *demo_vis.EXPERTS]
    for i, name in enumerate(names):
        draw.text((demo_vis.PAD + i * (panel + demo_vis.PAD), 2), name,
                  fill=(0, 0, 0), font=font)
    draw.text((demo_vis.PAD, top - 14), "caption: a toy car on a road",
              fill=(60, 60, 60), font=font)
    np.testing.assert_array_equal(got[:top], np.asarray(header))
    # outside Latin-1 (where Pillow's bitmap font raises) a character is '?'
    np.testing.assert_array_equal(demo_vis.text_mask("a\u2603b"),
                                  demo_vis.text_mask("a?b"))


@pytest.mark.parametrize("exp", ["seg_ade", "seg_coco", "depth", "normal",
                                 "edge", "ocr_detection"])
def test_demo_vis_panels_equal_jax(vis_tree, exp):
    root, _ = vis_tree
    args = (str(root / "labels"), exp, "helpers/images", "img_1.png")
    want = np.asarray(jax_demo_vis.load_panel(*args, (33, 21)).convert(
        "RGB"))
    got = demo_vis.load_panel(*args, (33, 21))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_checksum_matches_jax():
    rng = np.random.default_rng(9)
    leaves = {"a": rng.normal(size=(5, 7)).astype(np.float32) * 100,
              "b": [rng.integers(-50, 50, (11,)).astype(np.int32),
                    rng.normal(size=(3,)).astype(np.float16)],
              "mask": np.ones(4, bool), "name": "x"}
    want = jax_profiling._checksum(jax.tree.map(
        lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v,
        leaves))
    got = profiling._checksum({k: (torch.from_numpy(v) if k == "a" else v)
                               for k, v in leaves.items()})
    assert got == pytest.approx(want, rel=1e-6, abs=1e-3)


def test_trace_and_timeit_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tb")):
        (x @ x).sum()
    files = list((tmp_path / "tb").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    t = profiling.timeit_readback(lambda a: a @ a, x, repeats=2)
    assert set(t) == {"min", "mean", "max"} and 0 < t["min"] <= t["max"]
