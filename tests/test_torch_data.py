"""The port's data pipeline (prismer_tpu_torch.data) against the JAX
package's (prismer_tpu.data, PIL underneath) on the CPU, bit for bit.

With the same `random.seed`, `Transform` and `RandAugment` give equal
records (train and eval, 384 and 480 px, all seven experts, a label of
another size); `load_expert_labels` + `build_expert_record` and the four
datasets give equal records on a seeded tree of JPEG and PNG files with
every missing-label fallback; the loader gives the same index order
(shuffle, shards, drop_last); `experts_to_device` + `materialize_experts`
equal JAX's `materialize_experts`; two forked workers draw different
augmentations.
"""

import json
import multiprocessing
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from prismer_tpu.data import datasets as jax_datasets
from prismer_tpu.data import device as jax_device
from prismer_tpu.data import labels as jax_labels
from prismer_tpu.data import loader as jax_loader
from prismer_tpu.data import randaugment as jax_ra
from prismer_tpu.data import transform as jax_transform
from prismer_tpu_torch.data import datasets, device, labels, loader
from prismer_tpu_torch.data import randaugment, transform

torch.set_num_threads(2)

EXPERTS = ["depth", "normal", "seg_coco", "edge", "obj_detection",
           "ocr_detection"]


def assert_same(got, want, path="record"):
    if isinstance(want, Image.Image):
        want = np.asarray(want)
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (path, got.dtype, want.dtype, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def label_set(rng, w, h):
    """uint8 label arrays for all seven experts, values as the generators
    write them."""
    return {
        "depth": rng.integers(0, 256, (h, w), dtype=np.uint8),
        "normal": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        "edge": rng.integers(0, 256, (h, w), dtype=np.uint8),
        "seg_coco": rng.integers(0, 134, (h, w), dtype=np.uint8),
        "seg_ade": rng.integers(0, 151, (h, w), dtype=np.uint8),
        "obj_detection": rng.choice([0, 3, 7, 255], (h, w)).astype(np.uint8),
        "ocr_detection": rng.choice([0, 1, 255], (h, w)).astype(np.uint8),
    }


@pytest.mark.parametrize("res", [384, 480])
@pytest.mark.parametrize("train", [True, False])
def test_transform_equals_jax(train, res):
    rng = np.random.default_rng(res + train)
    port_tf = transform.Transform(resize_resolution=res, train=train)
    jax_tf = jax_transform.Transform(resize_resolution=res, train=train)
    for seed in range(3):
        w, h = int(rng.integers(90, 640)), int(rng.integers(90, 480))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        labs = label_set(rng, w, h)
        if seed == 2:      # a label of another size: JAX's joint PIL path
            labs["edge"] = rng.integers(0, 256, (h // 2 + 3, w // 3 + 1),
                                        dtype=np.uint8)
        pil_labs = {e: Image.fromarray(a) for e, a in labs.items()}
        random.seed(seed)
        want = jax_tf(Image.fromarray(img), pil_labs)
        tail = random.random()
        random.seed(seed)
        got = port_tf(img, labs)
        assert random.random() == tail    # the streams stay in step
        assert_same(got, want, f"seed {seed}")
    random.seed(0)
    want = jax_tf(Image.fromarray(img), None)
    random.seed(0)
    assert_same(port_tf(img, None), want)


def test_randaugment_equals_jax_over_every_op():
    """rgb_and_coeffs at 224 px over enough seeds that each of the ten ops
    is drawn; the RNG streams stay in step."""
    rng = np.random.default_rng(11)
    port_ra, jax_ra_ = randaugment.RandAugment(2, 5), jax_ra.RandAugment(2, 5)
    drawn = set()
    for seed in range(24):
        img = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
        random.seed(seed)
        drawn |= {op[0] for op in random.choices(jax_ra.AUGMENT_OPS, k=2)}
        random.seed(seed)
        want_img, want_coeffs = jax_ra_.rgb_and_coeffs(Image.fromarray(img))
        tail_jax = random.random()
        random.seed(seed)
        got_img, got_coeffs = port_ra.rgb_and_coeffs(img)
        assert random.random() == tail_jax
        np.testing.assert_array_equal(got_img, np.asarray(want_img))
        assert got_coeffs == want_coeffs
    assert drawn == {op[0] for op in jax_ra.AUGMENT_OPS}
    assert randaugment.LABEL_FILL == jax_ra.LABEL_FILL
    assert randaugment.AUGMENT_OPS == jax_ra.AUGMENT_OPS


# ---------------------------------------------------------------------------
# a seeded tree of images, labels and sidecars
# ---------------------------------------------------------------------------

def write_image(path, rng, k):
    """JPEG 4:2:0, grey JPEG, or a PNG under a .jpg name (read by content)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    w, h = 40 + 4 * (k % 5), 30 + 2 * (k % 3)
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if k % 3 == 0:
        Image.fromarray(arr).save(path, "JPEG", quality=85, subsampling=2)
    elif k % 3 == 1:
        Image.fromarray(arr).convert("L").save(path, "JPEG", quality=80)
    else:
        Image.fromarray(arr).save(path, "PNG")
    return w, h


def write_labels(label_path, dataset, image_path, rng, k, w, h):
    """Every expert's files for one image, with the fallbacks by k % 4:
    0 all present; 1 depth, the detection json and the OCR sidecar
    missing; 2 depth an RGB PNG (read as L), normal a grey PNG (read as
    RGB), seg_coco an empty file; 3 edge of another size, OCR as .npz."""
    stem = os.path.splitext(image_path)[0]

    def path(exp, ext):
        p = os.path.join(label_path, exp, dataset, stem + ext)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    labs = label_set(rng, w, h)
    for exp in EXPERTS:
        arr = labs[exp]
        if exp == "depth" and k % 4 == 1:
            continue
        if exp == "depth" and k % 4 == 2:
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if exp == "normal" and k % 4 == 2:
            arr = arr[..., 0]
        if exp == "edge" and k % 4 == 3:
            arr = rng.integers(0, 256, (h // 2 + 1, w + 3), dtype=np.uint8)
        if exp == "seg_coco" and k % 4 == 2:
            open(path(exp, ".png"), "wb").close()
            continue
        Image.fromarray(arr).save(path(exp, ".png"))
    if k % 4 != 1:
        with open(path("obj_detection", ".json"), "w") as f:
            json.dump({"0": 17, "3": 5, "7": 60}, f)
        words = {0: {"features": torch.from_numpy(
                     rng.normal(size=64).astype(np.float32)), "text": "cat"},
                 1: {"features": torch.from_numpy(
                     rng.normal(size=64).astype(np.float32)), "text": "on"}}
        if k % 4 == 3:
            with open(path("ocr_detection", ".pt"), "wb") as f:
                np.savez(f, **{str(i): v["features"].numpy()
                               for i, v in words.items()},
                         **{f"text_{i}": v["text"] for i, v in words.items()})
        else:   # the pickle format: the JAX package reads no zip .pt
            torch.save(words, path("ocr_detection", ".pt"),
                       _use_new_zipfile_serialization=False)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    data, lab = str(root / "data"), str(root / "labels")
    k = 0

    def add(dataset_dir, dataset, image_path, base=None):
        nonlocal k
        full = os.path.join(base or data, dataset_dir, image_path)
        w, h = write_image(full, rng, k)
        write_labels(lab, dataset, image_path, rng, k, w, h)
        k += 1

    train = [{"image": f"train2014/t{i}.jpg", "caption": f"a dog #{i}: runs!",
              "image_id": i} for i in range(5)]
    test = [{"image": f"val2014/v{i}.jpg", "image_id": 100 + i}
            for i in range(3)]
    for r in train + test:
        add("vqav2", "vqav2", r["image"])
    vqa_train = [{"image": f"train2014/t{i}.jpg", "question": "what is it",
                  "answer": ["dog", "cat"], "weight": [0.6, 0.4],
                  "dataset": "vqa"} for i in range(2)]
    vg = [{"image": f"vg/g{i}.jpg", "question": "where?", "answer": ["here"],
           "dataset": "vg"} for i in range(2)]
    for r in vg:
        add("vg", "vg", r["image"])
    vqa_test = [{"image": "val2014/v0.jpg", "question": "is it red",
                 "question_id": 7, "dataset": "vqa"}]
    for name, obj in [("coco_karpathy_train.json", train),
                      ("coco_karpathy_test.json", test),
                      ("vqav2_train_val.json", vqa_train),
                      ("vg_qa.json", vg), ("vqav2_test.json", vqa_test),
                      ("answer_list.json", ["dog", "cat", "here"])]:
        with open(os.path.join(data, name), "w") as f:
            json.dump(obj, f)

    # pretraining corpora: CC12M / CC3M shards with .txt captions, VG
    for corpus, sub in (("cc12m", "cc12m"), ("cc3m", "cc3m_sgu")):
        for i in range(2):
            rel = f"00000/{corpus}_{i}.jpg"
            add(sub, sub, rel, base=str(root / corpus))
            with open(str(root / corpus / sub / rel).replace(".jpg", ".txt"),
                      "w") as f:
                f.write(f"A {corpus} photo, number {i}\nsecond line\n")
    vg_caps = [{"image": f"{root}/vgroot/vg/VG_100K/p{i}.jpg",
                "caption": "a tree"} for i in range(2)]
    for r in vg_caps:
        add("vg", "vg", "VG_100K/" + os.path.basename(r["image"]),
            base=str(root / "vgroot"))
    with open(root / "vgroot" / "vg_caption.json", "w") as f:
        json.dump(vg_caps, f)

    # few-shot ImageNet
    for split in ("imagenet_train", "imagenet"):
        for cls in ("n01", "n02"):
            for i in range(2):
                add(split, split, f"{cls}/{split}_{i}.JPEG")
    with open(os.path.join(data, "imagenet", "imagenet_answer.json"),
              "w") as f:
        json.dump(["goldfish", "tiger shark"], f)
    with open(os.path.join(data, "imagenet", "imagenet_class.json"),
              "w") as f:
        json.dump({"n01": 0, "n02": 1}, f)

    # a demo folder: <root>/helpers/images/*, labels keyed by 'helpers'
    for i in range(2):
        add("helpers", "helpers", f"images/d{i}.jpg", base=str(root))
    return root


def config(tree, **kw):
    cfg = {"data_path": str(tree / "data"), "label_path": str(tree / "labels"),
           "experts": EXPERTS, "image_resolution": 64, "dataset": "coco",
           "prefix": "A picture of", "datasets": ["vqav2", "vg"],
           "cc12m_data_path": str(tree / "cc12m"),
           "cc3m_data_path": str(tree / "cc3m"),
           "coco_data_path": str(tree / "data"),
           "vg_data_path": str(tree / "vgroot"), "shots": 1}
    cfg.update(kw)
    return cfg


def test_load_expert_labels_and_records_equal_jax(tree):
    data, lab = str(tree / "data"), str(tree / "labels")
    for k in range(5):
        image_path = f"train2014/t{k}.jpg"
        got = labels.load_expert_labels(data, lab, image_path, "vqav2",
                                        EXPERTS)
        want = jax_labels.load_expert_labels(data, lab, image_path, "vqav2",
                                             EXPERTS)
        assert_same(got[0], want[0], "image")
        assert_same(got[1], want[1], "labels")
        assert_same(got[2], want[2], "info")
        for train in (True, False):
            random.seed(k)
            rec_w = jax_labels.build_expert_record(
                jax_transform.Transform(64, train=train)(*want[:2]), want[2])
            random.seed(k)
            rec_g = labels.build_expert_record(
                transform.Transform(64, train=train)(*got[:2]), got[2])
            assert_same(rec_g, rec_w, f"record {k}")


def test_zip_format_ocr_sidecar_is_read(tmp_path):
    """A .pt that torch.save writes today is a zip archive; it is read with
    torch.load, an .npz by its .npy members."""
    words = {0: {"features": torch.arange(64, dtype=torch.float32),
                 "text": "cat"}}
    torch.save(words, tmp_path / "a.pt")
    got = labels._load_ocr_sidecar(str(tmp_path / "a.pt"))
    assert got.keys() == words.keys() and got[0]["text"] == "cat"
    assert torch.equal(got[0]["features"], words[0]["features"])
    with open(tmp_path / "b.pt", "wb") as f:
        np.savez(f, **{"0": np.ones(64, np.float32), "text_0": "on"})
    got = labels._load_ocr_sidecar(str(tmp_path / "b.pt"))
    assert got[0]["text"] == "on" and got[0]["features"].shape == (64,)


def _datasets(tree):
    cap = config(tree)
    yield "caption", datasets.create_dataset("caption", cap), \
        jax_datasets.create_dataset("caption", cap)
    yield "vqa", datasets.create_dataset("vqa", cap), \
        jax_datasets.create_dataset("vqa", cap)
    pre = config(tree, datasets=["cc12m", "cc3m_sgu", "coco", "vg"])
    yield "pretrain", (datasets.create_dataset("pretrain", pre),), \
        (jax_datasets.create_dataset("pretrain", pre),)
    yield "classification", datasets.create_dataset("classification", cap), \
        jax_datasets.create_dataset("classification", cap)
    demo = config(tree, dataset="demo", data_path=str(tree / "helpers"))
    yield "demo", datasets.create_dataset("caption", demo)[1:], \
        jax_datasets.create_dataset("caption", demo)[1:]


def test_datasets_equal_jax(tree):
    seen = []
    for name, port_sets, jax_sets in _datasets(tree):
        for port_ds, jax_ds in zip(port_sets, jax_sets):
            assert len(port_ds) == len(jax_ds) > 0, name
            for i in range(len(jax_ds)):
                random.seed(1000 + i)
                want = jax_ds[i]
                random.seed(1000 + i)
                got = port_ds[i]
                assert_same(got, want, f"{name}[{i}]")
            seen.append((name, len(jax_ds)))
    assert [s[0] for s in seen] == ["caption", "caption", "vqa", "vqa",
                                    "pretrain", "classification",
                                    "classification", "demo"]


def test_loader_index_order_equals_jax():
    class Toy:
        def __len__(self):
            return 23

        def __getitem__(self, i):
            return {"i": np.int64(i), "name": f"r{i}"}

    for kw in (dict(train=True, shard_id=1, num_shards=3),
               dict(train=True), dict(train=False, drop_last=True),
               dict(train=False, shard_id=0, num_shards=2)):
        port = loader.create_loader(Toy(), 4, num_workers=2,
                                    worker_type="thread", seed=5, **kw)
        jax_l = jax_loader.create_loader(Toy(), 4, num_workers=2,
                                         worker_type="thread", seed=5, **kw)
        assert len(port) == len(jax_l)
        for _ in range(2):   # two epochs: the shuffle moves with the epoch
            got, want = list(port), list(jax_l)
            assert len(got) == len(want) == len(port)
            for g, w in zip(got, want):
                assert_same(g, w)


def test_loader_raises_a_worker_error():
    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(f"record {i}")

    with pytest.raises(KeyError, match="record"):
        list(loader.DataLoader(Bad(), 2, train=False, num_workers=1))


class Draws:
    """Records that are draws of the module-level `random`. Each worker's
    first record waits at a barrier for the other worker's, so that both
    workers take part however the pool hands out the indices."""

    def __init__(self, workers: int):
        self.barrier = multiprocessing.get_context("fork").Barrier(workers)
        self.started = set()      # each forked worker has its own copy

    def __len__(self):
        return 16

    def __getitem__(self, i):
        if os.getpid() not in self.started:
            self.started.add(os.getpid())
            self.barrier.wait(timeout=60)
        return {"draw": np.float64(random.random()), "pid": np.int64(
            os.getpid())}


def test_process_workers_draw_differently():
    random.seed(0)
    batches = list(loader.DataLoader(Draws(2), 8, train=False,
                                     num_workers=2, worker_type="process"))
    draws = np.concatenate([b["draw"] for b in batches])
    pids = set(np.concatenate([b["pid"] for b in batches]).tolist())
    assert len(pids) == 2 and os.getpid() not in pids
    assert len(set(draws.tolist())) == len(draws) == 16


def test_experts_to_device_and_materialize_equal_jax(tree):
    ds = datasets.Caption(config(tree), train=True)
    random.seed(3)
    batch = loader.default_collate([ds[0], ds[1]])["experts"]
    raw = device.experts_to_device(batch, "cpu")
    assert raw["rgb"].dtype == torch.uint8 and raw["rgb"].device.type == "cpu"
    got = device.materialize_experts(raw)
    want = jax_device.materialize_experts(
        {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
             if isinstance(v, dict) else jnp.asarray(v))
         for k, v in batch.items()})
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            for kk in w:
                np.testing.assert_array_equal(g[kk].numpy(),
                                              np.asarray(w[kk]))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=k)
