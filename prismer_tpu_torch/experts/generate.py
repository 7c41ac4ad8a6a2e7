"""Offline expert-label generator, ported from
prismer_tpu/experts/generate.py:

  python -m prismer_tpu_torch.experts.generate --task depth \\
      --data_path D --save_path S [--batch_size 16 --image_size 480 \\
      --shard_id 0 --num_shards 1 --device cuda]

Globs D/*/ for images, runs the expert on the device in fp32 (TF32 off for
the run) and writes each image's label file at the image's original size
under S/<task>/<parent>/<folder>/, where `data.labels` reads it:

  depth          min-max normalised, then mode F -> L (truncated, clipped
                 to [0, 255]) and a BILINEAR resize: grey PNG
  normal         the finest prediction's xyz from [-1, 1] to [0, 1], * 255
                 truncated to uint8, BILINEAR resize: RGB PNG
  edge           sigmoid of the fused map, min-max normalised, 255 - uint8,
                 BILINEAR resize: grey PNG
  seg_coco/_ade  per-pixel argmax of the semantic logits (ties to the
                 lowest class), NEAREST resize: grey id PNG
  obj_detection  one image at a time: UniDet detections with score >= 0.5,
                 ordered by occlusion with the depth labels already written
                 (zeros when missing), NEAREST resize: grey id PNG and an
                 instance -> class JSON
  ocr_detection  one image at a time: CharNet words stamped in reversed
                 order with ids 0, 1, ... (`ocr_detection.fill.fill_poly`,
                 cv2.fillPoly's rule), and an `np.savez` sidecar `.pt` of
                 each word's CLIP text feature through the PCA (the
                 background vector, with a warning, when the CLIP weights
                 or vocabulary are missing); an image with no words writes
                 nothing.

The detection tasks work at 480 x 480 (the depth map's resize, the boxes'
clip) whatever --image_size is, as the JAX package does. Images are read
as RGB by `data.labels.read_rgb` (PNG through `data.png`, JPEG through the
port's decoder, both equal to PIL's); other formats raise. The files are
sharded by --shard_id / --num_shards as the reference shards its
processes. It runs on the CUDA device unless --device cpu is given, and
refuses to start when there is no CUDA device and the CPU was not asked
for. Each run leaves its image count, wall time (from the model's build,
not included, to the last file) and device time (CUDA events on the card)
in `LAST_RUN`.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from prismer_tpu_torch.data.labels import read_rgb
from prismer_tpu_torch.data.pil_warp import (resize_bilinear_u8,
                                             resize_nearest_u8)
from prismer_tpu_torch.data.png import read_png, write_png
from prismer_tpu_torch.experts.model_bank import load_expert_model

TASKS = ["depth", "normal", "edge", "seg_coco", "seg_ade", "obj_detection",
         "ocr_detection"]
DETECTION_SIZE = 480    # the JAX package's fixed size for the two detectors
LAST_RUN: Dict[str, float] = {}


def list_images(data_path: str) -> List[str]:
    folders = glob.glob(f"{data_path}/*/")
    out = []
    for f in folders:
        for pat in ("*.jpg", "*.png", "*.jpeg", "*.JPEG"):
            out.extend(glob.glob(f + pat))
    return sorted(out)


def save_rel_path(img_path: str) -> Tuple[str, str]:
    parts = img_path.split("/")
    ext = img_path.split(".")[-1]
    rel_dir = os.path.join(parts[-3], parts[-2])
    fname = parts[-1].replace(f".{ext}", ".png")
    return rel_dir, fname


class DeviceTimer:
    """Sums the time of the device segments run under `with timer():`:
    CUDA events on a CUDA device, the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pairs: List = []
        self.host_s = 0.0

    @contextlib.contextmanager
    def __call__(self):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.pairs.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.host_s += time.perf_counter() - t0

    def seconds(self) -> float:
        if not self.cuda:
            return self.host_s
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3


class _Run:
    """The files of this shard, the device, the save root and the timer;
    the wall clock starts at `start()`, once the model is built."""

    def __init__(self, args, task: str):
        self.task = task
        self.device = torch.device(getattr(args, "device", "cuda"))
        self.size = getattr(args, "image_size", 480)
        self.root = os.path.join(args.save_path, task)
        self.files = list_images(args.data_path)[
            args.shard_id::args.num_shards]
        self.timer = DeviceTimer(self.device)
        self.t0 = time.perf_counter()

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def out_path(self, img_path: str, ext: str = ".png") -> str:
        rel_dir, fname = save_rel_path(img_path)
        os.makedirs(os.path.join(self.root, rel_dir), exist_ok=True)
        return os.path.join(self.root, rel_dir,
                            fname.replace(".png", ext))

    def progress(self, done: int) -> None:
        print(f"[{self.task}] {done}/{len(self.files)} "
              f"({time.perf_counter() - self.t0:.2f} s)", flush=True)

    def finish(self) -> None:
        wall = time.perf_counter() - self.t0
        dev = self.timer.seconds()
        n = len(self.files)
        LAST_RUN.clear()
        LAST_RUN.update(task=self.task, images=n, wall_s=wall, device_s=dev,
                        host_s=wall - dev)
        print(f"[{self.task}] {n} images in {wall:.2f} s "
              f"({n / max(wall, 1e-9):.2f} images/s): device {dev:.2f} s, "
              f"host {wall - dev:.2f} s", flush=True)


def f_to_l(x: np.ndarray) -> np.ndarray:
    """PIL's mode F -> L conversion: truncated toward zero, clipped to
    [0, 255], NaN to 0."""
    with np.errstate(invalid="ignore"):
        return np.where(x >= 255, 255, np.where(x > 0, np.trunc(x), 0)
                        ).astype(np.uint8)


def depth_post(pred: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W) inverse depth -> grey uint8 at `size` (W, H)."""
    d = np.asarray(pred, np.float32)
    d = (d - d.min()) / (d.max() - d.min() + 1e-12)
    return resize_bilinear_u8(f_to_l(255 * d), size)


def normal_post(pred: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) xyz of the finest prediction -> RGB uint8 at `size`."""
    n = np.clip((np.asarray(pred, np.float32) + 1.0) * 0.5, 0, 1)
    return resize_bilinear_u8((n * 255).astype(np.uint8), size)


def edge_post(pred: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W) fused edge logits -> grey uint8 at `size`."""
    with np.errstate(over="ignore"):
        e = 1.0 / (1.0 + np.exp(-np.asarray(pred, np.float32)))
    e = (e - e.min()) / (e.max() - e.min() + 1e-12)
    return resize_bilinear_u8(255 - (255 * e).astype(np.uint8), size)


DENSE_POST = {"depth": depth_post, "normal": normal_post, "edge": edge_post}


def _dense_output(task: str, preds) -> torch.Tensor:
    """The part of a batch's predictions that the label is made from."""
    if task == "depth":
        return preds
    if task == "normal":
        return preds[-1][..., :3]
    if task == "edge":
        return preds[-1][..., 0]
    return preds.argmax(dim=1).to(torch.uint8)     # segmentation


def run_batched(args, task: str) -> None:
    """depth, normal, edge, seg_coco and seg_ade: batches of
    --batch_size images."""
    run = _Run(args, task)
    model, preprocess = load_expert_model(task, run.size, run.device)
    run.start()
    bs = args.batch_size
    for i in range(0, len(run.files), bs):
        chunk = run.files[i:i + bs]
        sizes, batch = [], []
        for p in chunk:
            img = read_rgb(p)
            sizes.append((img.shape[1], img.shape[0]))
            batch.append(preprocess(img))
        with run.timer(), torch.no_grad():
            x = torch.from_numpy(np.stack(batch)).to(run.device)
            out = _dense_output(task, model(x)).cpu().numpy()
        for k, p in enumerate(chunk):
            if task in DENSE_POST:
                label = DENSE_POST[task](out[k], sizes[k])
            else:
                label = resize_nearest_u8(out[k], sizes[k])
            write_png(run.out_path(p), label)
        run.progress(min(i + bs, len(run.files)))
    run.finish()


def read_depth_label(path: str, size: int) -> np.ndarray:
    """The depth label PNG as float32 in [0, 1] at size x size (PIL's
    convert('L') and BILINEAR resize); zeros when the file is missing."""
    if not os.path.exists(path):
        return np.zeros((size, size), np.float32)
    grey = read_png(path, "L")
    return resize_bilinear_u8(grey, (size, size)).astype(np.float32) / 255.0


def run_objdet(args) -> None:
    """Occlusion-ordered instance mask + instance -> class JSON; the depth
    labels order the instances."""
    from prismer_tpu_torch.experts.obj_detection.rcnn import detect_single
    from prismer_tpu_torch.experts.objdet_postprocess import \
        occlusion_ordered_mask

    run = _Run(args, "obj_detection")
    model, preprocess = load_expert_model("obj_detection", run.size,
                                          run.device)
    run.start()
    depth_root = os.path.join(args.save_path, "depth")
    size = DETECTION_SIZE
    for n, p in enumerate(run.files):
        img = read_rgb(p)
        h0, w0 = img.shape[:2]
        x = torch.from_numpy(preprocess(img)[None]).to(run.device)
        boxes, scores, classes = detect_single(model, x, (size, size),
                                               run.timer)
        keep = scores >= 0.5   # DefaultPredictor's confidence threshold
        rel_dir, fname = save_rel_path(p)
        depth = read_depth_label(os.path.join(depth_root, rel_dir, fname),
                                 size)
        mask, labels = occlusion_ordered_mask(depth, boxes[keep],
                                              classes[keep])
        write_png(run.out_path(p), resize_nearest_u8(mask, (w0, h0)))
        with open(run.out_path(p, ".json"), "w") as f:
            json.dump(labels, f)
        run.progress(n + 1)
    run.finish()


def run_ocr(args) -> None:
    """Word polygons -> id mask + per-word CLIP (PCA) feature sidecar."""
    from prismer_tpu_torch.data.features import get_feature_tables
    from prismer_tpu_torch.experts.clip_text import (embed_words,
                                                     load_clip_text)
    from prismer_tpu_torch.experts.ocr_detection.fill import fill_poly
    from prismer_tpu_torch.experts.ocr_detection.postprocess import \
        OrientedTextPostProcessing

    run = _Run(args, "ocr_detection")
    model, preprocess = load_expert_model("ocr_detection", run.size,
                                          run.device)
    post = OrientedTextPostProcessing()
    tables = get_feature_tables()
    clip_ctx = load_clip_text(device=run.device)
    run.start()
    if clip_ctx is None:
        warnings.warn(
            "[prismer_tpu_torch] OCR word features: converted CLIP text "
            "weights or BPE vocab not found under PRISMER_EXPERT_WEIGHTS - "
            "sidecars will carry the background vector instead of CLIP+PCA "
            "embeddings.", stacklevel=2)
    size = DETECTION_SIZE
    for n, p in enumerate(run.files):
        img = read_rgb(p)
        h0, w0 = img.shape[:2]
        with run.timer(), torch.no_grad():
            x = torch.from_numpy(preprocess(img)[None]).to(run.device)
            preds = {k: v[0].cpu().numpy() for k, v in model(x).items()}
        words = post(preds, scale_w=w0 / size, scale_h=h0 / size, W=w0,
                     H=h0)
        run.progress(n + 1)
        if not words:
            continue
        mask = np.full((h0, w0), 255, np.uint8)
        texts = []
        for i, wd in enumerate(reversed(words)):   # stamped reversed
            poly = np.asarray(wd.word_bbox, np.float32).reshape(4, 2)
            fill_poly(mask, poly.astype(np.int32), i)
            texts.append(wd.text.lower())
        if clip_ctx is not None:
            with run.timer():
                word_feats = embed_words(texts, clip_ctx, tables)
        else:
            word_feats = np.tile(tables.background, (len(texts), 1))
        sidecar = {}
        for i, text in enumerate(texts):
            sidecar[str(i)] = word_feats[i].astype(np.float32)
            sidecar[f"text_{i}"] = np.array(text)
        write_png(run.out_path(p), mask)
        with open(run.out_path(p, ".pt"), "wb") as f:
            np.savez(f, **sidecar)
    run.finish()


def _read_config(path: str) -> dict:
    """Top-level `key: value` scalars of a flat YAML file (the keys
    data_path and save_path are read)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].rstrip()
            if not line or line[0].isspace() or ":" not in line:
                continue
            key, value = line.split(":", 1)
            out[key.strip()] = value.strip().strip("'\"")
    return out


def run_task(args) -> None:
    if args.task == "obj_detection":
        run_objdet(args)
    elif args.task == "ocr_detection":
        run_ocr(args)
    else:
        run_batched(args, args.task)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", required=True, choices=TASKS)
    ap.add_argument("--config", default="")
    ap.add_argument("--data_path", default="helpers")
    ap.add_argument("--save_path", default="helpers/labels")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--image_size", type=int, default=480,
                    help="expert input resolution (labels are resized back "
                         "to the original image size regardless)")
    ap.add_argument("--shard_id", type=int, default=0)
    ap.add_argument("--num_shards", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.config:
        cfg = _read_config(args.config)
        args.data_path = cfg.get("data_path", args.data_path)
        args.save_path = cfg.get("save_path", args.save_path)
    if args.device != "cpu" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")
    # the experts compute in fp32, as the JAX package does: cuDNN would
    # otherwise run the convolutions in TF32 (torch's default). The flags
    # are process-wide, so they are restored when the run ends.
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        run_task(args)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
