"""Offline expert-label generator, ported from prismer_tpu/experts/generate.py
for the segmentation experts:

  python -m prismer_tpu_torch.experts.generate --task seg_coco \\
      --data_path D --save_path S [--batch_size 16 --image_size 480 \\
      --shard_id 0 --num_shards 1 --device cuda]

Globs D/*/ for images, runs the Mask2Former expert batch by batch on the
device in fp32 (TF32 off for the run), and writes one grey id PNG per image at the image's original size
under S/<task>/<parent>/<folder>/: the per-pixel argmax of the semantic
logits (ties to the lowest class id), resized with PIL's NEAREST rule.
Images are read as RGB by `data.labels.read_rgb` (PNG through `data.png`,
JPEG through the port's decoder, both equal to PIL's); other formats
raise. The files are
sharded by --shard_id / --num_shards as the reference shards its processes.
It runs on the CUDA device unless --device cpu is given, and refuses to
start when there is no CUDA device and the CPU was not asked for.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from prismer_tpu_torch.data.labels import read_rgb
from prismer_tpu_torch.data.pil_warp import resize_nearest_u8
from prismer_tpu_torch.data.png import write_png
from prismer_tpu_torch.experts.model_bank import load_expert_model

TASKS = ["depth", "normal", "edge", "seg_coco", "seg_ade", "obj_detection",
         "ocr_detection"]


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


def run_segmentation(args, task: str) -> None:
    device = torch.device(getattr(args, "device", "cuda"))
    model, preprocess = load_expert_model(
        task, getattr(args, "image_size", 480), device)
    save_root = os.path.join(args.save_path, task)
    files = list_images(args.data_path)[args.shard_id::args.num_shards]
    bs = args.batch_size
    t0 = time.perf_counter()
    for i in range(0, len(files), bs):
        chunk = files[i:i + bs]
        sizes, batch = [], []
        for p in chunk:
            img = read_rgb(p)
            sizes.append((img.shape[1], img.shape[0]))
            batch.append(preprocess(img))
        x = torch.from_numpy(np.stack(batch)).to(device)
        with torch.no_grad():
            sem = model(x)
        labels = sem.argmax(dim=1).to(torch.uint8).cpu().numpy()
        for k, p in enumerate(chunk):
            rel_dir, fname = save_rel_path(p)
            os.makedirs(os.path.join(save_root, rel_dir), exist_ok=True)
            write_png(os.path.join(save_root, rel_dir, fname),
                      resize_nearest_u8(labels[k], sizes[k]))
        print(f"[{task}] {min(i + bs, len(files))}/{len(files)} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)


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
    if args.task not in ("seg_coco", "seg_ade"):
        raise NotImplementedError(
            f"--task {args.task} is not ported to prismer_tpu_torch yet "
            f"(ROADMAP §1 item 8, the other label experts)")
    # the experts compute in fp32, as the JAX package does: cuDNN would
    # otherwise run the convolutions in TF32 (torch's default). The flags
    # are process-wide, so they are restored when the run ends.
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        run_segmentation(args, args.task)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
