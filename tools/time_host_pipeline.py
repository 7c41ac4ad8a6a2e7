"""Time the port's host data pipeline, stage by stage, on the CPU it runs on.

    python tools/time_host_pipeline.py [--records 12] [--runs 20]

Medians over --runs calls of: the JPEG decoder on each 640 x 480 fixture
of tests/data/jpeg; the BICUBIC resize of a 640 x 480 image to 480 x 480;
the BILINEAR affine (a RandAugment shear) and NEAREST rotate of a 480 px
image; then the per-record time of `Caption(train=True)` at 480 px over a
temporary COCO tree of --records records (the fixtures, with random label
PNGs for the six experts), split by stage with cProfile's cumulative
times. Where Pillow is importable, its time for the same resize and affine
is printed beside the port's. Prints one line per figure; the figures are
of the CPU it runs on, not of any accelerator.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import random
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from prismer_tpu_torch import native  # noqa: E402
from prismer_tpu_torch.data import create_dataset, png  # noqa: E402
from prismer_tpu_torch.data import pil_warp  # noqa: E402

FIXTURES = ROOT / "tests" / "data" / "jpeg"
EXPERTS = ("depth", "normal", "seg_coco", "edge", "obj_detection",
           "ocr_detection")
STAGES = {"jpeg decode": "decode_jpeg", "label PNGs": "read_png",
          "BICUBIC resize": "resize_bicubic_u8",
          "BILINEAR affines": "affine_bilinear_u8",
          "NEAREST rotate": "rotate_nearest_u8", "sharpness": "sharpness",
          "equalize": "equalize", "autocontrast": "autocontrast",
          "records": "build_expert_record"}


def median_ms(fn, runs: int) -> float:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def build_tree(root: Path, n: int) -> dict:
    rng = np.random.default_rng(0)
    big = sorted(p for p in FIXTURES.glob("*.jpg")
                 if native.decode_jpeg_shape(p.read_bytes()) == (480, 640))
    records = []
    for i in range(n):
        image = f"train2014/COCO_train2014_{i:012d}.jpg"
        path = root / "vqav2" / image
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(big[i % len(big)].read_bytes())
        for exp in EXPERTS:
            shape = (15, 20, 3) if exp == "normal" else (15, 20)
            cells = rng.integers(0, 134, shape, dtype=np.uint8)
            arr = np.ascontiguousarray(cells.repeat(32, 0).repeat(32, 1))
            out = root / "labels" / exp / "vqav2" / image.replace(".jpg",
                                                                  ".png")
            out.parent.mkdir(parents=True, exist_ok=True)
            png.write_png(str(out), arr)
        records.append({"image": image, "caption": "a photo"})
    (root / "coco_karpathy_train.json").write_text(json.dumps(records))
    (root / "coco_karpathy_test.json").write_text("[]")
    return {"data_path": str(root), "label_path": str(root / "labels"),
            "experts": list(EXPERTS), "image_resolution": 480,
            "dataset": "coco"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=12)
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args(argv)
    native.build()
    for p in sorted(FIXTURES.glob("*.jpg")):
        data = p.read_bytes()
        if native.decode_jpeg_shape(data) == (480, 640):
            print(f"decode_jpeg {p.name}: "
                  f"{median_ms(lambda: native.decode_jpeg(data), args.runs):.2f}"
                  f" ms")
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    sq = rng.integers(0, 256, (480, 480, 3), dtype=np.uint8)
    shear = (1.0, 0.15, 0.0, 0.0, 1.0, 0.0)
    ports = {
        "BICUBIC 640x480 -> 480": lambda: pil_warp.resize_bicubic_u8(
            img, (480, 480)),
        "BILINEAR affine 480 px": lambda: pil_warp.affine_bilinear_u8(
            sq, shear, (0, 0, 0)),
        "NEAREST rotate 480 px": lambda: pil_warp.rotate_nearest_u8(
            sq, 15.0, (0, 0, 0)),
    }
    try:
        from PIL import Image
        pil = {
            "BICUBIC 640x480 -> 480": lambda: Image.fromarray(img).resize(
                (480, 480), Image.BICUBIC),
            "BILINEAR affine 480 px": lambda: Image.fromarray(sq).transform(
                (480, 480), Image.AFFINE, shear, Image.BILINEAR,
                fillcolor=(0, 0, 0)),
            "NEAREST rotate 480 px": lambda: Image.fromarray(sq).rotate(
                15.0, fillcolor=(0, 0, 0)),
        }
    except ImportError:
        pil = {}
    for name, fn in ports.items():
        line = f"{name}: port {median_ms(fn, args.runs):.2f} ms"
        if name in pil:
            line += f", Pillow {median_ms(pil[name], args.runs):.2f} ms"
        print(line)

    with tempfile.TemporaryDirectory() as tmp:
        train, _ = create_dataset("caption", build_tree(Path(tmp),
                                                        args.records))
        random.seed(0)
        train[0]
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for i in range(len(train)):
            train[i]
        prof.disable()
        per = (time.perf_counter() - t0) * 1e3 / len(train)
    stats = pstats.Stats(prof).stats
    cum = {}
    for (_, _, func), (_, _, _, ct, _) in stats.items():
        cum[func] = cum.get(func, 0.0) + ct
    print(f"Caption(train) 480 px: {per:.1f} ms a record over "
          f"{args.records} records (cProfile on)")
    for label, func in STAGES.items():
        if func in cum:
            print(f"  {label}: {cum[func] * 1e3 / args.records:.1f} ms a "
                  f"record")
    return 0


if __name__ == "__main__":
    sys.exit(main())
