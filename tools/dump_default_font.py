"""Dump Pillow's built-in bitmap font for the port's figure text.

    python tools/dump_default_font.py [--check]

`ImageFont.load_default_imagefont()` is the PIL-format bitmap font (courB08)
that `ImageDraw.text` draws with where Pillow has no FreeType. This script
captures its glyph metrics (256 x 10 big-endian shorts: dx, dy, dx0, dy0,
dx1, dy1, sx0, sy0, sx1, sy1) and its glyph sheet, and writes them to
prismer_tpu_torch/assets/default_font.npz, which `cli/demo_vis.py` renders
from without Pillow. It then checks the port's renderer
(`demo_vis.text_mask`) against `font.getmask` on every Latin-1 character and
a sample line. `--check` compares the committed file with a fresh dump and
writes nothing. Needs Pillow.
"""

from __future__ import annotations

import argparse
import io
import sys
from pathlib import Path

import numpy as np
from PIL import Image, ImageFont

ROOT = Path(__file__).resolve().parents[1]
DST = ROOT / "prismer_tpu_torch" / "assets" / "default_font.npz"
SAMPLE = ("caption: a man riding a wave on top of a surfboard. "
          "depth normal edge seg_coco obj_detection ocr_detection 0123456789")


def capture():
    """(metrics (256, 10) int16, sheet (H, W) uint8 0/255) of the font."""
    seen = {}
    load = ImageFont.ImageFont._load_pilfont_data

    def spy(self, file, image):
        pos = file.tell()
        seen["raw"] = file.read()
        file.seek(pos)
        seen["sheet"] = np.asarray(image.convert("L")).copy()
        return load(self, file, image)

    ImageFont.ImageFont._load_pilfont_data = spy
    try:
        font = ImageFont.load_default_imagefont()
    finally:
        ImageFont.ImageFont._load_pilfont_data = load
    f = io.BytesIO(seen["raw"])
    if f.readline() != b"PILfont\n":
        raise SystemExit("not a PILfont stream")
    f.readline()
    while f.readline() not in (b"DATA\n", b""):
        pass
    metrics = np.frombuffer(f.read(256 * 20), ">i2").reshape(256, 10)
    return font, metrics.astype(np.int16), seen["sheet"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    font, metrics, sheet = capture()
    if args.check:
        z = np.load(DST)
        same = (np.array_equal(z["metrics"], metrics)
                and np.array_equal(z["sheet"], sheet))
        print("default_font.npz is current" if same else
              "default_font.npz differs from Pillow's font")
        return 0 if same else 1
    np.savez_compressed(DST, metrics=metrics, sheet=sheet)
    print(f"wrote {DST.relative_to(ROOT)}: sheet {sheet.shape}")

    sys.path.insert(0, str(ROOT))
    from prismer_tpu_torch.cli import demo_vis
    demo_vis._FONT.clear()
    texts = [chr(c) for c in range(32, 256)] + [SAMPLE]
    for text in texts:
        core = font.getmask(text)
        want = np.asarray(Image.Image()._new(core).convert("L")) > 0
        got = demo_vis.text_mask(text) > 0
        if got.shape != want.shape or not np.array_equal(got, want):
            print(f"renderer differs from Pillow on {text!r}")
            return 1
    print(f"renderer equals font.getmask on {len(texts)} texts")
    return 0


if __name__ == "__main__":
    sys.exit(main())
