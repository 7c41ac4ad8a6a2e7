"""Expert-label visualization, ported from prismer_tpu/cli/demo_vis.py
(reference: demo_vis.py).

  python -m prismer_tpu_torch.cli.demo_vis --image helpers/images/x.jpg \\
      --label_path helpers/labels --out vis.png

The reference's 7-panel figure: RGB + caption, depth (plasma-style
colormap), surface normal, edge, and the three id-map experts in a fixed
per-id palette (demo_vis.py:122-161), drawn on the host with numpy: the
image read by the port's JPEG / PNG decoders, Pillow's BILINEAR and
NEAREST resizes (data/pil_warp.py), the figure written as PNG. The panels
equal the JAX package's pixel for pixel. The panel names and the caption
are drawn with Pillow's built-in bitmap font (courB08), carried as
assets/default_font.npz (tools/dump_default_font.py); where Pillow has
FreeType, the JAX package draws them with its FreeType default instead.
The figure is drawn on the host and needs no device, so this entry point,
unlike the drivers, takes no --device and runs where CUDA is absent.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from prismer_tpu_torch.data.labels import read_rgb
from prismer_tpu_torch.data.pil_warp import (resize_bilinear_u8,
                                             resize_nearest_u8)
from prismer_tpu_torch.data.png import read_png, write_png

ROOT = Path(__file__).resolve().parents[2]
ADE20K_COLORMAP = ROOT / "prismer_tpu" / "assets" / "ade20k_colormap.npy"
FONT_PATH = Path(__file__).resolve().parents[1] / "assets" / "default_font.npz"
EXPERTS = ("depth", "normal", "edge", "seg_coco", "obj_detection",
           "ocr_detection")
MISSING = (32, 32, 32)
PAD, HEADER = 4, 20

_FONT: Dict[str, np.ndarray] = {}


def ade20k_colormap() -> np.ndarray:
    """The ADE20K benchmark colormap (151, 3) u8 (reference utils.py:
    44-201), read by path from the JAX package's asset."""
    return np.load(ADE20K_COLORMAP)


def _palette(n: int = 256, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pal = rng.integers(40, 255, (n, 3)).astype(np.uint8)
    pal[255] = (0, 0, 0)  # background
    return pal


def _plasma(gray: np.ndarray) -> np.ndarray:
    """Cheap perceptual colormap for depth maps (u8 -> RGB u8)."""
    t = gray.astype(np.float32) / 255.0
    r = np.clip(3.0 * t - 0.5, 0, 1)
    g = np.clip(1.5 * t, 0, 1) * (1 - 0.5 * t)
    b = np.clip(1.5 - 2.0 * t, 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def load_panel(label_path: str, exp: str, rel_dir: str, fname: str,
               size: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) u8 panel of one expert's label; a missing file gives a
    grey panel."""
    p = os.path.join(label_path, exp, rel_dir, fname)
    if not os.path.exists(p):
        return np.full((size[1], size[0], 3), MISSING, np.uint8)
    arr = read_png(p, "L" if exp != "normal" else "RGB")
    if exp == "depth":
        out = _plasma(arr)
    elif exp == "normal":
        out = arr
    elif exp == "edge":
        out = np.stack([arr] * 3, -1)
    elif exp == "seg_ade":
        # ids >= 151 (incl. 255 background) wrap into the palette
        cmap = ade20k_colormap()
        out = np.concatenate([cmap, _palette()[len(cmap):]])[arr]
    else:  # id maps
        out = _palette()[arr]
    return resize_nearest_u8(out, size)


def _font() -> Dict[str, np.ndarray]:
    if not _FONT:
        z = np.load(FONT_PATH)
        _FONT.update(metrics=z["metrics"].astype(np.int64), sheet=z["sheet"])
    return _FONT


def text_mask(text: str) -> np.ndarray:
    """(ysize, width) u8 mask of `text` in the bitmap font, as Pillow's
    ImageFont.getmask lays it out: each glyph's box pasted at the pen
    (later glyphs over earlier ones), the pen moved by the glyph's
    advance. The font covers Latin-1; other characters are drawn as '?'
    (Pillow raises on them)."""
    font = _font()
    m, sheet = font["metrics"], font["sheet"]
    codes = list(text.encode("latin-1", errors="replace"))
    y0 = min(0, int(m[:, 3].min()))
    ysize = max(0, int(m[:, 5].max())) - y0
    mask = np.zeros((ysize, int(sum(m[c, 0] for c in codes))), np.uint8)
    x, base = 0, -y0
    for c in codes:
        dx, dy, dx0, dy0, dx1, dy1, sx0, sy0, sx1, sy1 = (int(v) for v
                                                          in m[c])
        glyph = sheet[sy0:sy1, sx0:sx1]
        _paste(mask, glyph, dx0 + x, dy0 + base)
        x += dx
        base += dy
    return mask


def _paste(dst: np.ndarray, src: np.ndarray, x: int, y: int,
           where: Optional[np.ndarray] = None) -> None:
    """Copy src into dst at (x, y), clipped to dst; with `where`, only
    where that mask is set (src is then a colour)."""
    h, w = (where if where is not None else src).shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, dst.shape[1]), min(y + h, dst.shape[0])
    if x1 <= x0 or y1 <= y0:
        return
    if where is None:
        dst[y0:y1, x0:x1] = src[y0 - y:y1 - y, x0 - x:x1 - x]
    else:
        sel = where[y0 - y:y1 - y, x0 - x:x1 - x] > 0
        dst[y0:y1, x0:x1][sel] = src


def draw_text(canvas: np.ndarray, xy: Tuple[int, int], text: str,
              fill: Tuple[int, int, int]) -> None:
    """ImageDraw.text(xy, text, fill, font=<the bitmap font>)."""
    _paste(canvas, np.asarray(fill, np.uint8), xy[0], xy[1],
           where=text_mask(text))


def figure(image: str, label_path: str, panel: int) -> np.ndarray:
    """The (H, W, 3) u8 figure of one image."""
    parts = image.split("/")
    rel_dir = os.path.join(parts[-3], parts[-2])
    ext = image.split(".")[-1]
    fname = parts[-1].replace(f".{ext}", ".png")
    size = (panel, panel)

    panels = [("rgb", resize_bilinear_u8(read_rgb(image), size))]
    for exp in EXPERTS:
        panels.append((exp, load_panel(label_path, exp, rel_dir, fname,
                                       size)))

    caption_path = os.path.splitext(image)[0] + ".txt"
    caption = ""
    if os.path.exists(caption_path):
        with open(caption_path) as f:
            caption = f.read().strip()

    w = len(panels) * (panel + PAD) + PAD
    h = panel + 2 * PAD + HEADER
    canvas = np.full((h, w, 3), 255, np.uint8)
    for i, (_, img) in enumerate(panels):
        x = PAD + i * (panel + PAD)
        _paste(canvas, img, x, PAD + HEADER)
    for i, (name, _) in enumerate(panels):
        draw_text(canvas, (PAD + i * (panel + PAD), 2), name, (0, 0, 0))
    if caption:
        draw_text(canvas, (PAD, PAD + HEADER - 14), f"caption: {caption}",
                  (60, 60, 60))
    return canvas


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image", required=True)
    ap.add_argument("--label_path", default="helpers/labels")
    ap.add_argument("--out", default="")
    ap.add_argument("--panel", type=int, default=256)
    args = ap.parse_args(argv)

    out = args.out or os.path.splitext(args.image)[0] + "_vis.png"
    write_png(out, figure(args.image, args.label_path, args.panel))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
