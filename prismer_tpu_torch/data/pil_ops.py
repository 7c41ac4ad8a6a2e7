"""Pillow's pixel operations of the data path, bit-exact, in numpy.

The machine with the card has no PIL. RandAugment's photometric ops and the
mode conversions of the label and image readers are computed here exactly
as Pillow computes them on 8-bit images (uint8 numpy arrays, (H, W) for
"L", (H, W, 3) for "RGB"):

  * `autocontrast`, `equalize`: ImageOps' histogram and lookup table, per
    channel, in Pillow's own Python arithmetic (lookup values clipped to
    0..255 as `Image.point` does);
  * `blend`: `Image.blend` (ImagingBlend: a float32 alpha, truncation inside
    0..1, clamping outside it, a copy of either image at 0 or 1);
  * `brightness`, `sharpness`: ImageEnhance, a blend with a black image or
    with the 3x3 SMOOTH filter (kernel 1 1 1 / 1 5 1 / 1 1 1 over 13 in
    float32, + 0.5, truncated; the border rows and columns copied);
  * `to_mode`: the "L" and "RGB" conversions of grey, RGB and RGBA arrays
    (`rgb_to_l`: ITU-R 601-2 luma in 16-bit fixed point).
"""

from __future__ import annotations

import numpy as np


def _histograms(img: np.ndarray):
    chans = img[..., None] if img.ndim == 2 else img
    return [np.bincount(chans[..., c].ravel(), minlength=256).tolist()
            for c in range(chans.shape[-1])]


def _apply_luts(img: np.ndarray, luts) -> np.ndarray:
    luts = [np.clip(np.asarray(l), 0, 255).astype(np.uint8) for l in luts]
    if img.ndim == 2:
        return luts[0][img]
    return np.stack([luts[c][img[..., c]] for c in range(img.shape[-1])],
                    axis=-1)


def autocontrast(img: np.ndarray) -> np.ndarray:
    """`ImageOps.autocontrast(image)` (cutoff 0, no ignore, no mask)."""
    luts = []
    for h in _histograms(img):
        lo = next((i for i in range(256) if h[i]), 255)
        hi = next((i for i in range(255, -1, -1) if h[i]), 0)
        if hi <= lo:
            luts.append(list(range(256)))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append([min(max(int(ix * scale + offset), 0), 255)
                     for ix in range(256)])
    return _apply_luts(img, luts)


def equalize(img: np.ndarray) -> np.ndarray:
    """`ImageOps.equalize(image)` (no mask)."""
    luts = []
    for h in _histograms(img):
        histo = [f for f in h if f]
        step = (sum(histo) - histo[-1]) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(list(range(256)))
            continue
        n = step // 2
        lut = []
        for i in range(256):
            lut.append(n // step)
            n = n + h[i]
        luts.append(lut)
    return _apply_luts(img, luts)


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(im1, im2, alpha)` of two uint8 images of one shape."""
    a = np.float32(alpha)
    if a == 0.0:
        return im1.copy()
    if a == 1.0:
        return im2.copy()
    x1 = im1.astype(np.float32)
    v = x1 + a * (im2.astype(np.float32) - x1)
    if 0.0 <= a <= 1.0:
        return v.astype(np.uint8)
    return np.clip(v, 0.0, 255.0).astype(np.uint8)


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Brightness(image).enhance(factor)`."""
    return blend(np.zeros_like(img), img, factor)


def smooth(img: np.ndarray) -> np.ndarray:
    """`image.filter(ImageFilter.SMOOTH)` of a uint8 (H, W, 3) image."""
    h, w = img.shape[:2]
    out = img.copy()
    if h < 3 or w < 3:
        return out
    k = (np.float32(1) / np.float32(13), np.float32(5) / np.float32(13))
    x = img.astype(np.float32)
    acc = np.full((h - 2, w - 2, img.shape[2]), np.float32(0.5), np.float32)
    for dy in (1, 0, -1):            # the row below first, as Filter.c sums
        row = x[1 + dy:h - 1 + dy]
        centre = k[1] if dy == 0 else k[0]
        acc += ((row[:, :-2] * k[0] + row[:, 1:-1] * centre)
                + row[:, 2:] * k[0])
    out[1:-1, 1:-1] = np.clip(acc, 0.0, 255.0).astype(np.uint8)
    return out


def sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Sharpness(image).enhance(factor)`."""
    return blend(smooth(img), img, factor)


def rgb_to_l(img: np.ndarray) -> np.ndarray:
    """`convert("L")` of RGB(A): (R 19595 + G 38470 + B 7471 + 0x8000) >>
    16."""
    x = img[..., :3].astype(np.uint32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def to_mode(img: np.ndarray, mode: str) -> np.ndarray:
    """`convert(mode)` for "L" or "RGB" of a uint8 grey (H, W), RGB or RGBA
    array: grey is replicated, alpha dropped."""
    channels = 1 if img.ndim == 2 else img.shape[2]
    if mode == "L":
        return img if channels == 1 else rgb_to_l(img)
    if mode == "RGB":
        if channels == 1:
            return np.repeat(img[..., None], 3, axis=-1)
        return img if channels == 3 else np.ascontiguousarray(img[..., :3])
    raise ValueError(f"to_mode: unsupported mode {mode!r}")
