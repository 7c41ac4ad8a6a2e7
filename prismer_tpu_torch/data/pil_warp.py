"""Pillow's 8-bit image resizes, bit-exact, in numpy.

The machine with the card has no PIL. The label generator resizes its input
images and its label maps exactly as the JAX package does through PIL:

  * `resize_bilinear_u8`: `Image.resize(size, Image.BILINEAR)` of an 8-bit
    image, Pillow's ImagingResample: a separable triangle filter whose
    support widens with the downscale factor (antialiased when shrinking),
    coefficients in 22-bit fixed point, the horizontal pass first, its
    result rounded to uint8, then the vertical pass.
  * `resize_nearest_u8`: `Image.resize(size, Image.NEAREST)`, Pillow's
    ImagingScaleAffine; `scale_axis_map` is copied from
    prismer_tpu/data/pil_warp.py and called with a = in / out, c = 0.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def scale_axis_map(a: float, c: float, n_out: int, n_in: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One axis of ImagingScaleAffine: (int32 source index, oob mask),
    replicating the C kernel's sequential float64 accumulation."""
    xo = np.add.accumulate(
        np.concatenate([[c + a * 0.5], np.full(n_out - 1, a)]))
    xi = np.floor(xo)
    oob = (xi < 0) | (xi >= n_in)
    return np.clip(xi, 0, n_in - 1).astype(np.int32), oob


def resize_nearest_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL NEAREST resize of a uint8 (H, W[, C]) image to size (W, H). With
    a = in / out and c = 0 every source index is inside the image."""
    w_out, h_out = size
    h_in, w_in = img.shape[:2]
    if (w_out, h_out) == (w_in, h_in):
        return img.copy()
    xi, _ = scale_axis_map(w_in / w_out, 0.0, w_out, w_in)
    yi, _ = scale_axis_map(h_in / h_out, 0.0, h_out, h_in)
    return img[yi][:, xi]


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the bilinear
    filter: (source index (out, k), int fixed-point weight (out, k)); taps
    past a row's bound carry weight 0 and a clamped index."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    t = (taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (
        1.0 / filterscale)
    w = np.where(np.abs(t) < 1.0, 1.0 - np.abs(t), 0.0)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = np.cumsum(w, axis=1)[:, -1:]     # C's left-to-right sum
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    idx = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)
    return idx, fixed.astype(np.int64)


def _pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    idx, k = _coeffs(img.shape[axis], out_size)
    taps = np.take(img.astype(np.int64), idx, axis=axis)  # (.., out, k, ..)
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = k.shape
    acc = (taps * k.reshape(shape)).sum(axis=axis + 1)
    acc += 1 << (_PRECISION_BITS - 1)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL BILINEAR resize of a uint8 (H, W[, C]) image to size (W, H)."""
    w_out, h_out = size
    h_in, w_in = img.shape[:2]
    out = img
    if w_out != w_in:
        out = _pass(out, 1, w_out)
    if h_out != h_in:
        out = _pass(out, 0, h_out)
    return out.copy() if out is img else out
