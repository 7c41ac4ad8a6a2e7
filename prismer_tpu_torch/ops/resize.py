"""Image resize operators in NHWC, ported from prismer_tpu/ops/resize.py.

The JAX module rebuilt torch's own resize semantics as matrices; here
`F.interpolate` is the operator itself for bilinear with
align_corners=True, and nearest uses the explicit floor(i * in / out) index
rule (JAX resize.py:67-80) so both packages pick the same pixels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def bilinear_resize_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """NHWC bilinear resize, align_corners=True (nn.UpsamplingBilinear2d)."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=64)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC nearest-neighbour resize with torch 'nearest' index semantics."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    hi = torch.from_numpy(_nearest_indices(h, out_h)).to(x.device)
    wi = torch.from_numpy(_nearest_indices(w, out_w)).to(x.device)
    return x.index_select(1, hi).index_select(2, wi)
