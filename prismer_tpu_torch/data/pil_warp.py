"""Pillow's 8-bit geometry, bit-exact, in numpy; ported from
prismer_tpu/data/pil_warp.py and extended to the RGB operations of the
data path.

The machine with the card has no PIL. The label generator and the data
transform resize, warp, crop and flip images exactly as the JAX package
does through PIL:

  * `resize_bilinear_u8` / `resize_bicubic_u8`: `Image.resize(size,
    BILINEAR | BICUBIC)` of an 8-bit image, Pillow's ImagingResample: a
    separable filter (triangle, or cubic with a = -0.5 and support 2) whose
    support widens with the downscale factor, coefficients in 22-bit fixed
    point, the horizontal pass first, its result rounded to uint8, then the
    vertical pass.
  * `resize_nearest_u8`: `Image.resize(size, Image.NEAREST)`, Pillow's
    ImagingScaleAffine (`scale_axis_map` with a = in / out, c = 0).
  * `affine_bilinear_u8`: `Image.transform(size, AFFINE, coeffs, BILINEAR,
    fillcolor)`, Pillow's ImagingGenericTransform with the bilinear filter
    in float64 (pixel centres, edge taps clamped, truncated to uint8).
  * `rotate_nearest_u8`: `Image.rotate(angle, fillcolor=...)`, NEAREST
    through the 16.16 fixed-point affine grid (`affine_fixed_grid`).
  * `crop_u8` (a box past the edge reads 0) and `flip_lr_u8`.
  * `LabelGather`: the label side of the whole transform chain (crop ->
    NEAREST resize -> flip -> RandAugment affines) composed into ONE flat
    index map, copied from the JAX package with `affine_fixed_grid` and
    `rotate_coeffs`.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

Coeffs = Tuple[float, float, float, float, float, float]

_PRECISION_BITS = 32 - 8 - 2


def _fix(v: float) -> int:
    """Pillow's FIX macro: FLOOR(v * 65536.0 + 0.5)."""
    return int(math.floor(v * 65536.0 + 0.5))


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


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, kind: str
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc: (source index
    (out, k), int fixed-point weight (out, k)); taps past a row's bound
    carry weight 0 and a clamped index."""
    filt, filter_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    w = filt((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (
        1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = np.cumsum(w, axis=1)[:, -1:]     # C's left-to-right sum
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    idx = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)
    return idx, fixed.astype(np.int64)


def _pass(img: np.ndarray, axis: int, out_size: int, kind: str
          ) -> np.ndarray:
    """One separable pass: the taps summed one at a time in int32, as
    Pillow's int accumulators do."""
    idx, k = _coeffs(img.shape[axis], out_size, kind)
    k = k.astype(np.int32)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(1, 1 << (_PRECISION_BITS - 1), np.int32)
    for t in range(k.shape[1]):
        if k[:, t].any():
            tap = np.take(img, idx[:, t], axis=axis).astype(np.int32)
            tap *= k[:, t].reshape(shape)
            acc = acc + tap
    acc >>= _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def _resize(img: np.ndarray, size: Tuple[int, int], kind: str) -> np.ndarray:
    w_out, h_out = size
    h_in, w_in = img.shape[:2]
    out = img
    if w_out != w_in:
        out = _pass(out, 1, w_out, kind)
    if h_out != h_in:
        out = _pass(out, 0, h_out, kind)
    return out.copy() if out is img else out


def resize_bilinear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL BILINEAR resize of a uint8 (H, W[, C]) image to size (W, H)."""
    return _resize(img, size, "bilinear")


def resize_bicubic_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL BICUBIC resize of a uint8 (H, W[, C]) image to size (W, H)."""
    return _resize(img, size, "bicubic")


def affine_fixed_grid(coeffs: Sequence[float], out_wh: Tuple[int, int],
                      in_wh: Tuple[int, int]
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xi, yi, oob) int32/bool grids of shape (h_out, w_out) replicating
    Pillow's fixed-point affine_fixed NEAREST kernel."""
    a, b, c, d, e, f = (float(v) for v in coeffs)
    w_out, h_out = out_wh
    w_in, h_in = in_wh
    a0, a1 = _fix(a), _fix(b)
    a3, a4 = _fix(d), _fix(e)
    a2 = _fix(c + a * 0.5 + b * 0.5)
    a5 = _fix(f + d * 0.5 + e * 0.5)
    # 16.16 values here stay well inside int32 for label-map sizes; int32
    # + in-place ops keep this ~0.2 ms per grid on the 1-core host
    ys = np.arange(h_out, dtype=np.int32)
    xs = np.arange(w_out, dtype=np.int32)
    xi = np.add.outer(a2 + ys * a1, xs * a0)
    yi = np.add.outer(a5 + ys * a4, xs * a3)
    xi >>= 16
    yi >>= 16
    oob = (xi < 0) | (xi >= w_in)
    oob |= yi < 0
    oob |= yi >= h_in
    return (np.clip(xi, 0, w_in - 1, out=xi),
            np.clip(yi, 0, h_in - 1, out=yi), oob)


def rotate_coeffs(angle: float, w: int, h: int) -> Coeffs:
    """The output->input AFFINE coefficients PIL.Image.rotate(angle,
    expand=False) builds before calling transform (PIL/Image.py rotate)."""
    angle = angle % 360.0
    rotn_center = (w / 2.0, h / 2.0)
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    m[2] = m[0] * -rotn_center[0] + m[1] * -rotn_center[1]
    m[5] = m[3] * -rotn_center[0] + m[4] * -rotn_center[1]
    m[2] += rotn_center[0]
    m[5] += rotn_center[1]
    return tuple(m)  # type: ignore[return-value]


def _is_separable(coeffs: Coeffs) -> bool:
    return coeffs[1] == 0.0 and coeffs[3] == 0.0


class LabelGather:
    """One composed (output pixel -> source flat index) map for the full
    label chain of a record:

      [crop (top, left, ch, cw)] -> resize (r x r, NEAREST) -> [h-flip]
      -> geo_coeffs[0] -> geo_coeffs[1] -> ...

    Every nearest stage produces integer source coords into the previous
    stage's output, so composition is a chain of integer gathers — the same
    values as materializing each intermediate image, without materializing
    any. Call the instance per label array: ``out = lg(arr, fill)``.
    """

    def __init__(self, src_wh: Tuple[int, int],
                 crop: Tuple[int, int, int, int] | None,
                 flip: bool, geo_coeffs: List[Coeffs],
                 label_resolution: int = 224):
        r = label_resolution
        w, h = src_wh
        self._src_hw = (h, w)

        # walk the chain BACKWARDS from the output grid; (xi, yi) index the
        # output of the stage currently being peeled. Stay separable (1-D
        # axis maps) until a shear/rotate forces the 2-D representation.
        sep = True
        xi = yi = oobx = ooby = None          # separable state
        XI = YI = OOB = None                  # full state
        for coeffs in reversed(geo_coeffs):
            if _is_separable(coeffs):
                a, _, c, _, e, f = (float(v) for v in coeffs)
                gx, gox = scale_axis_map(a, c, r, r)
                gy, goy = scale_axis_map(e, f, r, r)
                if sep:
                    if xi is None:
                        xi, yi, oobx, ooby = gx, gy, gox, goy
                    else:
                        oobx = oobx | gox[xi]
                        ooby = ooby | goy[yi]
                        xi, yi = gx[xi], gy[yi]
                else:
                    OOB |= gox[XI] | goy[YI]
                    XI, YI = gx[XI], gy[YI]
            else:
                gxi, gyi, goob = affine_fixed_grid(coeffs, (r, r), (r, r))
                if sep:
                    if xi is None:
                        XI, YI, OOB = gxi, gyi, goob.copy()
                    else:
                        # outer composition of the separable prefix
                        OOB = (ooby[:, None] | oobx[None, :]
                               | goob[yi][:, xi])
                        XI = gxi[yi][:, xi]
                        YI = gyi[yi][:, xi]
                    sep = False
                else:
                    nXI = gxi[YI, XI]
                    nYI = gyi[YI, XI]
                    OOB |= goob[YI, XI]
                    XI, YI = nXI, nYI

        # flip maps its output column x to input column (r-1) - x
        if flip:
            if sep:
                xi = ((r - 1) - xi if xi is not None
                      else np.arange(r - 1, -1, -1, dtype=np.int32))
            else:
                XI = (r - 1) - XI

        if crop is not None:
            top, left, ch, cw = crop
        else:
            top, left = 0, 0
            ch, cw = h, w
        rx, rox = scale_axis_map(cw / r, 0.0, r, cw)
        ry, roy = scale_axis_map(ch / r, 0.0, r, ch)
        assert not (rox.any() or roy.any()), \
            "nearest resize never samples out of bounds"
        # crop is an integer offset: floor(left + v) == left + floor(v)
        if sep:
            sx = rx[xi] + left if xi is not None else rx + left
            sy = ry[yi] + top if yi is not None else ry + top
            flat = sy.astype(np.intp) * w
            flat = flat[:, None] + sx[None, :]
            has_oob = oobx is not None and bool(oobx.any() or ooby.any())
            if has_oob:
                flat = np.where(ooby[:, None] | oobx[None, :],
                                np.intp(h * w), flat)
        else:
            sx = rx[XI] + left
            sy = ry[YI] + top
            flat = sy.astype(np.intp) * w + sx
            has_oob = bool(OOB.any())
            if has_oob:
                flat = np.where(OOB, np.intp(h * w), flat)
        self._flat = flat
        self._has_oob = has_oob

    def __call__(self, arr: np.ndarray, fill: int) -> np.ndarray:
        """Gather one source label array ((h, w) or (h, w, C)) through the
        composed map; `fill` serves every stage's out-of-bounds samples."""
        h, w = self._src_hw
        assert arr.shape[:2] == (h, w), (arr.shape, (h, w))
        flat_src = arr.reshape(h * w, *arr.shape[2:])
        if self._has_oob:
            sentinel = np.full((1,) + flat_src.shape[1:], fill,
                               dtype=arr.dtype)
            flat_src = np.concatenate([flat_src, sentinel])
        return flat_src[self._flat]


def crop_u8(img: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """`Image.crop((left, top, right, bottom))`: the part of the box past
    the image's edge reads 0."""
    left, top, right, bottom = box
    h, w = img.shape[:2]
    out = np.zeros((bottom - top, right - left) + img.shape[2:], img.dtype)
    y0, y1 = max(top, 0), min(bottom, h)
    x0, x1 = max(left, 0), min(right, w)
    if y0 < y1 and x0 < x1:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def flip_lr_u8(img: np.ndarray) -> np.ndarray:
    """`Image.transpose(Image.FLIP_LEFT_RIGHT)`."""
    return np.ascontiguousarray(img[:, ::-1])


def affine_bilinear_u8(img: np.ndarray, coeffs: Sequence[float],
                       fill: Tuple[int, ...]) -> np.ndarray:
    """`Image.transform(img.size, AFFINE, coeffs, BILINEAR, fillcolor=fill)`
    of a uint8 (H, W, C) image: Pillow's affine_transform at pixel centres
    and bilinear filter, in float64; a source point outside the image keeps
    the fill colour, taps past the edge are clamped to it, the value is
    truncated to uint8."""
    a0, a1, a2, a3, a4, a5 = (float(v) for v in coeffs)
    h, w = img.shape[:2]
    xin = np.arange(w, dtype=np.float64)[None, :] + 0.5
    yin = np.arange(h, dtype=np.float64)[:, None] + 0.5
    xs = a0 * xin + a1 * yin + a2
    ys = a3 * xin + a4 * yin + a5
    inside = (xs >= 0.0) & (xs < w) & (ys >= 0.0) & (ys < h)
    xs = xs - 0.5
    ys = ys - 0.5
    x = np.floor(xs)
    y = np.floor(ys)
    dx = (xs - x)[..., None]
    dy = (ys - y)[..., None]
    x = x.astype(np.intp)
    y = y.astype(np.intp)
    c0 = np.clip(x, 0, w - 1)
    c1 = np.clip(x + 1, 0, w - 1)
    r0 = np.clip(y, 0, h - 1) * w
    r1 = np.clip(y + 1, 0, h - 1) * w
    flat = img.reshape(h * w, -1)

    def tap(r, c):
        return flat[r + c].astype(np.float64)

    v1 = tap(r0, c0)
    v1 += (tap(r0, c1) - v1) * dx
    v2 = tap(r1, c0)
    v2 += (tap(r1, c1) - v2) * dx
    v2 = np.where(((y + 1 >= 0) & (y + 1 < h))[..., None], v2, v1)
    v1 += (v2 - v1) * dy
    out = v1.astype(np.uint8)
    out[~inside] = np.asarray(fill, np.uint8)
    return out


def rotate_nearest_u8(img: np.ndarray, angle: float,
                      fill: Tuple[int, ...]) -> np.ndarray:
    """`Image.rotate(angle, fillcolor=fill)` (NEAREST, no expand) of a
    uint8 (H, W, C) image whose angle takes none of Pillow's transpose
    shortcuts (0, 90, 180, 270 degrees)."""
    h, w = img.shape[:2]
    if angle % 90.0 == 0.0:
        raise ValueError(f"rotate by {angle} takes Pillow's transpose path")
    xi, yi, oob = affine_fixed_grid(rotate_coeffs(angle, w, h), (w, h),
                                    (w, h))
    out = img[yi, xi]
    out[oob] = np.asarray(fill, img.dtype)
    return out
