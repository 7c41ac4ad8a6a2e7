"""Label-aware RandAugment, ported from prismer_tpu/data/randaugment.py, on
uint8 numpy images with Pillow's arithmetic (data/pil_warp.py,
data/pil_ops.py).

The reference's policy (dataset/randaugment.py): 10 active ops, n sampled
with replacement per image, magnitude v = m/10 * (hi - lo) + lo. Geometric
ops warp the RGB image with BILINEAR resampling (rotate with NEAREST, as
PIL's default) and black fill; photometric ops touch RGB only. The label
side is never warped here: `rgb_and_coeffs` returns the label affines in
application order for the one composed gather (pil_warp.LabelGather),
with the per-expert fill of `LABEL_FILL`.

Draws come from the module-level `random` in the JAX package's order:
`random.choices` for the ops, then one sign draw for each geometric op at
application time.

Kept from the reference (bug for bug): Translate magnitudes scale with the
RGB width (randaugment.py TranslateX `v * img.size[0]`), and that PIXEL
offset is applied unchanged to the 224 px label maps, a larger relative
shift on labels whenever image_resolution > 224.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

from prismer_tpu_torch.data import pil_ops
from prismer_tpu_torch.data.pil_warp import (Coeffs, affine_bilinear_u8,
                                             rotate_coeffs, rotate_nearest_u8)

# fill values when a geometric op exposes out-of-image area
LABEL_FILL = {"depth": 0, "normal": 0, "edge": 0, "seg_coco": 255,
              "seg_ade": 255, "obj_detection": 255, "ocr_detection": 255}
RGB_FILL = (0, 0, 0)
LABEL_RESOLUTION = 224  # label maps are square, of this side

# (name, lo, hi): the reference's active list (randaugment.py:186-204;
# Invert/Solarize/Posterize/Color are commented out there)
AUGMENT_OPS = [
    ("identity", 0.0, 1.0),
    ("shear_x", 0.0, 0.3),
    ("shear_y", 0.0, 0.3),
    ("translate_x", 0.0, 0.33),
    ("translate_y", 0.0, 0.33),
    ("rotate", 0.0, 30.0),
    ("autocontrast", 0, 1),
    ("equalize", 0, 1),
    ("brightness", 0.1, 1.9),
    ("sharpness", 0.1, 1.9),
]

GEOMETRIC = {"shear_x", "shear_y", "translate_x", "translate_y", "rotate"}

_PHOTOMETRIC = {
    "autocontrast": lambda im, v: pil_ops.autocontrast(im),
    "equalize": lambda im, v: pil_ops.equalize(im),
    "brightness": pil_ops.brightness,
    "sharpness": pil_ops.sharpness,
}


def _signed(v: float) -> float:
    return -v if random.random() > 0.5 else v


def _geo_coeffs(name: str, v: float, rgb_size: Tuple[int, int]) -> Coeffs:
    """Output->input AFFINE coefficients of a geometric op, the sign
    already drawn. Translate offsets scale with the RGB size (module
    note)."""
    if name == "shear_x":
        return (1.0, v, 0.0, 0.0, 1.0, 0.0)
    if name == "shear_y":
        return (1.0, 0.0, 0.0, v, 1.0, 0.0)
    if name == "translate_x":
        return (1.0, 0.0, v * rgb_size[0], 0.0, 1.0, 0.0)
    if name == "translate_y":
        return (1.0, 0.0, 0.0, 0.0, 1.0, v * rgb_size[1])
    raise ValueError(name)


class RandAugment:
    def __init__(self, n: int = 2, m: int = 5):
        self.n = n
        self.m = m

    def rgb_and_coeffs(self, img: np.ndarray
                       ) -> Tuple[np.ndarray, List[Coeffs]]:
        """Apply the sampled ops to a uint8 (H, W, 3) image; return it with
        the label affine coefficients in application order."""
        coeffs_out: List[Coeffs] = []
        for name, lo, hi in random.choices(AUGMENT_OPS, k=self.n):
            v = (self.m / 10.0) * (hi - lo) + lo
            if name == "identity":
                continue
            if name in GEOMETRIC:
                v = _signed(v)
                if name == "rotate":
                    img = rotate_nearest_u8(img, v, RGB_FILL)
                    coeffs = rotate_coeffs(v, LABEL_RESOLUTION,
                                           LABEL_RESOLUTION)
                else:
                    coeffs = _geo_coeffs(name, v, (img.shape[1],
                                                   img.shape[0]))
                    img = affine_bilinear_u8(img, coeffs, RGB_FILL)
                coeffs_out.append(coeffs)
            else:
                img = _PHOTOMETRIC[name](img, v)
        return img, coeffs_out
