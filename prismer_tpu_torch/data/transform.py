"""Joint image + expert-label transform, ported from
prismer_tpu/data/transform.py (the reference's dataset/utils.py:23-71), on
uint8 numpy images with Pillow's arithmetic.

  * train: RandomResizedCrop parameters (scale from the config, ratio
    3/4..4/3) shared by the RGB image and every label map (utils.py:33-37);
  * RGB resized BICUBIC to image_resolution, labels to a FIXED 224 x 224
    with NEAREST (utils.py:40-43);
  * a joint horizontal flip with p = 0.5 (utils.py:46-51), then
    RandAugment(2, 5);
  * RGB shipped as uint8 (normalised on the device, data/device.py); dense
    labels as float32 in [0, 1]; id labels as uint8 ids.

The RGB chain is crop -> BICUBIC -> flip -> RandAugment. Every label goes
through one composed nearest-index gather (pil_warp.LabelGather). A label
whose size differs from the image's is cropped first with the image's box
(zero padding past its edge, as PIL's crop pads), then gathered from there,
which is what the JAX package's joint PIL path gives it.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Optional, Tuple

import numpy as np

from prismer_tpu_torch.data.pil_warp import (LabelGather, crop_u8,
                                             flip_lr_u8, resize_bicubic_u8)
from prismer_tpu_torch.data.randaugment import (LABEL_FILL, LABEL_RESOLUTION,
                                                RandAugment)

ID_EXPERTS = ("seg_coco", "seg_ade", "obj_detection", "ocr_detection")
DENSE_EXPERTS = ("depth", "normal", "edge")


def random_resized_crop_params(w: int, h: int, scale: Tuple[float, float],
                               ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                               ) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params semantics: 10 attempts of
    (uniform-area, log-uniform-ratio) crops, else center fallback.
    Returns (top, left, crop_h, crop_w)."""
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * random.uniform(*scale)
        aspect = math.exp(random.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = random.randint(0, h - ch)
            left = random.randint(0, w - cw)
            return top, left, ch, cw
    # center-crop fallback
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw = w
        ch = int(round(cw / ratio[0]))
    elif in_ratio > ratio[1]:
        ch = h
        cw = int(round(ch * ratio[1]))
    else:
        cw, ch = w, h
    top = (h - ch) // 2
    left = (w - cw) // 2
    return top, left, ch, cw


class Transform:
    """Callable (uint8 (H, W, 3) image, {expert: uint8 label} | None) ->
    {name: ndarray}."""

    def __init__(self, resize_resolution: int = 384,
                 scale_size: Tuple[float, float] = (0.5, 1.0),
                 train: bool = False):
        self.res = resize_resolution
        self.scale_size = tuple(scale_size)
        self.train = train
        self.randaugment = RandAugment(2, 5)

    def __call__(self, image: np.ndarray,
                 labels: Optional[Dict[str, np.ndarray]]
                 ) -> Dict[str, np.ndarray]:
        h, w = image.shape[:2]
        crop = box = None
        if self.train:
            top, left, ch, cw = random_resized_crop_params(
                w, h, self.scale_size)
            crop = (top, left, ch, cw)
            box = (left, top, left + cw, top + ch)
            image = crop_u8(image, box)
        image = resize_bicubic_u8(image, (self.res, self.res))

        flip = False
        geo_coeffs = []
        if self.train:
            if random.random() < 0.5:
                flip = True
                image = flip_lr_u8(image)
            image, geo_coeffs = self.randaugment.rgb_and_coeffs(image)
        if labels is None:
            return self._pack(image, None)

        gather = None
        label_arrays = {}
        for exp, lab in labels.items():
            if lab.shape[:2] == (h, w):
                if gather is None:
                    gather = LabelGather((w, h), crop, flip, geo_coeffs,
                                         LABEL_RESOLUTION)
                label_arrays[exp] = gather(lab, LABEL_FILL[exp])
            else:
                src = lab if box is None else crop_u8(lab, box)
                label_arrays[exp] = LabelGather(
                    (src.shape[1], src.shape[0]), None, flip, geo_coeffs,
                    LABEL_RESOLUTION)(src, LABEL_FILL[exp])
        return self._pack(image, label_arrays)

    @staticmethod
    def _pack(image: np.ndarray,
              label_arrays: Optional[Dict[str, np.ndarray]]
              ) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {"rgb": np.asarray(image, np.uint8)}
        for exp, arr in (label_arrays or {}).items():
            if exp in DENSE_EXPERTS:
                a = arr.astype(np.float32) / 255.0
                if a.ndim == 2:
                    a = a[:, :, None]
                out[exp] = a
            else:  # id maps stay uint8
                out[exp] = arr.astype(np.uint8)
        return out


def remap_dense(x: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Per-sample min-max remap of dense maps to [-1, 1]
    (dataset/utils.py:120-121)."""
    lo, hi = x.min(), x.max()
    return 2.0 * (x - lo) / (hi - lo + eps) - 1.0
