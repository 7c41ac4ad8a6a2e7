"""CLIP feature tables for expert-label in-painting, ported from
prismer_tpu/data/features.py.

The host ships each id map as uint8 with a (256, 64) per-sample lookup
table; the device expands `table[id_map]` (data/device.py). Row 255 is the
background vector (the reference's dataset/utils.py:127-156); unused rows
default to background. The tables stay numpy, so that forked loader
workers never hold a CUDA tensor. The features are read by path from the
JAX package's `prismer_tpu/assets/features.npz`, or from the file that
PRISMER_FEATURES names, as in the JAX package.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

ASSET = (Path(__file__).resolve().parents[2] / "prismer_tpu" / "assets"
         / "features.npz")

NUM_IDS = 256  # uint8 id space; 255 = background
FEATURE_DIM = 64


class FeatureTables:
    def __init__(self, path: Optional[str] = None):
        z = np.load(path or os.environ.get("PRISMER_FEATURES", ASSET))
        self.background = z["background"].astype(np.float32)
        self.coco = z["coco_features"].astype(np.float32)
        self.ade = z["ade_features"].astype(np.float32)
        self.detection = z["detection_features"].astype(np.float32)
        self.pca_components = z.get("pca_components")
        self.pca_mean = z.get("pca_mean")
        self._gather = {
            "seg_coco": self._make_gather(self.coco),
            "seg_ade": self._make_gather(self.ade),
        }

    def _background_table(self) -> np.ndarray:
        return np.tile(self.background, (NUM_IDS, 1)).astype(np.float32)

    def _make_gather(self, feats: np.ndarray) -> np.ndarray:
        table = self._background_table()
        table[: len(feats)] = feats
        table[255] = self.background
        return table

    def seg_table(self, domain: str) -> np.ndarray:
        """(256, 64) gather table for 'seg_coco' / 'seg_ade' id maps."""
        return self._gather[domain]

    def detection_table(self, label_map: Dict[str, int]) -> np.ndarray:
        """Per-sample (256, 64) table from the objdet instance->class JSON
        (dataset/utils.py:141-149)."""
        table = self._background_table()
        for inst_id, class_idx in label_map.items():
            table[int(inst_id)] = self.detection[int(class_idx)]
        table[255] = self.background
        return table

    def ocr_table(self, word_info) -> np.ndarray:
        """Per-sample (256, 64) table from the OCR sidecar
        ({word_id: {'features': (64,), 'text': str}}, dataset/utils.py:
        151-159); word_info None -> all background (missing label)."""
        table = self._background_table()
        if word_info:
            for word_id, rec in word_info.items():
                feats = rec["features"]
                feats = np.asarray(
                    feats.numpy() if hasattr(feats, "numpy") else feats,
                    np.float32)
                table[int(word_id)] = feats
        table[255] = self.background
        return table

    def pca_project(self, emb: np.ndarray) -> np.ndarray:
        """CLIP 768-d text embedding -> 64-d (sklearn PCA transform:
        (x - mean) @ components.T), as the OCR generator uses it
        (experts/generate_ocrdet.py:80-84)."""
        if self.pca_components is None:
            raise ValueError("features.npz has no PCA components")
        return (emb - self.pca_mean) @ self.pca_components.T


@functools.lru_cache(maxsize=1)
def get_feature_tables() -> FeatureTables:
    return FeatureTables()
