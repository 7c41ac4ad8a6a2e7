"""Convert the reference's binary CLIP feature tables to a single .npz,
ported from prismer_tpu/convert/feature_tables.py.

The reference in-paints expert id maps with CLIP text embeddings from four
torch tables and an sklearn PCA pickle (dataset/utils.py:17-20,
experts/generate_ocrdet.py:27):

  coco_features.pt       {labels: [str], features: (133, 64)}
  ade_features.pt        {labels: [str], features: (150, 64)}
  detection_features.pt  {labels: [str], features: (722, 64)}
  background_features.pt (64,)
  clip_pca.pkl           sklearn PCA(768 -> 64): components_ (64, 768), mean_

The .pt tables are read with `torch.load(weights_only=True)`. The pickle
is read by a restricted unpickler that builds sklearn's PCA as a stub
keeping its arrays (`components_`, `mean_`) and refuses every other
global but numpy's array constructors, so neither sklearn nor arbitrary
code is needed or run. The output is the JAX converter's: `<dst>.npz`
with the float32 tables and `<dst>_labels.npz` with the label strings.

  python -m prismer_tpu_torch.convert.feature_tables --src <dir> --dst out.npz
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

_PCA = ("sklearn.decomposition._pca", "PCA")


class PCAStub:
    """What the converter reads of a pickled sklearn PCA: its state."""

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)


_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar"),
          ("numpy._core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "scalar")}


class _TableUnpickler(pickle.Unpickler):
    """Unpickles sklearn's PCA as `PCAStub` and numpy's arrays, dtypes and
    scalars as numpy; any other global raises."""

    def find_class(self, module: str, name: str):
        if (module, name) == _PCA:
            return PCAStub
        if (module, name) in _NUMPY:
            if module == "numpy":
                return getattr(np, name)
            # numpy.core before numpy 2, numpy._core since, either way
            core = getattr(np, "_core", None) or np.core
            return getattr(core.multiarray, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not a feature "
                                     "table's")


def load_pca(path: str) -> PCAStub:
    with open(path, "rb") as f:
        pca = _TableUnpickler(f).load()
    if not isinstance(pca, PCAStub):
        raise ValueError(f"{path}: not a pickled sklearn PCA")
    return pca


def convert(src_dir: str, dst_path: str) -> None:
    out: Dict[str, np.ndarray] = {}
    for name in ("coco", "ade", "detection"):
        d = torch.load(os.path.join(src_dir, f"{name}_features.pt"),
                       map_location="cpu", weights_only=True)
        out[f"{name}_features"] = d["features"].numpy().astype(np.float32)
        out[f"{name}_labels"] = np.asarray(d["labels"], dtype=object)
    bg = torch.load(os.path.join(src_dir, "background_features.pt"),
                    map_location="cpu", weights_only=True)
    out["background"] = bg.numpy().astype(np.float32)

    pca_path = os.path.join(src_dir, "clip_pca.pkl")
    if os.path.exists(pca_path):
        pca = load_pca(pca_path)
        out["pca_components"] = np.asarray(pca.components_, np.float32)
        out["pca_mean"] = np.asarray(pca.mean_, np.float32)

    os.makedirs(os.path.dirname(os.path.abspath(dst_path)), exist_ok=True)
    np.savez_compressed(dst_path, **{k: v for k, v in out.items()
                                     if v.dtype != object})
    # the label strings go in a sidecar .npz (object arrays, pickled); the
    # JAX converter's sidecar also holds an entry "allow_pickle" = True
    # (np.savez takes the keyword for an array), kept so the files match
    np.savez(dst_path.replace(".npz", "_labels.npz"),
             **{k: v for k, v in out.items() if v.dtype == object},
             allow_pickle=np.asarray(True))
    print(f"wrote {dst_path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    a = ap.parse_args(argv)
    convert(a.src, a.dst)


if __name__ == "__main__":
    main()
