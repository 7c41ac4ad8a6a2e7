"""Expert-label file I/O and per-sample records, ported from
prismer_tpu/data/labels.py.

The on-disk layout is the reference's offline expert generators'
(dataset/utils.py:74-114):

  <label_path>/<expert>/<dataset>/<image>.png      grey id / dense map
                                                   (RGB for 'normal')
  <label_path>/obj_detection/<dataset>/<image>.json  instance -> class map
  <label_path>/ocr_detection/<dataset>/<image>.pt    {word_id: {features,
                                                      text}} (or .npz)

Missing or empty files fall back to zeros (dense maps) or all-255
background (id maps), as the reference does (utils.py:84-110).

Images and labels are uint8 numpy arrays. RGB images are told apart by
their first bytes, as `Image.open` tells them apart, whatever the file's
name: JPEG, WebP and GIF go through the port's host decoders (native/),
PNG through data/png.py, BMP and bare DIB through data/bmp.py. Anything
else raises ValueError naming the bytes it found; so does a file of these
kinds that Pillow refuses (a cut WebP, a BI_JPEG BMP, ...). Label PNGs of
every kind are converted to the mode the expert reads as PIL's `convert`
would (data/png.py).

PRISMER_LABEL_CACHE=<dir>, as in the JAX package: each label PNG's
converted array is written once to <dir>/<absolute path>.npy (the JAX
package's layout, so either package reads the other's entries) and later
epochs load it instead of inflating the PNG (`_open_label_png`).
"""

from __future__ import annotations

import json
import os
import threading
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

from prismer_tpu_torch import native
from prismer_tpu_torch.data import bmp
from prismer_tpu_torch.data.features import FeatureTables, get_feature_tables
from prismer_tpu_torch.data.png import SIGNATURE, decode_png, read_png

JPEG_MAGIC = b"\xff\xd8\xff"
GIF_MAGICS = (b"GIF87a", b"GIF89a")


def _label_file(label_path: str, expert: str, dataset: str,
                image_path: str, new_ext: str) -> str:
    ext = image_path.split(".")[-1]
    return os.path.join(label_path, expert, dataset,
                        image_path.replace(f".{ext}", new_ext))


def _nonempty(path: str) -> bool:
    return os.path.exists(path) and os.stat(path).st_size > 0


def read_rgb(path: str) -> np.ndarray:
    """uint8 (H, W, 3) pixels of a JPEG, PNG, WebP, GIF, BMP or DIB file,
    as PIL's `Image.open(path).convert("RGB")` gives them."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_MAGIC):
        return native.decode_jpeg(data)
    if data.startswith(SIGNATURE):
        return decode_png(data, "RGB")
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return native.decode_webp(data, "RGB")
    if data[:6] in GIF_MAGICS:
        return native.decode_gif(data, "RGB")
    if data.startswith(bmp.MAGIC) or bmp.is_dib(data):
        return bmp.decode_bmp(data, "RGB")
    raise ValueError(f"{path}: not a JPEG, PNG, WebP, GIF, BMP or DIB file "
                     f"(first bytes {data[:12].hex(' ')})")


def _cache_npy_path(path: str) -> str:
    root = os.environ["PRISMER_LABEL_CACHE"]
    return os.path.join(root, os.path.abspath(path).lstrip(os.sep) + ".npy")


def _open_label_png(path: str, mode: str) -> np.ndarray:
    """The label PNG's pixels in `mode` ("L" or "RGB").

    With PRISMER_LABEL_CACHE set, a cache entry is used when its mtime is at
    or after the PNG's and its ndim is the mode's; an entry that cannot be
    read falls through to a decode, which writes the entry anew through a
    temporary file (named by process and thread: thread workers share a
    pid) and `os.replace`. The variable is read at each call, so the
    loader's workers need nothing passed to them."""
    cache_root = os.environ.get("PRISMER_LABEL_CACHE")
    if cache_root:
        cp = _cache_npy_path(path)
        try:
            if os.stat(cp).st_mtime_ns >= os.stat(path).st_mtime_ns:
                arr = np.load(cp)
                if arr.ndim == (2 if mode == "L" else 3):
                    return arr
        except (OSError, ValueError, EOFError):
            pass
    arr = read_png(path, mode)
    if cache_root:
        try:
            os.makedirs(os.path.dirname(cp), exist_ok=True)
            tmp = f"{cp}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, cp)
        except OSError:
            pass
    return arr


def load_expert_labels(data_path: str, label_path: str, image_path: str,
                       dataset: str, experts
                       ) -> Tuple[np.ndarray, Optional[Dict],
                                  Optional[Dict]]:
    """(RGB image, {expert: label}, {expert: side info}) with the
    reference's fallbacks (dataset/utils.py:74-114)."""
    image = read_rgb(os.path.join(data_path, dataset, image_path)
                     if data_path else os.path.join(dataset, image_path))
    if experts in (None, "none"):
        return image, None, None

    h, w = image.shape[:2]
    labels: Dict[str, np.ndarray] = {}
    info: Dict[str, Any] = {}
    for exp in experts:
        png = _label_file(label_path, exp, dataset, image_path, ".png")
        if exp in ("seg_coco", "seg_ade", "edge", "depth"):
            labels[exp] = (_open_label_png(png, "L") if _nonempty(png)
                           else np.zeros((h, w), np.uint8))
        elif exp == "normal":
            labels[exp] = (_open_label_png(png, "RGB") if _nonempty(png)
                           else np.zeros((h, w, 3), np.uint8))
        elif exp == "obj_detection":
            labels[exp] = (_open_label_png(png, "L") if _nonempty(png)
                           else np.full((h, w), 255, np.uint8))
            js = _label_file(label_path, exp, dataset, image_path, ".json")
            info[exp] = {}
            if os.path.exists(js):
                with open(js) as f:
                    info[exp] = json.load(f)
        elif exp == "ocr_detection":
            pt = _label_file(label_path, exp, dataset, image_path, ".pt")
            if os.path.exists(pt):
                labels[exp] = _open_label_png(png, "L")
                info[exp] = _load_ocr_sidecar(pt)
            else:
                labels[exp] = np.full((h, w), 255, np.uint8)
                info[exp] = None
    return image, labels, info


def _load_ocr_sidecar(path: str):
    """OCR sidecars from the reference generators are torch files, read
    with `weights_only=True`; the JAX package's are .npz. Both are read
    (the JAX package's magic-byte test takes a zip-format .pt for an
    .npz and fails on it; this one looks at the archive's members)."""
    if path.endswith(".npz") or _is_npz(path):
        z = np.load(path, allow_pickle=True)
        out: Dict[int, Dict[str, Any]] = {}
        for k in z.files:
            if k.startswith("text_"):
                out.setdefault(int(k[5:]), {})["text"] = str(z[k])
            else:
                out.setdefault(int(k), {})["features"] = z[k]
        return out
    import torch
    return torch.load(path, map_location="cpu", weights_only=True)


def _is_npz(path: str) -> bool:
    """An .npz archive holds only .npy members; torch.save's zip archives
    (a .pt of torch >= 1.6) hold data.pkl and friends."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return all(name.endswith(".npy") for name in z.namelist())


def build_expert_record(transformed: Dict[str, np.ndarray],
                        info: Optional[Dict[str, Any]],
                        tables: Optional[FeatureTables] = None
                        ) -> Dict[str, Any]:
    """Post-transform records (the reference's post_label_process,
    dataset/utils.py:117-159, shaped for the device-side gather):

      dense experts  -> (H, W, C) float32 remapped to [-1, 1]
      seg_coco/ade   -> {'ids': (H, W) u8, 'table': (256, 64)} (shared)
      obj_detection  -> {'ids', 'table' (from the instance->class json),
                         'instance': (H, W) u8}
      ocr_detection  -> {'ids', 'table' (from the word sidecar)}
    """
    from prismer_tpu_torch.data.transform import DENSE_EXPERTS, remap_dense
    tables = tables or get_feature_tables()
    out: Dict[str, Any] = {"rgb": transformed["rgb"]}
    for exp, arr in transformed.items():
        if exp == "rgb":
            continue
        if exp in DENSE_EXPERTS:
            out[exp] = remap_dense(arr)
        elif exp in ("seg_coco", "seg_ade"):
            out[exp] = {"ids": arr, "table": tables.seg_table(exp)}
        elif exp == "obj_detection":
            label_map = (info or {}).get(exp) or {}
            out[exp] = {"ids": arr,
                        "table": tables.detection_table(label_map),
                        "instance": arr}
        elif exp == "ocr_detection":
            word_info = (info or {}).get(exp)
            out[exp] = {"ids": arr, "table": tables.ocr_table(word_info)}
    return out
