"""Expert model bank: `load_expert_model(task)`, ported from
prismer_tpu/experts/model_bank.py.

`load_expert_model(task, image_size, device)` returns (model, preprocess)
for the seven tasks: depth (DPT-hybrid), normal (NNET), edge (DexiNed),
seg_coco / seg_ade (Mask2Former), obj_detection (UniDet) and
ocr_detection (CharNet). The model is on `device`, fp32, in eval mode,
with the published weights converted when the checkpoint file is present
and random weights from a fixed seed (with a loud warning) when it is
not; a converted file must cover all but 1 % of the model's tensors
(`merge_converted`). `preprocess` is a host-side callable uint8 (H, W[,
C]) image -> (S, S, 3) float32 array that resizes as PIL's BILINEAR does
and applies the expert's pixel statistics. UniDet is returned as a module
whose `features` / `rpn_proposals` / `cascade_stage` methods the caller
drives (`obj_detection.rcnn.detect_single`), as in the JAX package.

Checkpoints are searched under PRISMER_EXPERT_WEIGHTS (default
'experts/expert_weights') by the reference's file names. `.pt` / `.pth`
files are read with `torch.load(..., weights_only=True)`, detectron2
`.pkl` files by an unpickler that takes arrays and plain containers only:
reading a checkpoint runs none of its code.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from prismer_tpu_torch.convert.from_jax import (_leaves, load_jax_variables,
                                                to_jax_variables,
                                                torch_key_and_value)
from prismer_tpu_torch.data.pil_warp import resize_bilinear_u8

WEIGHTS = {
    "depth": "dpt_hybrid-midas-501f0c75.pt",
    "normal": "scannet.pt",
    "edge": "10_model.pth",
    "ocr_detection": "icdar2015_hourglass88.pth",
    "seg_coco": "model_final_f07440.pkl",
    "seg_ade": "model_final_e0c58e.pkl",
    "obj_detection": "Unified_learned_OCIM_RS200_6x+2x.pth",
}
NUM_CLASSES = {"seg_coco": 133, "seg_ade": 150}
# detectron2 PIXEL_MEAN / PIXEL_STD over 255
SEG_MEAN = np.array([123.675, 116.28, 103.53], np.float32) / 255.0
SEG_STD = np.array([58.395, 57.12, 57.375], np.float32) / 255.0
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# UniDet's PIXEL_MEAN / PIXEL_STD over 255
OBJDET_MEAN = np.array([123.68, 116.779, 103.939], np.float32) / 255.0
OBJDET_STD = np.array([58.393, 57.12, 57.375], np.float32) / 255.0
# (mean, std) of each expert's preprocess
PIXEL_STATS = {"depth": (0.5, 0.5),
               "normal": (IMAGENET_MEAN, IMAGENET_STD),
               "edge": (IMAGENET_MEAN, (1.0, 1.0, 1.0)),
               "seg_coco": (SEG_MEAN, SEG_STD),
               "seg_ade": (SEG_MEAN, SEG_STD),
               "obj_detection": (OBJDET_MEAN, OBJDET_STD),
               "ocr_detection": (IMAGENET_MEAN, IMAGENET_STD)}
RANDOM_SEED = 0
# fraction of param leaves a converted checkpoint may leave at their random
# init before the load is taken for a key-layout drift and refused
_MAX_UNCOVERED_FRACTION = 0.01


def _weights_dir() -> str:
    return os.environ.get("PRISMER_EXPERT_WEIGHTS", "experts/expert_weights")


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles a detectron2 .pkl (dicts, strings, numbers and numpy
    arrays) and refuses every other global, so a file cannot run code."""

    _ALLOWED = {("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar"),
                ("numpy", "ndarray"), ("numpy", "dtype"),
                ("collections", "OrderedDict")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}; only numpy arrays "
                f"and plain containers are read")
        return super().find_class(module, name)


def load_checkpoint(task: str) -> Optional[Dict[str, Any]]:
    """The state dict of `task`'s checkpoint file (a detectron2 .pkl's
    'model' dict; a torch file's 'model' or 'state_dict' entry when it has
    one), or None (with a loud warning) when the file is absent. A torch
    file that `weights_only=True` cannot read raises with its path."""
    path = os.path.join(_weights_dir(), WEIGHTS[task])
    if not os.path.exists(path):
        warnings.warn(
            f"[prismer_tpu_torch] expert '{task}': checkpoint {path} not "
            f"found - running with RANDOM weights; generated labels will be "
            f"noise. Provide the file or set PRISMER_EXPERT_WEIGHTS.",
            stacklevel=3)
        return None
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            sd = _ArrayUnpickler(f, encoding="latin1").load()
    else:
        try:
            sd = torch.load(path, map_location="cpu", weights_only=True)
        except Exception as e:
            raise ValueError(f"{path}: not readable with torch.load("
                             f"weights_only=True): {e}") from e
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return sd


def merge_converted(model: torch.nn.Module, tree: Dict[str, Any],
                    task: str = "expert") -> None:
    """Load a converted flax tree into `model` (which holds its random
    init), strictly on names and shapes, leaving uncovered parameters at
    their init - but refuse when the tree (its params and batch_stats)
    covers too few of them: the experts are frozen, so a silently partial
    load (renamed keys in a newly released file) would give noise labels
    with no other sign."""
    state = model.state_dict()
    covered = {torch_key_and_value(coll, path, v)[0]
               for coll, sub in tree.items() for path, v in _leaves(sub)}
    missing = sorted(set(state) - covered)
    total = len(state)
    if len(missing) > _MAX_UNCOVERED_FRACTION * total:
        shown = "\n  ".join(missing[:25])
        more = (f"\n  ... and {len(missing) - 25} more"
                if len(missing) > 25 else "")
        raise ValueError(
            f"[prismer_tpu_torch] expert '{task}': converted checkpoint "
            f"covers only {total - len(missing)}/{total} param leaves - the "
            f"file's key layout does not match this converter (drifted "
            f"release? wrong file?). Refusing a silent partial load. "
            f"Uncovered leaves:\n  {shown}{more}")
    if missing:
        warnings.warn(f"[prismer_tpu_torch] expert '{task}': {len(missing)}"
                      f"/{total} param leaves kept random init: {missing}",
                      stacklevel=3)
    merged = to_jax_variables({k: state[k] for k in missing})
    for coll, sub in tree.items():
        _overlay(merged.setdefault(coll, {}), sub)
    load_jax_variables(model, merged)


def _overlay(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _overlay(dst.setdefault(k, {}), v)
        else:
            dst[k] = v


def resize_norm(size: int, mean, std) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA -> (size, size, 3)
    float32: PIL's convert('RGB') (grey replicated, alpha dropped), PIL
    BILINEAR resize, / 255, then (x - mean) / std, as the JAX package's
    `_resize_norm` computes for an image PIL decodes."""
    mean = np.broadcast_to(np.asarray(mean, np.float32), (3,))
    std = np.broadcast_to(np.asarray(std, np.float32), (3,))

    def fn(img: np.ndarray) -> np.ndarray:
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        img = resize_bilinear_u8(img[:, :, :3], (size, size))
        arr = img.astype(np.float32) / 255.0
        return (arr - mean) / std

    return fn


def _build(task: str, device) -> torch.nn.Module:
    """`task`'s expert at the published widths from the fixed seed."""
    from prismer_tpu_torch.experts.layers import build_random
    if task in ("seg_coco", "seg_ade"):
        from prismer_tpu_torch.experts.segmentation.mask2former import \
            build_random_maskformer
        return build_random_maskformer(RANDOM_SEED, device,
                                       num_classes=NUM_CLASSES[task])
    if task == "depth":
        from prismer_tpu_torch.experts.depth.model import (RAW_INIT,
                                                           DPTDepthModel)
        return build_random(DPTDepthModel, RANDOM_SEED, device, RAW_INIT)
    if task == "normal":
        from prismer_tpu_torch.experts.normal.model import NNET
        return build_random(NNET, RANDOM_SEED, device)
    if task == "edge":
        from prismer_tpu_torch.experts.edge.model import DexiNed
        return build_random(DexiNed, RANDOM_SEED, device)
    if task == "obj_detection":
        from prismer_tpu_torch.experts.obj_detection.rcnn import UniDet
        return build_random(UniDet, RANDOM_SEED, device)
    from prismer_tpu_torch.experts.ocr_detection.model import CharNet
    return build_random(CharNet, RANDOM_SEED, device)


def converter(task: str) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """The function that turns `task`'s checkpoint into a flax tree."""
    from prismer_tpu_torch.convert import experts as cve
    return {"depth": cve.convert_dpt, "normal": cve.convert_nnet,
            "edge": cve.convert_dexined, "seg_coco": cve.convert_mask2former,
            "seg_ade": cve.convert_mask2former,
            "obj_detection": cve.convert_unidet,
            "ocr_detection": cve.convert_charnet}[task]


def load_expert_model(task: str, image_size: int = 480,
                      device: torch.device | str = "cuda"
                      ) -> Tuple[torch.nn.Module, Callable]:
    if task not in WEIGHTS:
        raise ValueError(f"unknown expert task: {task}")
    model = _build(task, device)
    sd = load_checkpoint(task)
    if sd is not None:
        merge_converted(model, converter(task)(sd), task)
    return model, resize_norm(image_size, *PIXEL_STATS[task])
