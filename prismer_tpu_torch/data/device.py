"""Device-side expert-input materialisation, ported from
prismer_tpu/data/device.py.

The host ships uint8 id maps with small (256, 64) per-sample tables; this
expands them on the device to the model's (B, H, W, 64) inputs with a gather,
and maps 'seg_coco' / 'seg_ade' to the canonical 'seg'.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from prismer_tpu_torch.config import canonical_expert

# CLIP pixel statistics (prismer_tpu/data/transform.py CLIP_MEAN / CLIP_STD;
# copied because that module imports PIL)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def materialize_experts(raw: Dict[str, Any], dtype=torch.float32
                        ) -> Dict[str, Any]:
    """Raw batch -> model expert inputs, stored in `dtype`.

    raw formats (leading B):
      'rgb'          (B, H, W, 3) float, or uint8 frames (normalised here)
      dense experts  (B, H, W, C) float in [-1, 1]
      id experts     {'ids': (B, H, W) uint8, 'table': (B, 256, 64) float,
                      ['instance': (B, H, W) uint8]}"""
    out: Dict[str, Any] = {}
    for exp, v in raw.items():
        name = canonical_expert(exp)
        if name == "rgb" and not isinstance(v, dict) and v.dtype == torch.uint8:
            mean = torch.tensor(CLIP_MEAN, dtype=torch.float32,
                                device=v.device)
            std = torch.tensor(CLIP_STD, dtype=torch.float32, device=v.device)
            x = v.float() / 255.0
            out[name] = ((x - mean) / std).to(dtype)
        elif isinstance(v, dict) and "ids" not in v:
            out[name] = v  # already materialised
        elif isinstance(v, dict):
            ids = v["ids"]
            b = ids.shape[0]
            table = v["table"].to(dtype)
            idx = ids.long().reshape(b, -1, 1).expand(-1, -1, table.shape[-1])
            label = torch.gather(table, 1, idx).reshape(
                *ids.shape, table.shape[-1])
            if name == "obj_detection":
                out[name] = {"label": label,
                             "instance": v["instance"][..., None]}
            else:
                out[name] = label
        else:
            out[name] = v if v.dtype == torch.uint8 else v.to(dtype)
    return out


def experts_to_device(experts_batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Host expert batch (numpy leaves, the raw id / table format of
    data/labels.py) -> tensors on `device`, the torch counterpart of the
    JAX package's cli/common.py `experts_to_device` without the mesh."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return {k: conv(v) for k, v in experts_batch.items()}
