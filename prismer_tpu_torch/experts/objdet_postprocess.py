"""Occlusion-ordered instance masking for the object-detection expert,
copied from prismer_tpu/experts/objdet_postprocess.py (numpy on the
host, as the JAX package runs it).

The reference's depth-guided mask construction
(experts/generate_objdet.py:44-91):

  1. boxes rasterized to binary masks; near-duplicates (IoU of box masks
     > 0.95) dropped, keeping the first (higher-score) instance
  2. pairwise occlusion resolution: containment decides order; otherwise the
     box with larger mean depth-expert response (closer — the depth expert
     emits inverse depth) occludes the overlap
  3. id map: 255 = background, instance i stamped where its resolved mask is
     positive (later instances overwrite earlier ones, exactly like the
     sequential masked_fill)

Returns (uint8 id map, {instance_id: class_id}).

One change from the copy: a uint8 map holds ids 0-255, so instances past
the 256th (after the near-duplicates are dropped) are neither stamped nor
listed. The JAX package raises OverflowError there (numpy 2 refuses to
store 256 in a uint8 array); with fewer instances both give the same map
and table.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

MAX_INSTANCES = 256     # the ids a uint8 map holds


def occlusion_ordered_mask(depth: np.ndarray, boxes: Sequence[Sequence[float]],
                           class_ids: Sequence[int]
                           ) -> Tuple[np.ndarray, Dict[int, int]]:
    h, w = depth.shape
    masks: List[np.ndarray] = []
    ids: List[int] = []
    for box, cid in zip(boxes, class_ids):
        x1, y1, x2, y2 = box
        mask = np.zeros((h, w), np.float32)
        mask[int(y1):int(y2), int(x1):int(x2)] = 1
        dup = False
        for m in masks:
            inter = float(((mask + m) == 2).sum())
            union = float(((mask + m) > 0).sum())
            if union > 0 and inter / union > 0.95:
                dup = True
                break
        if not dup:
            masks.append(mask)
            ids.append(int(cid))

    modified = [m.copy() for m in masks]
    for i in range(len(masks) - 1):
        m1 = masks[i]
        for j in range(i + 1, len(masks)):
            m2 = masks[j]
            overlap = ((m1 + m2) == 2).astype(np.float32)
            if overlap.sum() == 0:
                continue
            if (overlap - m1).sum() == 0:       # obj 1 inside obj 2
                modified[j] -= modified[i]
            elif (overlap - m2).sum() == 0:     # obj 2 inside obj 1
                modified[i] -= modified[j]
            else:
                d1 = (depth * m1).sum() / m1.sum()
                d2 = (depth * m2).sum() / m2.sum()
                if d1 > d2:
                    modified[j] -= overlap
                if d1 < d2:
                    modified[i] -= overlap

    final = np.full((h, w), 255, np.uint8)
    labels: Dict[int, int] = {}
    for i, m in enumerate(modified[:MAX_INSTANCES]):
        final[m > 0] = i
        labels[i] = ids[i]
    return final, labels
