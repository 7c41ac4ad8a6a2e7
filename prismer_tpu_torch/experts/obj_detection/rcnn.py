"""UniDet unified-detector inference: FPN (P3-P7) + RPN + cascade ROI
heads, a port of prismer_tpu/experts/obj_detection/rcnn.py.

  * FPN over res3-5 with BatchNorm lateral / output convs, P6 / P7 by
    stride-2 convs from P5, nearest x2 top-down;
  * RPN: a shared 3x3 conv + objectness / 4-delta heads over P3-P7, 3
    anchors a cell (sizes 32..512, ratios 0.5 / 1 / 2), pre-NMS top-1000
    a level, IoU-0.7 NMS, post-NMS top-1000;
  * ROIAlign-v2 (aligned, 2x2 sampling) at resolution 7 as a plain gather,
    level by floor(4 + log2(sqrt(area) / 224)) clamped to P3-P5;
  * 3 cascade stages, each box head 4x (conv3x3 + BN + relu), fc 1024,
    class-agnostic deltas and a 722-way sigmoid classifier; the final
    scores are the mean of the three stages' sigmoids;
  * class-wise NMS 0.5, score 1e-4, top-300 detections.

`UniDet.features`, `.rpn_proposals` and `.cascade_stage` run on the
device; `detect_single` runs the sequential NMS passes on the host in
numpy, copied from the JAX module, so `argsort()[::-1]` and `np.unique`
fix the same order. The per-level top-k is a stable descending sort, which
puts ties at the lowest index as `jax.lax.top_k` does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from prismer_tpu_torch.experts.layers import BatchNorm, Conv2d
from prismer_tpu_torch.experts.obj_detection.resnest import (
    RESNEST200_BLOCKS, ResNeSt)
from prismer_tpu_torch.experts.segmentation.swin import cached_constant
from prismer_tpu_torch.models.layers import Dense

FP32 = torch.float32
NUM_CLASSES = 722
FPN_DIM = 256
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
LEVEL_STRIDES = (8, 16, 32, 64, 128)          # p3..p7
LEVEL_SIZES = (32, 64, 128, 256, 512)
PRE_NMS_TOPK = 1000
POST_NMS_TOPK = 1000
RPN_NMS_IOU = 0.7
DET_SCORE_THRESH = 1e-4
DET_NMS_IOU = 0.5
DET_TOPK = 300
CASCADE_WEIGHTS = ((10., 10., 5., 5.), (20., 20., 10., 10.),
                   (30., 30., 15., 15.))
FEATURE_CHANNELS = {"res3": 512, "res4": 1024, "res5": 2048}


class FPN(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        for f, ch in FEATURE_CHANNELS.items():
            setattr(self, f"lateral_{f}", Conv2d(ch, FPN_DIM, 1, bias=False,
                                                 device=device))
            setattr(self, f"lateral_bn_{f}", BatchNorm(FPN_DIM, 1e-5, device))
        for f in ("p3", "p4", "p5"):
            setattr(self, f"output_{f}", Conv2d(FPN_DIM, FPN_DIM, 3,
                                                padding=1, bias=False,
                                                device=device))
            setattr(self, f"output_bn_{f}", BatchNorm(FPN_DIM, 1e-5, device))
        self.p6 = Conv2d(FPN_DIM, FPN_DIM, 3, 2, 1, device=device)
        self.p7 = Conv2d(FPN_DIM, FPN_DIM, 3, 2, 1, device=device)

    def forward(self, feats: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral_bn_{f}")(
            getattr(self, f"lateral_{f}")(feats[f]))
            for f in FEATURE_CHANNELS]
        for i in (1, 0):
            upper = laterals[i + 1].repeat_interleave(2, dim=1)
            upper = upper.repeat_interleave(2, dim=2)
            h, w = laterals[i].shape[1:3]
            laterals[i] = laterals[i] + upper[:, :h, :w]
        outs = [getattr(self, f"output_bn_{f}")(getattr(self, f"output_{f}")(
            laterals[i])) for i, f in enumerate(("p3", "p4", "p5"))]
        p6 = self.p6(outs[2])
        return outs + [p6, self.p7(F.relu(p6))]


class RPNHead(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        a = len(ANCHOR_RATIOS)
        self.conv = Conv2d(FPN_DIM, FPN_DIM, 3, padding=1, device=device)
        self.objectness = Conv2d(FPN_DIM, a, 1, device=device)
        self.anchor_deltas = Conv2d(FPN_DIM, 4 * a, 1, device=device)

    def forward(self, feats: List[torch.Tensor]):
        logits, boxes = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            logits.append(self.objectness(t))
            boxes.append(self.anchor_deltas(t))
        return logits, boxes


def level_anchors(h: int, w: int, stride: int, size: int) -> np.ndarray:
    """(h*w*3, 4) xyxy anchors, detectron2's grid (centres at x * stride,
    offset 0)."""
    anchors = []
    area = float(size * size)
    for ratio in ANCHOR_RATIOS:
        aw = np.sqrt(area / ratio)
        ah = aw * ratio
        anchors.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
    base = np.asarray(anchors, np.float32)  # (3, 4)
    xs = np.arange(w, dtype=np.float32) * stride
    ys = np.arange(h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(xs, ys)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 clip: float = float(np.log(1000.0 / 16))) -> torch.Tensor:
    """detectron2 Box2BoxTransform.apply_deltas."""
    wx, wy, ww, wh = weights
    widths = anchors[:, 2] - anchors[:, 0]
    heights = anchors[:, 3] - anchors[:, 1]
    cx = anchors[:, 0] + 0.5 * widths
    cy = anchors[:, 1] + 0.5 * heights
    dx, dy = deltas[:, 0] / wx, deltas[:, 1] / wy
    dw = torch.clamp(deltas[:, 2] / ww, max=clip)
    dh = torch.clamp(deltas[:, 3] / wh, max=clip)
    pcx = dx * widths + cx
    pcy = dy * heights + cy
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - pw / 2, pcy - ph / 2,
                        pcx + pw / 2, pcy + ph / 2], dim=-1)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, stride: int,
              resolution: int = 7, sampling: int = 2) -> torch.Tensor:
    """ROIAlign-v2 (aligned=True): feat (H, W, C) of one image, boxes (N, 4)
    xyxy in image coordinates. Returns (N, res, res, C)."""
    h, w, c = feat.shape
    n = boxes.shape[0]
    b = boxes / stride
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    bw = torch.clamp(x2 - x1, min=1e-6)
    bh = torch.clamp(y2 - y1, min=1e-6)
    g = resolution * sampling
    steps = (torch.arange(g, dtype=FP32, device=feat.device) + 0.5) / g
    xs = x1[:, None] + steps[None, :] * bw[:, None] - 0.5   # aligned=True
    ys = y1[:, None] + steps[None, :] * bh[:, None] - 0.5
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    flat = feat.reshape(h * w, c)

    def gather(yi, xi):
        yi = torch.clamp(yi, 0, h - 1).to(torch.int64)
        xi = torch.clamp(xi, 0, w - 1).to(torch.int64)
        idx = (yi[:, :, None] * w + xi[:, None, :]).reshape(n, -1)
        return flat[idx].reshape(n, g, g, c)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    wy0 = (1 - fy)[:, :, None, None]
    wy1 = fy[:, :, None, None]
    wx0 = (1 - fx)[:, None, :, None]
    wx1 = fx[:, None, :, None]
    vals = (v00 * wy0 * wx0 + v01 * wy0 * wx1 + v10 * wy1 * wx0
            + v11 * wy1 * wx1)
    vals = vals.reshape(n, resolution, sampling, resolution, sampling, c)
    return vals.mean(dim=(2, 4))


def assign_levels(boxes: torch.Tensor, k_min: int = 3,
                  k_max: int = 5) -> torch.Tensor:
    """FPN level assignment: floor(4 + log2(sqrt(area) / 224)), clamped."""
    area = torch.clamp((boxes[:, 2] - boxes[:, 0])
                       * (boxes[:, 3] - boxes[:, 1]), min=1e-12)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-8))
    return torch.clamp(lvl, k_min, k_max).to(torch.int32)


class CascadeBoxHead(nn.Module):
    """4x conv3x3+BN+relu -> flatten (h, w, c) -> fc1024 -> (sigmoid
    classes, 4 deltas)."""

    def __init__(self, device=None):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i}", Conv2d(FPN_DIM, FPN_DIM, 3, padding=1,
                                             bias=False, device=device))
            setattr(self, f"conv_bn{i}", BatchNorm(FPN_DIM, 1e-5, device))
        self.fc1 = Dense(7 * 7 * FPN_DIM, 1024, FP32, device)
        self.cls_score = Dense(1024, NUM_CLASSES, FP32, device)
        self.bbox_pred = Dense(1024, 4, FP32, device)

    def forward(self, x: torch.Tensor):
        for i in range(4):
            x = F.relu(getattr(self, f"conv_bn{i}")(
                getattr(self, f"conv{i}")(x)))
        x = F.relu(self.fc1(x.reshape(x.shape[0], -1)))
        return self.cls_score(x), self.bbox_pred(x)


class UniDet(nn.Module):
    """The device-side parts, one module whose state dict is the union of
    the JAX package's three separately initialised trees (features, RPN,
    cascade heads). `blocks` and `stem_width` size the backbone (the
    expert's: ResNeSt-200, 64); the tests pass small ones."""

    def __init__(self, blocks: Sequence[int] = RESNEST200_BLOCKS,
                 stem_width: int = 64, device=None):
        super().__init__()
        self.backbone = ResNeSt(blocks, stem_width, device)
        self.fpn = FPN(device)
        self.rpn = RPNHead(device)
        for i in range(3):
            setattr(self, f"box_head_{i}", CascadeBoxHead(device))
        self._consts: Dict = {}

    def features(self, image: torch.Tensor) -> List[torch.Tensor]:
        """image: (1, H, W, 3) normalised. Returns P3..P7 (NHWC)."""
        return self.fpn(self.backbone(image))

    def level_topk(self, feats: List[torch.Tensor]):
        """Per level: (the top-k objectness logits, their indices into the
        level's anchors, the level's deltas (A, 4))."""
        logits, deltas = self.rpn(feats)
        out = []
        for lvl in range(len(feats)):
            s = logits[lvl].reshape(-1)
            k = min(PRE_NMS_TOPK, s.shape[0])
            top_s, idx = torch.sort(s, descending=True, stable=True)
            out.append((top_s[:k], idx[:k], deltas[lvl].reshape(-1, 4)))
        return out

    def rpn_proposals(self, feats: List[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-level top-k decoded proposals: (boxes (L*K, 4), scores
        (L*K,)); host NMS follows."""
        all_boxes, all_scores = [], []
        for lvl, (top_s, idx, d) in enumerate(self.level_topk(feats)):
            h, w = feats[lvl].shape[1:3]
            anchors = cached_constant(
                self._consts, ("anchors", lvl, h, w), top_s.device,
                lambda: level_anchors(h, w, LEVEL_STRIDES[lvl],
                                      LEVEL_SIZES[lvl]))
            all_boxes.append(decode_boxes(anchors[idx], d[idx]))
            all_scores.append(top_s)
        return torch.cat(all_boxes), torch.cat(all_scores)

    def cascade_stage(self, feats: List[torch.Tensor], boxes: torch.Tensor,
                      stage: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One cascade stage on (N, 4) boxes -> (sigmoid scores (N, C),
        refined boxes (N, 4)). ROIAlign runs per level on the boxes that
        level takes (each box's pooling is independent of the others)."""
        levels = assign_levels(boxes)
        pooled = torch.zeros(boxes.shape[0], 7, 7, FPN_DIM, dtype=FP32,
                             device=boxes.device)
        for lvl in range(3, 6):   # p3..p5
            rows = torch.nonzero(levels == lvl).reshape(-1)
            if rows.numel():
                pooled[rows] = roi_align(feats[lvl - 3][0].float(),
                                         boxes[rows], LEVEL_STRIDES[lvl - 3])
        cls, deltas = getattr(self, f"box_head_{stage}")(pooled)
        refined = decode_boxes(boxes, deltas.float(),
                               weights=CASCADE_WEIGHTS[stage])
        return torch.sigmoid(cls.float()), refined


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float,
             max_keep: int) -> np.ndarray:
    """Host greedy NMS; returns kept indices (score-sorted)."""
    x1, y1, x2, y2 = boxes.T
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0 and len(keep) < max_keep:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-12)
        order = order[1:][iou <= iou_thresh]
    return np.asarray(keep, np.int64)


def proposals_after_nms(p_boxes: np.ndarray, p_scores: np.ndarray,
                        image_hw: Tuple[int, int]) -> np.ndarray:
    """The RPN's proposals clipped to the image and NMS'd on the host,
    padded with zero boxes to POST_NMS_TOPK rows."""
    b = np.array(p_boxes)
    h, w = image_hw
    b[:, 0::2] = b[:, 0::2].clip(0, w)
    b[:, 1::2] = b[:, 1::2].clip(0, h)
    keep = nms_xyxy(b, np.array(p_scores), RPN_NMS_IOU, POST_NMS_TOPK)
    boxes = np.zeros((POST_NMS_TOPK, 4), np.float32)
    boxes[: len(keep)] = b[keep]
    return boxes


def classwise_detections(final_scores: np.ndarray, final_boxes: np.ndarray,
                         image_hw: Tuple[int, int]):
    """The host's class-wise NMS over the cascade's mean scores (N, C) and
    last boxes (N, 4): (boxes (M, 4), scores (M,), classes (M,))."""
    h, w = image_hw
    final_boxes = np.array(final_boxes)
    final_boxes[:, 0::2] = final_boxes[:, 0::2].clip(0, w)
    final_boxes[:, 1::2] = final_boxes[:, 1::2].clip(0, h)
    out_b, out_s, out_c = [], [], []
    cand_r, cand_c = np.nonzero(final_scores > DET_SCORE_THRESH)
    for cls in np.unique(cand_c):
        rows = cand_r[cand_c == cls]
        keep = nms_xyxy(final_boxes[rows], final_scores[rows, cls],
                        DET_NMS_IOU, DET_TOPK)
        out_b.append(final_boxes[rows[keep]])
        out_s.append(final_scores[rows[keep], cls])
        out_c.append(np.full(len(keep), cls, np.int64))
    if not out_b:
        return (np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                np.zeros(0, np.int64))
    boxes = np.concatenate(out_b)
    scores = np.concatenate(out_s)
    classes = np.concatenate(out_c)
    order = scores.argsort()[::-1][:DET_TOPK]
    return boxes[order], scores[order], classes[order]


@torch.no_grad()
def detect_single(model: UniDet, image: torch.Tensor,
                  image_hw: Tuple[int, int], timer=None):
    """Full single-image inference. Returns (boxes (M, 4), scores (M,),
    classes (M,)) as numpy. `image`: (1, H, W, 3) pixel-normalised, on the
    model's device. `timer`, when given, is entered around each device
    part (with its copies to the host)."""
    timer = timer or (lambda: contextlib.nullcontext())
    with timer():
        feats = model.features(image)
        p_boxes, p_scores = (t.cpu().numpy()
                             for t in model.rpn_proposals(feats))
    boxes = proposals_after_nms(p_boxes, p_scores, image_hw)
    stage_scores = []
    with timer():
        boxes_t = torch.from_numpy(boxes).to(image.device)
        for stage in range(3):
            scores, boxes_t = model.cascade_stage(feats, boxes_t, stage)
            stage_scores.append(scores.cpu().numpy())
        final_boxes = boxes_t.cpu().numpy()
    final_scores = np.mean(stage_scores, axis=0)       # (N, C)
    return classwise_detections(final_scores, final_boxes, image_hw)
