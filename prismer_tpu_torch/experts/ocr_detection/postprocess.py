"""Oriented-text post-processing (host, pure numpy), copied from
prismer_tpu/experts/ocr_detection/postprocess.py.

Re-implementation of the reference's polygon pipeline
(charnet/modeling/{postprocessing.py, rotated_nms.py, utils.py}) without
pyclipper/shapely/editdistance:

  * rotated word/char boxes from per-pixel tblr + orientation
    (postprocessing.py:90-154, utils.py:rotate_rect)
  * weighted-merge rotated NMS with the reference's neighbour rule
    (rotated_nms.py:13-56): a kept box needs >= num_neig neighbours
    (IoU > 0.5); its coords become the score-weighted mean of the
    neighbourhood; otherwise it is dropped and its suppressions undone
  * quad intersection via Sutherland–Hodgman convex clipping + shoelace area
  * word-char assembly by max-IoU assignment, left-to-right char ordering,
    per-char argmax decoding (postprocessing.py:218-289)
  * lexicon correction by Levenshtein distance with the reference's
    acceptance thresholds (postprocessing.py:156-198)

Defaults from charnet/config/defaults.py:13-28.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

WORD_MIN_SCORE = 0.5
WORD_NMS_IOU = 0.15
CHAR_MIN_SCORE = 0.25
CHAR_NMS_IOU = 0.3
STRIDE = 4


# -- geometry ---------------------------------------------------------------

def polygon_area(poly: np.ndarray) -> float:
    """Shoelace |area| of an (N, 2) polygon."""
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip `subject` by convex `clip` (both (N,2)).
    The clip polygon may wind either way; it is normalized to CCW."""
    if _signed_area(clip) < 0:
        clip = clip[::-1]
    output = [tuple(p) for p in subject]
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        input_pts, output = output, []
        if not input_pts:
            break
        s = input_pts[-1]
        for e in input_pts:
            e_in = _inside(e, a, b)
            s_in = _inside(s, a, b)
            if e_in:
                if not s_in:
                    output.append(_intersect(s, e, a, b))
                output.append(e)
            elif s_in:
                output.append(_intersect(s, e, a, b))
            s = e
    return np.asarray(output, np.float64) if output else np.zeros((0, 2))


def _signed_area(poly) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _inside(p, a, b) -> bool:
    return ((b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])) >= 0


def _intersect(s, e, a, b):
    dx1, dy1 = e[0] - s[0], e[1] - s[1]
    dx2, dy2 = b[0] - a[0], b[1] - a[1]
    denom = dx1 * dy2 - dy1 * dx2
    if abs(denom) < 1e-12:
        return e
    t = ((a[0] - s[0]) * dy2 - (a[1] - s[1]) * dx2) / denom
    return (s[0] + t * dx1, s[1] + t * dy1)


def quad_iou(b1: np.ndarray, b2: np.ndarray) -> float:
    p1 = b1[:8].reshape(4, 2)
    p2 = b2[:8].reshape(4, 2)
    inter_poly = clip_polygon(p1, p2)
    inter = polygon_area(inter_poly) if len(inter_poly) >= 3 else 0.0
    union = polygon_area(p1) + polygon_area(p2) - inter
    return inter / union if union > 0 else 0.0


def rotate_rect(x1, y1, x2, y2, rad, cx, cy) -> List[List[float]]:
    """(utils.py:rotate_rect) — rotate the axis-aligned rect's corners."""
    pts = [[x1, y1], [x2, y1], [x2, y2], [x1, y2]]
    out = []
    for px, py in pts:
        dx, dy = px - cx, py - cy
        out.append([cx + dx * math.cos(rad) - dy * math.sin(rad),
                    cy + dx * math.sin(rad) + dy * math.cos(rad)])
    return out


# -- NMS ---------------------------------------------------------------------

def weighted_nms(boxes: np.ndarray, overlap_thresh: float,
                 neighbour_thresh: float = 0.5, min_score: float = 0.0,
                 num_neig: int = 0,
                 extra: Optional[np.ndarray] = None):
    """rotated_nms.nms / nms_with_char_cls semantics. boxes (N, 9);
    optional extra (N, C) merged with the same weights (char scores)."""
    n = boxes.shape[0]
    new_boxes = np.zeros_like(boxes)
    new_extra = np.zeros_like(extra) if extra is not None else None
    pick: List[int] = []
    suppressed = [False] * n
    order = boxes[:, 8].argsort()[::-1]
    for oi, i in enumerate(order):
        if suppressed[i]:
            continue
        pick.append(i)
        neighbours = []
        for j in order[oi + 1:]:
            if suppressed[j]:
                continue
            iou = quad_iou(boxes[i], boxes[j])
            if iou > overlap_thresh:
                suppressed[j] = True
            if iou > neighbour_thresh:
                neighbours.append(j)
        if len(neighbours) >= num_neig:
            group = neighbours + [i]
            w = (boxes[group, 8] - min_score).reshape(-1, 1)
            new_boxes[i, :8] = (boxes[group, :8] * w).sum(0) / w.sum()
            new_boxes[i, 8] = boxes[i, 8]
            if extra is not None:
                new_extra[i] = (extra[group] * w).sum(0) / w.sum()
        else:
            for nj in neighbours:
                suppressed[nj] = False
            pick.pop()
    if extra is not None:
        return pick, new_boxes, new_extra
    return pick, new_boxes


# -- box parsing --------------------------------------------------------------

def _parse_boxes(fg: np.ndarray, tblr: np.ndarray,
                 orient: Optional[np.ndarray], min_score: float,
                 scale_w: float, scale_h: float, W: int, H: int,
                 extra_maps: Optional[np.ndarray] = None,
                 keep_mask: Optional[np.ndarray] = None):
    """Shared word/char box construction (postprocessing.py:90-154).
    fg: (h, w) foreground prob; tblr: (h, w, 4); orient: (h, w) or None."""
    mask = fg > min_score
    if keep_mask is not None:
        mask &= keep_mask
    ys, xs = np.nonzero(mask)
    boxes = np.zeros((len(ys), 9), np.float32)
    extras = (np.zeros((len(ys), extra_maps.shape[-1]), np.float32)
              if extra_maps is not None else None)
    for idx, (y, x) in enumerate(zip(ys, xs)):
        t, b, l, r = tblr[y, x]
        o = float(orient[y, x]) if orient is not None else 0.0
        pts = rotate_rect(scale_w * STRIDE * (x - l),
                          scale_h * STRIDE * (y - t),
                          scale_w * STRIDE * (x + r),
                          scale_h * STRIDE * (y + b),
                          o, scale_w * STRIDE * x, scale_h * STRIDE * y)
        boxes[idx, :8] = np.asarray(pts, np.float32).reshape(-1)
        boxes[idx, 8] = fg[y, x]
        if extras is not None:
            extras[idx] = extra_maps[y, x]
    return boxes, extras


def _clip_round(boxes: np.ndarray, W: int, H: int) -> np.ndarray:
    boxes[:, :8] = boxes[:, :8].round()
    boxes[:, 0:8:2] = np.clip(boxes[:, 0:8:2], 0, W - 1)
    boxes[:, 1:8:2] = np.clip(boxes[:, 1:8:2], 0, H - 1)
    return boxes


@dataclass
class WordInstance:
    word_bbox: np.ndarray
    word_bbox_score: float
    text: str
    text_score: float
    char_scores: np.ndarray
    text_edst: int = 0


def levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


DEFAULT_CHAR_DICT = {i: c for i, c in enumerate(
    "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!?.,'-&")}


class OrientedTextPostProcessing:
    """Host-side decode; see module docstring. char_dict maps class index ->
    char (upper-cased); lexicon is a list of vocabulary words or None."""

    def __init__(self, char_dict: Optional[Dict[int, str]] = None,
                 lexicon: Optional[Sequence[str]] = None,
                 word_min_score: float = WORD_MIN_SCORE,
                 word_nms_iou: float = WORD_NMS_IOU,
                 char_min_score: float = CHAR_MIN_SCORE,
                 char_nms_iou: float = CHAR_NMS_IOU):
        self.char_dict = {k: v.upper() for k, v in
                          (char_dict or DEFAULT_CHAR_DICT).items()}
        self.lexicon = list(lexicon) if lexicon else None
        self.word_min_score = word_min_score
        self.word_nms_iou = word_nms_iou
        self.char_min_score = char_min_score
        self.char_nms_iou = char_nms_iou

    def __call__(self, preds: Dict[str, np.ndarray], scale_w: float,
                 scale_h: float, W: int, H: int) -> List[WordInstance]:
        """preds: one sample's maps (h, w, C) from experts.ocr_detection
        CharNet. Returns the surviving word instances."""
        word_fg = preds["word_fg"][..., 1]
        char_fg = preds["char_fg"][..., 1]

        word_boxes, _ = _parse_boxes(
            word_fg, preds["word_tblr"], preds["word_orient"][..., 0],
            self.word_min_score, scale_w, scale_h, W, H)
        keep, word_boxes = weighted_nms(word_boxes, self.word_nms_iou,
                                        num_neig=1)
        word_boxes = _clip_round(word_boxes[keep], W, H)

        char_boxes, char_scores = _parse_boxes(
            char_fg, preds["char_tblr"], None, self.char_min_score,
            scale_w, scale_h, W, H, extra_maps=preds["char_cls"],
            keep_mask=word_fg > self.word_min_score)
        keep, char_boxes, char_scores = weighted_nms(
            char_boxes, self.char_nms_iou, num_neig=1, extra=char_scores)
        char_boxes = _clip_round(char_boxes[keep], W, H)
        char_scores = char_scores[keep]

        words = self._assemble(word_boxes, char_boxes, char_scores)
        return self._filter(words)

    def _assemble(self, word_boxes, char_boxes, char_scores
                  ) -> List[WordInstance]:
        """Max-IoU char->word assignment + left-to-right decode
        (postprocessing.py:218-289)."""
        nw = word_boxes.shape[0]
        if nw == 0:
            return []
        assigned: List[List[int]] = [[] for _ in range(nw)]
        for ci in range(char_boxes.shape[0]):
            ious = np.array([quad_iou(char_boxes[ci], word_boxes[wi])
                             for wi in range(nw)])
            wi = int(np.argmax(ious))
            if ious[wi] > 0:
                assigned[wi].append(ci)
        out = []
        for wi in range(nw):
            if not assigned[wi]:
                continue
            cb = char_boxes[assigned[wi], :8]
            cs = char_scores[assigned[wi]]
            centers = cb.reshape(-1, 4, 2).mean(axis=1) - word_boxes[wi, :2]
            order = np.argsort(centers[:, 0])  # project on (1, 0)
            cs = cs[order]
            idxs = cs.argmax(axis=1)
            text = "".join(self.char_dict.get(int(i), "?") for i in idxs)
            score = float(np.mean([cs[r, idxs[r]] for r in range(len(idxs))]))
            out.append(WordInstance(word_boxes[wi, :8],
                                    float(word_boxes[wi, 8]),
                                    text, score, cs))
        return out

    def _filter(self, words: List[WordInstance]) -> List[WordInstance]:
        """Score gates + lexicon correction (postprocessing.py:156-198)."""
        out = []
        for w in words:
            if w.text_score < 0.80:
                continue
            if (not w.text.isalpha() and w.text_score >= 0.9) \
                    or w.text_score >= 0.98 or not self.lexicon:
                out.append(w)
                continue
            dists = [(levenshtein(w.text.upper(), v.upper()), v)
                     for v in self.lexicon]
            dist, voc = min(dists, key=lambda t: t[0])
            w.text, w.text_edst = voc, dist
            budget = 0 if len(voc) <= 2 else (1 if len(voc) <= 5 else 2)
            if dist <= budget:
                out.append(w)
        return out
