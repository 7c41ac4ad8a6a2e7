"""`fill_poly`: OpenCV's `cv2.fillPoly(img, [pts], value)` for one int32
polygon on a uint8 image (8-connected lines, no shift), in numpy.

The JAX package's OCR generator rasterises each word's quad with cv2 when
cv2 can be imported; the card's machine has no cv2, so the port carries
this copy of OpenCV's algorithm (imgproc/src/drawing.cpp):
  * every edge is first drawn as an 8-connected Bresenham line
    (`LineIterator`, left to right, clipped to the image by `clipLine`);
  * the edges, x in 16.16 fixed point, are scan-converted as
    `FillEdgeCollection` does: each edge covers rows [y0, y1), the
    active edges are paired left to right, the span from the ceiling of
    the left x to the floor of the right x is filled, and x advances by
    the edge's slope truncated toward zero, a row at a time. An edge
    with an end point outside the image takes the x of its clipped end
    points, and their rows too unless the clipped line is one row.
Degenerate and non-convex polygons and vertices outside the image follow
the same rules; tests/test_torch_expert_ocr.py holds it to cv2 5.0.0.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def clip_line(width: int, height: int, x1: int, y1: int, x2: int,
              y2: int) -> Tuple[bool, int, int, int, int]:
    """OpenCV's clipLine: (inside, x1, y1, x2, y2)."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(img: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> bool:
    h, w = img.shape
    return not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h)


def draw_line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
              value: int) -> None:
    """OpenCV's Line (LineIterator, 8-connected, left to right)."""
    h, w = img.shape
    if _outside(img, x1, y1, x2, y2):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    step_x, step_y = 1, 1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus, minus = dx + dx, -(dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        diag = err < 0
        err += minus + (plus if diag else 0)
        if vert:
            y += step_y
            x += 1 if diag else 0
        else:
            x += step_x
            y += step_y if diag else 0


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_edges(img: np.ndarray, pts: List[Tuple[int, int]],
                   value: int) -> List[_Edge]:
    """CollectPolyEdges (shift 0, 8-connected): draws every edge and
    returns the non-horizontal ones in fixed point."""
    h, w = img.shape
    edges = []
    px0, py0 = pts[-1][0] << XY_SHIFT, pts[-1][1]
    for vx, vy in pts:
        px1, py1 = vx << XY_SHIFT, vy
        t0x = (px0 + (XY_ONE >> 1)) >> XY_SHIFT
        t1x = (px1 + (XY_ONE >> 1)) >> XY_SHIFT
        t0y, t1y = py0, py1
        draw_line(img, t0x, t0y, t1x, t1y, value)
        c0x, c0y, c1x, c1y = px0, py0, px1, py1
        if _outside(img, t0x, t0y, t1x, t1y):
            _, t0x, t0y, t1x, t1y = clip_line(w, h, t0x, t0y, t1x, t1y)
            c0x, c1x = t0x << XY_SHIFT, t1x << XY_SHIFT
            if t0y != t1y:
                c0y, c1y = t0y, t1y
        if py0 != py1:
            dx = _tdiv(c1x - c0x, c1y - c0y)
            if py0 < py1:
                edges.append(_Edge(py0, py1, c0x + (py0 - c0y) * dx, dx))
            else:
                edges.append(_Edge(py1, py0, c1x + (py1 - c1y) * dx, dx))
        px0, py0 = px1, py1
    return edges


def _fill_edges(img: np.ndarray, edges: List[_Edge], value: int) -> None:
    """FillEdgeCollection."""
    h, w = img.shape
    total = len(edges)
    if total < 2:
        return
    y_min, y_max = min(e.y0 for e in edges), max(e.y1 for e in edges)
    xs = [v for e in edges for v in (e.x, e.x + (e.y1 - e.y0) * e.dx)]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx))
    head = _Edge()
    edges.append(_Edge(y0=1 << 62))          # sentinel
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    y = e.y0
    while y < y_max:
        draw = False
        clipline = y < 0
        prelast, last = head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next     # the edge ends at this row
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:                  # the edge starts at this row
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if not clipline:
                    lo, hi = sorted((keep_prelast.x, prelast.x))
                    x1 = (lo + XY_ONE - 1) >> XY_SHIFT
                    x2 = hi >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = value
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble-sort the active list by x
        keep_prelast = None
        while True:
            prelast, last = head, head.next
            last_exchange = None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is head.next or keep_prelast is head:
                break
        y += 1


def fill_poly(img: np.ndarray, pts: np.ndarray, value: int) -> None:
    """`cv2.fillPoly(img, [pts], value)` for a uint8 (H, W) image and an
    (N, 2) int32 polygon of (x, y) vertices."""
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    if not pts:
        return
    _fill_edges(img, _collect_edges(img, pts, value), value)
