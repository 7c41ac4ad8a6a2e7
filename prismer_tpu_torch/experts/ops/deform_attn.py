"""Multi-scale deformable attention: the CUDA kernel's wrapper and the plain
version.

Port of prismer_tpu/experts/ops/deform_attn.py (the plain gather
formulation) and of its `ms_deform_attn_auto` dispatch. The kernel is
`csrc/ms_deform_attn.cu`, which replaces the TPU's one-hot-matmul Pallas
kernel (prismer_tpu/experts/ops/deform_attn_pallas.py); its header note says
what bounds it on the H100 and what its design does about that.

    value               (N, S, H, D) fp32, S = sum_l H_l * W_l
    spatial_shapes      static list of (H_l, W_l)
    sampling_locations  (N, Lq, H, L, P, 2) as (x, y), nominally in [0, 1]
    attention_weights   (N, Lq, H, L, P)
    -> output           (N, Lq, H * D)

Bilinear sampling is torch grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=False): src = loc * size - 0.5, and a corner outside the level
adds nothing. `ms_deform_attn` launches the kernel for CUDA tensors and
computes `ms_deform_attn_reference` only for tensors on the CPU; launches
are counted in `ms_deform_attn.launches`. `deform_plan` is the kernel's
launch plan (levels staged in shared memory, query chunks), computed as the
C entry computes it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch

H100_SMS = 132
# csrc/ms_deform_attn.cu's constants (keep the two in step): warps a
# block, a TMA box's largest extent, the shared memory staged levels may
# take, queries a chunk is cut at below, and the bytes of a block's corner
# tables (16 points of 32 bytes for each of its 4 x WARPS queries in
# flight)
WARPS = 16
BOX_ROWS = 256
STAGE_BYTES = 160 * 1024
MIN_QUERIES = 2 * WARPS
TABLE_BYTES = WARPS * 64 * 32


def deform_plan(shapes: Sequence[Tuple[int, int]], n: int, lq: int,
                heads: int, d: int, points: int, sms: int = H100_SMS,
                aligned: bool = True) -> Dict:
    """The kernel's launch plan, as `make_plan` in csrc/ms_deform_attn.cu
    computes it (keep the two in step).

    * "vec": floats a lane loads per value row, 4 (float4 lanes; D a
      multiple of 4 and value 16-byte aligned) or 1 (scalar lanes);
    * "chunks" of "per" queries each (n, h) is cut into, one block each
      ("blocks"): about one block an SM, and at most one chunk for every
      MIN_QUERIES queries;
    * "staged": the levels held whole in shared memory, smallest first,
      when D rows can be TMA boxes (float4 lanes, D <= 256), the level's
      rows are no more than a chunk's gathers of it (4 corners x P points
      a query) and the budget STAGE_BYTES holds them; each in "boxes" TMA
      boxes of "box_rows" rows (a multiple that keeps every box 128-byte
      aligned) from shared row "srow";
    * "smem": a block's dynamic shared memory: the corner tables
      (TABLE_BYTES), the staged rows and 128 bytes of alignment slack.

    Block b takes (n, h, chunk) = (b // (chunks * heads), b // chunks %
    heads, b % chunks), and in it queries chunk * per ... in index order.
    """
    rows = [hl * wl for hl, wl in shapes]
    nl = len(shapes)
    vec = 4 if d % 4 == 0 and aligned else 1
    most = -(-lq // MIN_QUERIES)
    chunks = max(1, min(sms // max(n * heads, 1), most))
    per = -(-lq // chunks)
    chunks = -(-lq // per)
    staged: List[int] = []
    srow, box_rows, boxes = [-1] * nl, [0] * nl, [0] * nl
    used = 0
    if vec == 4 and d <= BOX_ROWS:
        row_bytes = d * 4
        m = 128 // math.gcd(128, row_bytes)
        for lvl in sorted(range(nl), key=lambda i: (rows[i], i)):
            if rows[lvl] > 4 * points * per:
                continue
            nb = -(-rows[lvl] // BOX_ROWS)
            br = -(-rows[lvl] // nb)
            br = -(-br // m) * m
            if used + nb * br * row_bytes > STAGE_BYTES:
                continue
            staged.append(lvl)
            srow[lvl], box_rows[lvl], boxes[lvl] = used // row_bytes, br, nb
            used += nb * br * row_bytes
    return {
        "vec": vec, "chunks": chunks, "per": per,
        "blocks": n * heads * chunks,
        "staged": sorted(staged), "srow": srow, "box_rows": box_rows,
        "boxes": boxes, "stage_rows": used // (d * 4),
        "smem": TABLE_BYTES + used + 128,
    }


def _bilinear_sample_zero_pad(value_l: torch.Tensor, x: torch.Tensor,
                              y: torch.Tensor) -> torch.Tensor:
    """value_l (B, H, W, D); x, y (B, Q) continuous pixel coordinates in
    grid_sample's align_corners=False frame. Returns (B, Q, D)."""
    b, h, w, d = value_l.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    flat = value_l.reshape(b, h * w, d)

    def gather(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xc = xi.clamp(0, w - 1).long()
        yc = yi.clamp(0, h - 1).long()
        idx = (yc * w + xc)[..., None].expand(-1, -1, d)
        return torch.gather(flat, 1, idx) * inb[..., None]

    v00 = gather(x0, y0)
    v01 = gather(x0 + 1, y0)
    v10 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    top = v00 * (1 - dx) + v01 * dx
    bot = v10 * (1 - dx) + v11 * dx
    return top * (1 - dy) + bot * dy


def ms_deform_attn_reference(value: torch.Tensor,
                             spatial_shapes: Sequence[Tuple[int, int]],
                             sampling_locations: torch.Tensor,
                             attention_weights: torch.Tensor) -> torch.Tensor:
    """The plain version: one gather per corner and level, then the
    attention-weighted sum over levels and points."""
    n, s, h, d = value.shape
    _, lq, _, nl, p, _ = sampling_locations.shape
    outputs = []
    start = 0
    for lid, (hl, wl) in enumerate(spatial_shapes):
        val = value[:, start:start + hl * wl]            # (N, HW, H, D)
        start += hl * wl
        val = val.permute(0, 2, 1, 3).reshape(n * h, hl, wl, d)
        loc = sampling_locations[:, :, :, lid]           # (N, Lq, H, P, 2)
        loc = loc.permute(0, 2, 1, 3, 4).reshape(n * h, lq * p, 2)
        x = loc[..., 0] * wl - 0.5
        y = loc[..., 1] * hl - 0.5
        sampled = _bilinear_sample_zero_pad(val, x, y)    # (N*H, Lq*P, D)
        outputs.append(sampled.reshape(n, h, lq, p, d))
    stacked = torch.stack(outputs, dim=3)                 # (N, H, Lq, L, P, D)
    weights = attention_weights.permute(0, 2, 1, 3, 4)    # (N, H, Lq, L, P)
    out = torch.einsum("nhqlpd,nhqlp->nqhd", stacked, weights)
    return out.reshape(n, lq, h * d)


@functools.lru_cache(maxsize=256)
def _launch_args(shapes: Tuple[Tuple[int, int], ...], n: int, lq: int,
                 heads: int, d: int, points: int, sms: int, aligned: bool):
    """The C entry's level shapes and plan arguments (chunks, staged levels
    as bits, shared memory), kept per call shape: a call at one image is
    short enough that the host's work shows beside it."""
    plan = deform_plan(shapes, n, lq, heads, d, points, sms, aligned)
    flat = [v for hw in shapes for v in hw]
    return ((ctypes.c_int * len(flat))(*flat), plan["chunks"],
            sum(1 << lvl for lvl in plan["staged"]), plan["smem"])


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """See the module docstring. spatial_shapes are Python ints."""
    if value.ndim != 4 or sampling_locations.ndim != 6 \
            or attention_weights.ndim != 5:
        raise ValueError(
            f"ms_deform_attn: value {tuple(value.shape)}, locations "
            f"{tuple(sampling_locations.shape)}, weights "
            f"{tuple(attention_weights.shape)}: want ranks 4, 6 and 5")
    n, s, h, d = value.shape
    _, lq, _, nl, p, _ = sampling_locations.shape
    shapes = [(int(hl), int(wl)) for hl, wl in spatial_shapes]
    if (nl != len(shapes) or s != sum(hl * wl for hl, wl in shapes)
            or tuple(sampling_locations.shape) != (n, lq, h, nl, p, 2)
            or tuple(attention_weights.shape) != (n, lq, h, nl, p)):
        raise ValueError(
            f"ms_deform_attn: value {tuple(value.shape)}, shapes {shapes}, "
            f"locations {tuple(sampling_locations.shape)}, weights "
            f"{tuple(attention_weights.shape)} do not agree")
    for name, x in (("value", value), ("locations", sampling_locations),
                    ("weights", attention_weights)):
        if x.dtype != torch.float32:
            raise ValueError(f"ms_deform_attn: {name} is {x.dtype}; the op "
                             "takes float32")
    if not value.is_cuda:
        return ms_deform_attn_reference(value, shapes, sampling_locations,
                                        attention_weights)
    from prismer_tpu_torch.ops import _build

    for name, x in (("value", value), ("locations", sampling_locations),
                    ("weights", attention_weights)):
        if not x.is_contiguous():
            raise ValueError(f"ms_deform_attn: {name} is not contiguous; the "
                             f"kernel takes contiguous tensors")
    out = torch.empty((n, lq, h * d), dtype=torch.float32,
                      device=value.device)
    c_shapes, chunks, staged, smem = _launch_args(
        tuple(shapes), n, lq, h, d, p, _sm_count(value.device),
        value.data_ptr() % 16 == 0)
    with _build.launch_device("ms_deform_attn", value, sampling_locations,
                              attention_weights):
        err = _build.kernels().prismer_ms_deform_attn(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), out.data_ptr(), c_shapes, n, s, lq,
            h, d, nl, p, chunks, staged, smem,
            torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(err, "ms_deform_attn")
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0
