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
are counted in `ms_deform_attn.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch


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
        if (not x.is_cuda or x.device != value.device
                or not x.is_contiguous()):
            raise ValueError(f"ms_deform_attn: {name} is on {x.device}, "
                             f"contiguous {x.is_contiguous()}; the kernel "
                             f"takes contiguous tensors on {value.device}")
    out = torch.empty((n, lq, h * d), dtype=torch.float32,
                      device=value.device)
    flat = [v for hw in shapes for v in hw]
    c_shapes = (ctypes.c_int * len(flat))(*flat)
    err = _build.kernels().prismer_ms_deform_attn(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(), c_shapes, n, s, lq, h,
        d, nl, p, torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(err, "ms_deform_attn")
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0
