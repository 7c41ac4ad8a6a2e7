"""Swin Transformer backbone (inference), NHWC: port of
prismer_tpu/experts/segmentation/swin.py.

The segmentation expert's Swin-L: embed 192, depths (2, 2, 18, 2), heads
(6, 12, 24, 48), window 12. A 4x4 conv patch embed + LN; per stage,
alternating regular and shifted (window // 2) window attention with a
relative position bias, an exact-GELU MLP (ratio 4), and patch merging
(LN + bias-free Linear 4C -> 2C) after every stage but the last. Each
output 'res2'..'res5' is the stage output before merging, through its own
`out_norm{s}`. Feature maps are padded to window multiples inside the blocks
after `norm1`, so padded tokens are zeros and are not masked; the shift mask
is built on the padded size.

Attention is plain `torch.matmul` + softmax in fp32 with an additive bias
(the relative-position table, and Swin's -100 mask for shifted windows),
as the JAX package computes it outside any kernel. Submodules carry the
flax scope names, so `state_dict` keys are the flax variable paths.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from prismer_tpu_torch.models.layers import Conv, Dense, LayerNorm

FP32 = torch.float32


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, w*w, C); H, W divisible by w."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_unpartition(x: torch.Tensor, w: int, h: int,
                       wd: int) -> torch.Tensor:
    b = x.shape[0] // ((h // w) * (wd // w))
    x = x.reshape(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


def relative_position_index(w: int) -> np.ndarray:
    """(w*w, w*w) index into the (2w-1)^2 bias table (Swin's rule)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij"))  # (2, w, w)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, ww, ww)
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """Swin's shifted-window attention mask: (nW, ww, ww) additive, -100 for
    pairs from different regions."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = img.reshape(1, hp // window, window, wp // window, window, 1)
    win = win.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def cached_constant(cache: Dict, key, device: torch.device,
                    make: Callable[[], np.ndarray]) -> torch.Tensor:
    """A numpy-built constant on `device`, made once per (key, device) and
    kept in the owning module's `cache`, so a forward copies nothing from
    the host after its first call."""
    k = (key, str(device))
    t = cache.get(k)
    if t is None:
        t = torch.from_numpy(make()).to(device)
        cache[k] = t
    return t


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, c = t.shape
    return t.reshape(b, l, heads, c // heads).permute(0, 2, 1, 3)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, l, h * d)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, device=None):
        super().__init__()
        self.heads = heads
        self.window = window
        self.qkv = Dense(dim, 3 * dim, FP32, device)
        self.proj = Dense(dim, dim, FP32, device)
        self.rel_pos_bias = nn.Parameter(torch.zeros(
            (2 * window - 1) ** 2, heads, device=device))
        self._consts: Dict = {}

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (nW*B, ww, C); mask (nW, ww, ww) additive or None."""
        bnw, ww, c = x.shape
        q, k, v = (split_heads(t, self.heads)
                   for t in self.qkv(x).chunk(3, dim=-1))
        idx = cached_constant(
            self._consts, "index", x.device,
            lambda: relative_position_index(self.window).reshape(-1)
            .astype(np.int64))
        bias = self.rel_pos_bias[idx].reshape(ww, ww, self.heads)
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        s = s + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            s = s.reshape(bnw // nw, nw, self.heads, ww, ww) + mask[:, None]
            s = s.reshape(bnw, self.heads, ww, ww)
        o = torch.matmul(torch.softmax(s, dim=-1), v)
        return self.proj(merge_heads(o))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 device=None):
        super().__init__()
        self.window = window
        self.shift = shift
        self.norm1 = LayerNorm(dim, 1e-5, device)
        self.attn = WindowAttention(dim, heads, window, device)
        self.norm2 = LayerNorm(dim, 1e-5, device)
        self.fc1 = Dense(dim, 4 * dim, FP32, device)
        self.fc2 = Dense(4 * dim, dim, FP32, device)
        self._consts: Dict = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, wd, c = x.shape
        w, s = self.window, self.shift
        y = self.norm1(x)
        pad_h, pad_w = (-h) % w, (-wd) % w
        if pad_h or pad_w:   # after norm1: padded tokens are zeros
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, wd + pad_w
        mask = None
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            mask = cached_constant(self._consts, (hp, wp), x.device,
                                   lambda: shift_attn_mask(hp, wp, w, s))
        y = window_unpartition(self.attn(window_partition(y, w), mask), w, hp,
                               wp)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y[:, :h, :wd]
        y = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, 1e-5, device)
        self.reduction = Dense(4 * dim, 2 * dim, FP32, device, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax 'SAME' padding of an NHWC tensor for a strided conv: the total
    max((ceil(n / s) - 1) * s + k - n, 0), the smaller half before."""
    pads = []
    for n in (x.shape[2], x.shape[1]):          # F.pad order: W, then H
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, (0, 0, *pads))


class SwinTransformer(nn.Module):
    """Returns {'res2': (B, H/4, W/4, C), ..., 'res5': (B, H/32, W/32, 8C)}
    for an NHWC fp32 image batch."""

    def __init__(self, embed_dim: int = 192,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 heads: Sequence[int] = (6, 12, 24, 48), window: int = 12,
                 device=None):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_embed = Conv(3, embed_dim, 4, 4, 0, FP32, device,
                                bias=True)
        self.patch_norm = LayerNorm(embed_dim, 1e-5, device)
        for s, depth in enumerate(self.depths):
            dim = embed_dim * 2 ** s
            for b in range(depth):
                setattr(self, f"stage{s}_block{b}", SwinBlock(
                    dim, heads[s], window, 0 if b % 2 == 0 else window // 2,
                    device))
            setattr(self, f"out_norm{s}", LayerNorm(dim, 1e-5, device))
            if s < len(self.depths) - 1:
                setattr(self, f"downsample{s}", PatchMerging(dim, device))

    @property
    def channels(self) -> tuple:
        """Channels of res2..res5."""
        c = self.patch_embed.out_channels
        return tuple(c * 2 ** s for s in range(len(self.depths)))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.patch_norm(self.patch_embed(same_pad(x.to(FP32), 4, 4)))
        outs = {}
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
            outs[f"res{s + 2}"] = getattr(self, f"out_norm{s}")(x)
            if s < len(self.depths) - 1:
                x = getattr(self, f"downsample{s}")(x)
        return outs
