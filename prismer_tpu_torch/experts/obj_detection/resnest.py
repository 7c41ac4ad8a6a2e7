"""ResNeSt backbone (inference), NHWC: port of
prismer_tpu/experts/obj_detection/resnest.py.

The UniDet expert's ResNeSt-200: a deep stem (three 3x3 convs, width
`stem_width` -> 2 * `stem_width`), a max pool padded with -inf, stages of
`blocks` bottlenecks with radix-2 split-attention 3x3 convs, avd (a 3x3 /
stride average pool after the split attention) and avg_down (a stride x
stride average pool before the shortcut conv), outputs res3, res4, res5.
The average pools divide by the in-bounds count and take the floor of the
output size, as the JAX module's `avg_pool_torch` does. SyncBN is plain
running-statistics BatchNorm at inference.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from prismer_tpu_torch.experts.layers import (BatchNorm, Conv2d, avg_pool,
                                              max_pool)

FP32 = torch.float32
RESNEST200_BLOCKS = (3, 24, 36, 3)


class SplAtConv(nn.Module):
    """Split-attention conv, radix 2, cardinality 1. The radix softmax runs
    over the r axis of (B, 1, 1, r, c), r-major channels, as the JAX
    module orders them."""

    def __init__(self, in_ch: int, channels: int, radix: int = 2,
                 device=None):
        super().__init__()
        r, c = radix, channels
        self.radix, self.channels = r, c
        inter = max(in_ch * r // 4, 32)
        self.conv = Conv2d(in_ch, c * r, 3, padding=1, groups=r, bias=False,
                           device=device)
        self.bn0 = BatchNorm(c * r, 1e-5, device)
        self.fc1 = Conv2d(c, inter, 1, device=device)
        self.bn1 = BatchNorm(inter, 1e-5, device)
        self.fc2 = Conv2d(inter, c * r, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, c = self.radix, self.channels
        h = F.relu(self.bn0(self.conv(x)))
        splits = torch.split(h, c, dim=-1)
        gap = sum(splits)
        gap = gap.mean(dim=(1, 2), keepdim=True)
        gap = F.relu(self.bn1(self.fc1(gap)))
        atten = self.fc2(gap)
        atten = torch.softmax(atten.reshape(h.shape[0], 1, 1, r, c), dim=3)
        return sum(atten[..., i, :] * splits[i] for i in range(r))


class Bottleneck(nn.Module):
    """ResNeSt bottleneck with avd + avg_down (radix 2)."""

    def __init__(self, in_ch: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1, device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv2d(in_ch, bottleneck_channels, 1, bias=False,
                            device=device)
        self.bn1 = BatchNorm(bottleneck_channels, 1e-5, device)
        self.conv2 = SplAtConv(bottleneck_channels, bottleneck_channels,
                               device=device)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=False,
                            device=device)
        self.bn3 = BatchNorm(out_channels, 1e-5, device)
        if in_ch != out_channels:
            self.shortcut_conv = Conv2d(in_ch, out_channels, 1, bias=False,
                                        device=device)
            self.shortcut_bn = BatchNorm(out_channels, 1e-5, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.conv2(h)
        if self.stride > 1:
            h = avg_pool(h, 3, self.stride, 1)
        h = self.bn3(self.conv3(h))
        s = x
        if hasattr(self, "shortcut_conv"):
            if self.stride > 1:
                s = avg_pool(s, self.stride, self.stride, 0)
            s = self.shortcut_bn(self.shortcut_conv(s))
        return F.relu(h + s)


class ResNeSt(nn.Module):
    """Deep-stem ResNeSt; returns {'res3', 'res4', 'res5'}."""

    def __init__(self, blocks: Sequence[int] = RESNEST200_BLOCKS,
                 stem_width: int = 64, device=None):
        super().__init__()
        self.blocks = tuple(blocks)
        in_ch = 3
        for i, (ch, stride) in enumerate(((stem_width, 2), (stem_width, 1),
                                          (stem_width * 2, 1))):
            setattr(self, f"stem_conv{i + 1}", Conv2d(
                in_ch, ch, 3, stride, 1, bias=False, device=device))
            setattr(self, f"stem_bn{i + 1}", BatchNorm(ch, 1e-5, device))
            in_ch = ch
        out_ch, mid = 256, 64
        for s, n in enumerate(self.blocks):
            for b in range(n):
                setattr(self, f"res{s + 2}_block{b}", Bottleneck(
                    in_ch, mid, out_ch, 2 if (b == 0 and s > 0) else 1,
                    device))
                in_ch = out_ch
            out_ch *= 2
            mid *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(FP32)
        for i in range(1, 4):
            x = F.relu(getattr(self, f"stem_bn{i}")(
                getattr(self, f"stem_conv{i}")(x)))
        x = max_pool(x, 3, 2, 1)
        outs = {}
        for s, n in enumerate(self.blocks):
            for b in range(n):
                x = getattr(self, f"res{s + 2}_block{b}")(x)
            if s >= 1:
                outs[f"res{s + 2}"] = x
        return outs
