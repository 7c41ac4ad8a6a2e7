"""DexiNed edge-detection expert (inference), NHWC: port of
prismer_tpu/experts/edge/model.py.

A dense-inception edge network with 7 outputs: 6 side scales and their
fused map; the generator uses the fused map (sigmoid, then inverted).
  block_1: DoubleConv(3 -> 32 -> 64, stride 2); block_2: DoubleConv(64 ->
  128, no final relu); dense blocks 3-6 of (relu, conv3 pad 2, BN, relu,
  conv3 pad 0, BN) layers that average with a skip (0.5 * (new + skip));
  side / pre_dense 1x1 conv + BN laterals; max pool 3x3 / 2 / pad 1
  (-inf pads) between blocks; up blocks of (1x1 conv, relu,
  ConvTranspose k = 2^s, stride 2, pad all_pads[s]) back to full
  resolution; block_cat fuses the six with a 1x1 conv.

The transposed convolution is F.conv_transpose2d on an (in, out, kh, kw)
weight (see `experts.layers.ConvTranspose2d` for how the JAX kernel maps
onto it).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from prismer_tpu_torch.experts.layers import (BatchNorm, Conv2d,
                                              ConvTranspose2d, max_pool)

FP32 = torch.float32
UP_PADS = {1: 0, 2: 1, 3: 3, 4: 7}  # all_pads[up_scale]


class DoubleConvBlock(nn.Module):
    def __init__(self, in_ch: int, mid: int, out: int = None, stride: int = 1,
                 use_act: bool = True, device=None):
        super().__init__()
        out = mid if out is None else out
        self.use_act = use_act
        self.conv1 = Conv2d(in_ch, mid, 3, stride, 1, device=device)
        self.bn1 = BatchNorm(mid, 1e-5, device)
        self.conv2 = Conv2d(mid, out, 3, 1, 1, device=device)
        self.bn2 = BatchNorm(out, 1e-5, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.bn2(self.conv2(x))
        return F.relu(x) if self.use_act else x


class SingleConvBlock(nn.Module):
    def __init__(self, in_ch: int, out: int, stride: int = 1,
                 use_bn: bool = True, device=None):
        super().__init__()
        self.conv = Conv2d(in_ch, out, 1, stride, device=device)
        if use_bn:
            self.bn = BatchNorm(out, 1e-5, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return self.bn(x) if hasattr(self, "bn") else x


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, out: int, device=None):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out, 3, 1, 2, device=device)
        self.bn1 = BatchNorm(out, 1e-5, device)
        self.conv2 = Conv2d(out, out, 3, 1, 0, device=device)
        self.bn2 = BatchNorm(out, 1e-5, device)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        h = self.bn1(self.conv1(F.relu(x1)))
        h = self.bn2(self.conv2(F.relu(h)))
        return 0.5 * (h + x2)


class DenseBlock(nn.Module):
    def __init__(self, num_layers: int, in_ch: int, out: int, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"denselayer_{i}",
                    DenseLayer(in_ch if i == 0 else out, out, device))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x1 = getattr(self, f"denselayer_{i}")(x1, x2)
        return x1


class UpConvBlock(nn.Module):
    def __init__(self, in_ch: int, up_scale: int, device=None):
        super().__init__()
        self.up_scale = up_scale
        k, pad = 2 ** up_scale, UP_PADS[up_scale]
        for i in range(up_scale):
            out = 1 if i == up_scale - 1 else 16
            setattr(self, f"conv_{i}", Conv2d(in_ch, out, 1, device=device))
            setattr(self, f"deconv_{i}", ConvTranspose2d(out, out, k, 2, pad,
                                                         device))
            in_ch = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.up_scale):
            x = F.relu(getattr(self, f"conv_{i}")(x))
            x = getattr(self, f"deconv_{i}")(x)
        return x


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return max_pool(x, 3, 2, 1)


class DexiNed(nn.Module):
    """Returns the 7 output maps (6 scales + fused), NHWC logits."""

    def __init__(self, device=None):
        super().__init__()
        d = device
        self.block_1 = DoubleConvBlock(3, 32, 64, stride=2, device=d)
        self.block_2 = DoubleConvBlock(64, 128, use_act=False, device=d)
        self.dblock_3 = DenseBlock(2, 128, 256, d)
        self.dblock_4 = DenseBlock(3, 256, 512, d)
        self.dblock_5 = DenseBlock(3, 512, 512, d)
        self.dblock_6 = DenseBlock(3, 512, 256, d)
        self.side_1 = SingleConvBlock(64, 128, 2, device=d)
        self.side_2 = SingleConvBlock(128, 256, 2, device=d)
        self.side_3 = SingleConvBlock(256, 512, 2, device=d)
        self.side_4 = SingleConvBlock(512, 512, 1, device=d)
        self.pre_dense_2 = SingleConvBlock(128, 256, 2, device=d)
        self.pre_dense_3 = SingleConvBlock(128, 256, 1, device=d)
        self.pre_dense_4 = SingleConvBlock(256, 512, 1, device=d)
        self.pre_dense_5 = SingleConvBlock(512, 512, 1, device=d)
        self.pre_dense_6 = SingleConvBlock(512, 256, 1, device=d)
        for i, (ch, s) in enumerate(((64, 1), (128, 1), (256, 2), (512, 3),
                                     (512, 4), (256, 4))):
            setattr(self, f"up_block_{i + 1}", UpConvBlock(ch, s, d))
        self.block_cat = SingleConvBlock(6, 1, 1, use_bn=False, device=d)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        block_1 = self.block_1(x.to(FP32))
        block_1_side = self.side_1(block_1)
        block_2 = self.block_2(block_1)
        block_2_down = _maxpool(block_2)
        block_2_add = block_2_down + block_1_side
        block_2_side = self.side_2(block_2_add)

        block_3_pre = self.pre_dense_3(block_2_down)
        block_3 = self.dblock_3(block_2_add, block_3_pre)
        block_3_down = _maxpool(block_3)
        block_3_add = block_3_down + block_2_side
        block_3_side = self.side_3(block_3_add)

        block_2_resize_half = self.pre_dense_2(block_2_down)
        block_4_pre = self.pre_dense_4(block_3_down + block_2_resize_half)
        block_4 = self.dblock_4(block_3_add, block_4_pre)
        block_4_down = _maxpool(block_4)
        block_4_add = block_4_down + block_3_side
        block_4_side = self.side_4(block_4_add)

        block_5_pre = self.pre_dense_5(block_4_down)
        block_5 = self.dblock_5(block_4_add, block_5_pre)
        block_5_add = block_5 + block_4_side

        block_6_pre = self.pre_dense_6(block_5)
        block_6 = self.dblock_6(block_5_add, block_6_pre)

        outs = [self.up_block_1(block_1), self.up_block_2(block_2),
                self.up_block_3(block_3), self.up_block_4(block_4),
                self.up_block_5(block_5), self.up_block_6(block_6)]
        return outs + [self.block_cat(torch.cat(outs, dim=-1))]
