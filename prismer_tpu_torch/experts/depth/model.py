"""DPT-hybrid monocular depth expert (inference), NHWC: port of
prismer_tpu/experts/depth/model.py.

A ResNetV2 front (weight-standardised convs + GroupNorm-32, pre-activation
bottlenecks; stem + stages of 3, 4 and 9 blocks) feeds a ViT-B/1 patch
projection over the 1/16 feature map (timm 'vit_base_resnet50_384'), then
DPT's reassemble + RefineNet fusion decoder and the monocular-depth head.

Feature taps: ResNet stage 0 (/4) and 1 (/8); the pre-norm tokens of ViT
blocks 8 and 11, each through project-readout and a 1x1 conv, the second
then a 3x3 stride-2 conv (/32). Each level goes through a 3x3 'scratch'
conv to 256 channels, then RefineNet fusion (residual conv units, bilinear
x2 with align_corners, 1x1 conv); the head is conv, x2, conv, relu, conv,
relu.

Numerics as in the JAX module: the stem's max pool pads with -inf, the
position embedding is resized by half-pixel bilinear matrices (exact fp32
einsums), attention scores and softmax in fp32, exact GELU. Submodules
carry the flax scope names (the GroupNorm that `GroupNorm32` wraps is
flax's automatic `GroupNorm_0`), so `load_jax_variables` loads the JAX
tree strictly.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from prismer_tpu_torch.experts.layers import (Conv2d, max_pool, nchw, nhwc,
                                              normal_init, zeros_init)
from prismer_tpu_torch.experts.segmentation.mask2former import GroupNorm
from prismer_tpu_torch.experts.segmentation.swin import (cached_constant,
                                                        merge_heads,
                                                        split_heads)
from prismer_tpu_torch.models.layers import Dense, LayerNorm
from prismer_tpu_torch.ops.resize import bilinear_resize_align_corners

FP32 = torch.float32
POS_GRID = 24      # the position table's grid: 384 px / 16


class StdConv(nn.Conv2d):
    """Weight-standardised conv (timm StdConv2d): each output channel's
    kernel standardised with eps 1e-6 and the biased variance. NHWC."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, device=None):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wf = self.weight.reshape(self.out_channels, -1)
        var, mean = torch.var_mean(wf, dim=1, keepdim=True, correction=0)
        w = ((wf - mean) * torch.rsqrt(var + 1e-6)).reshape(self.weight.shape)
        return nhwc(F.conv2d(nchw(x), w, None, self.stride, self.padding))


class GroupNorm32(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(32, dim, 1e-5, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(x)


class PreActBottleneck(nn.Module):
    """timm ResNetV2 pre-activation bottleneck."""

    def __init__(self, in_ch: int, mid: int, out: int, stride: int = 1,
                 downsample: bool = False, device=None):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, device)
        if downsample:
            self.downsample_conv = StdConv(in_ch, out, 1, stride,
                                           device=device)
        self.conv1 = StdConv(in_ch, mid, 1, device=device)
        self.norm2 = GroupNorm32(mid, device)
        self.conv2 = StdConv(mid, mid, 3, stride, 1, device=device)
        self.norm3 = GroupNorm32(mid, device)
        self.conv3 = StdConv(mid, out, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = F.relu(self.norm1(x))
        shortcut = (self.downsample_conv(pre)
                    if hasattr(self, "downsample_conv") else x)
        h = self.conv1(pre)
        h = self.conv2(F.relu(self.norm2(h)))
        h = self.conv3(F.relu(self.norm3(h)))
        return h + shortcut


class ResNetV2Stage(nn.Module):
    def __init__(self, num_blocks: int, in_ch: int, mid: int, out: int,
                 stride: int, device=None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            setattr(self, f"block_{i}", PreActBottleneck(
                in_ch if i == 0 else out, mid, out,
                stride if i == 0 else 1, downsample=(i == 0), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x)
        return x


class HybridBackbone(nn.Module):
    """ResNetV2 stem + stages 0-2; returns the three stage outputs."""

    def __init__(self, device=None):
        super().__init__()
        self.stem_conv = StdConv(3, 64, 7, 2, 3, device=device)
        self.stem_norm = GroupNorm32(64, device)
        self.stage_0 = ResNetV2Stage(3, 64, 64, 256, 1, device)
        self.stage_1 = ResNetV2Stage(4, 256, 128, 512, 2, device)
        self.stage_2 = ResNetV2Stage(9, 512, 256, 1024, 2, device)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.stem_norm(self.stem_conv(x)))
        x = max_pool(x, 3, 2, 1)
        s0 = self.stage_0(x)
        s1 = self.stage_1(s0)
        return s0, s1, self.stage_2(s1)


class ViTBlock(nn.Module):
    """timm ViT block: packed qkv, exact-GELU MLP, LayerNorm eps 1e-6."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim, 1e-6, device)
        self.qkv = Dense(dim, 3 * dim, FP32, device)
        self.proj = Dense(dim, dim, FP32, device)
        self.norm2 = LayerNorm(dim, 1e-6, device)
        self.fc1 = Dense(dim, 4 * dim, FP32, device)
        self.fc2 = Dense(4 * dim, dim, FP32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(t, self.heads)
                   for t in self.qkv(self.norm1(x)).chunk(3, dim=-1))
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        o = torch.matmul(torch.softmax(s, dim=-1), v)
        x = x + self.proj(merge_heads(o))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


@functools.lru_cache(maxsize=32)
def bilinear_half_pixel_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix of F.interpolate(mode='bilinear',
    align_corners=False), edge-clamped taps."""
    mat = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        lo = int(np.floor(src))
        frac = src - lo
        mat[i, min(max(lo, 0), in_size - 1)] += 1.0 - frac
        mat[i, min(max(lo + 1, 0), in_size - 1)] += frac
    return mat.astype(np.float32)


def resize_pos_embed_bilinear(pos_grid: torch.Tensor, gh: int, gw: int,
                              cache: Optional[Dict] = None) -> torch.Tensor:
    """(G0*G0, D) grid -> (gh*gw, D), bilinear align_corners=False."""
    g0 = int(round(pos_grid.shape[0] ** 0.5))
    d = pos_grid.shape[-1]
    if g0 * g0 == pos_grid.shape[0] and (g0, g0) == (gh, gw):
        return pos_grid
    cache = {} if cache is None else cache
    wh = cached_constant(cache, ("h", g0, gh), pos_grid.device,
                         lambda: bilinear_half_pixel_matrix(g0, gh))
    ww = cached_constant(cache, ("w", g0, gw), pos_grid.device,
                         lambda: bilinear_half_pixel_matrix(g0, gw))
    grid = pos_grid.reshape(g0, g0, d).float()
    out = torch.einsum("oi,ijd->ojd", wh, grid)
    out = torch.einsum("oj,sjd->sod", ww, out)
    return out.reshape(gh * gw, d).to(pos_grid.dtype)


class ResidualConvUnit(nn.Module):
    """relu, conv, relu, conv, + skip."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.conv1 = Conv2d(dim, dim, 3, padding=1, device=device)
        self.conv2 = Conv2d(dim, dim, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """RefineNet fusion (align_corners=True, no expand); the deepest block
    takes no skip and has no `rcu1`."""

    def __init__(self, dim: int, with_skip: bool, device=None):
        super().__init__()
        if with_skip:
            self.rcu1 = ResidualConvUnit(dim, device)
        self.rcu2 = ResidualConvUnit(dim, device)
        self.out_conv = Conv2d(dim, dim, 1, device=device)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        x = bilinear_resize_align_corners(x, x.shape[1] * 2, x.shape[2] * 2)
        return self.out_conv(x)


class DPTDepthModel(nn.Module):
    """Input (B, H, W, 3) normalised with mean 0.5, std 0.5; output (B, H,
    W) non-negative inverse depth. The ViT width, depth and heads are
    arguments (the expert's: 768, 12, 12); the tests pass small ones."""

    def __init__(self, features: int = 256, vit_dim: int = 768,
                 vit_layers: int = 12, vit_heads: int = 12,
                 hooks: Sequence[int] = (8, 11), device=None):
        super().__init__()
        self.vit_dim, self.vit_layers = vit_dim, vit_layers
        self.hooks = tuple(hooks)
        self.backbone = HybridBackbone(device)
        self.patch_proj = Conv2d(1024, vit_dim, 1, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, vit_dim,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.zeros(
            1 + POS_GRID * POS_GRID, vit_dim, device=device))
        for i in range(vit_layers):
            setattr(self, f"vit_block_{i}", ViTBlock(vit_dim, vit_heads,
                                                     device))
        for name in ("post3", "post4"):
            setattr(self, f"{name}_readout", Dense(2 * vit_dim, vit_dim, FP32,
                                                   device))
            setattr(self, f"{name}_proj", Conv2d(vit_dim, vit_dim, 1,
                                                 device=device))
        self.post4_down = Conv2d(vit_dim, vit_dim, 3, 2, 1, device=device)
        f = features
        for i, ch in enumerate((256, 512, vit_dim, vit_dim)):
            setattr(self, f"layer{i + 1}_rn", Conv2d(ch, f, 3, padding=1,
                                                     bias=False,
                                                     device=device))
        for i in (4, 3, 2, 1):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(f, i != 4,
                                                              device))
        self.head_conv1 = Conv2d(f, f // 2, 3, padding=1, device=device)
        self.head_conv2 = Conv2d(f // 2, 32, 3, padding=1, device=device)
        self.head_conv3 = Conv2d(32, 1, 1, device=device)
        self._consts: Dict = {}

    def reassemble(self, tok: torch.Tensor, name: str, gh: int,
                   gw: int) -> torch.Tensor:
        """Project-readout + 1x1 conv."""
        readout = tok[:, :1].expand(-1, tok.shape[1] - 1, -1)
        feat = torch.cat([tok[:, 1:], readout], dim=-1)
        feat = F.gelu(getattr(self, f"{name}_readout")(feat))
        feat = feat.reshape(tok.shape[0], gh, gw, self.vit_dim)
        return getattr(self, f"{name}_proj")(feat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        gh, gw = h // 16, w // 16
        s0, s1, s2 = self.backbone(x.to(FP32))
        tokens = self.patch_proj(s2).reshape(b, gh * gw, self.vit_dim)
        pos = self.pos_embed
        pos_grid = resize_pos_embed_bilinear(pos[1:], gh, gw, self._consts)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)
        tokens = tokens + torch.cat([pos[:1], pos_grid], dim=0)[None]
        taps = {}
        for i in range(self.vit_layers):
            tokens = getattr(self, f"vit_block_{i}")(tokens)
            if i in self.hooks:
                taps[i] = tokens
        layer_3 = self.reassemble(taps[self.hooks[0]], "post3", gh, gw)
        layer_4 = self.post4_down(self.reassemble(taps[self.hooks[1]],
                                                  "post4", gh, gw))
        rn = [getattr(self, f"layer{i + 1}_rn")(t)
              for i, t in enumerate((s0, s1, layer_3, layer_4))]
        p = self.refinenet4(rn[3])
        p = self.refinenet3(p, rn[2])
        p = self.refinenet2(p, rn[1])
        p = self.refinenet1(p, rn[0])
        out = self.head_conv1(p)
        out = bilinear_resize_align_corners(out, out.shape[1] * 2,
                                            out.shape[2] * 2)
        out = F.relu(self.head_conv2(out))
        return F.relu(self.head_conv3(out))[..., 0]


# flax initialisers of the raw parameters
RAW_INIT = {"cls_token": zeros_init, "pos_embed": normal_init(0.02)}
