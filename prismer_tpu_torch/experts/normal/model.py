"""NNET surface-normal expert (inference), NHWC: port of
prismer_tpu/experts/normal/model.py.

A tf_efficientnet_b5_ap encoder (TF 'SAME' padding, BatchNorm eps 1e-3,
swish, squeeze-excite) feeds the uncertainty-aware decoder, which refines
normals at 1/8 -> 1/4 -> 1/2 -> 1/1 ('test' mode: every pixel refined, no
point sampling). The decoder's skips are EfficientNet stage outputs 0 (24
channels, /2), 1 (40, /4), 2 (64, /8), 4 (176, /16) and the raw
`conv_head` output (2048, /32) before any BatchNorm, as the reference's
feature hook takes it.

'SAME' at stride 2 pads asymmetrically (the smaller half first), which
torch's padding='same' refuses, so `experts.layers.Conv2d` pads explicitly.
Output: a list of (B, h, w, 4) predictions [res8, res4, res2, res1], each
the L2-normalised xyz and kappa = elu + 1.01.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from prismer_tpu_torch.experts.layers import BatchNorm, Conv2d
from prismer_tpu_torch.models.layers import Dense
from prismer_tpu_torch.ops.resize import bilinear_resize_align_corners as up

FP32 = torch.float32

# EfficientNet-B5 stage configs: (repeats, kernel, stride, expand, out_ch)
B5_STAGES = (
    (3, 3, 1, 1, 24),
    (5, 3, 2, 6, 40),
    (5, 5, 2, 6, 64),
    (7, 3, 2, 6, 128),
    (7, 5, 1, 6, 176),
    (9, 5, 2, 6, 304),
    (3, 3, 1, 6, 512),
)
STEM_CH = 48
HEAD_CH = 2048
BN_EPS = 1e-3       # the tf_ variants' BatchNorm epsilon


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduced: int, device=None):
        super().__init__()
        self.conv_reduce = Conv2d(ch, reduced, 1, device=device)
        self.conv_expand = Conv2d(reduced, ch, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        s = self.conv_expand(swish(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class DepthwiseConv(nn.Module):
    def __init__(self, ch: int, kernel: int, stride: int, device=None):
        super().__init__()
        self.conv = Conv2d(ch, ch, kernel, stride, "SAME", groups=ch,
                           bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class DSConvBlock(nn.Module):
    """Stage-0 depthwise-separable block (no expansion)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 se_reduced: int, device=None):
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        self.conv_dw = DepthwiseConv(in_ch, kernel, stride, device)
        self.bn1 = BatchNorm(in_ch, BN_EPS, device)
        self.se = SqueezeExcite(in_ch, se_reduced, device)
        self.conv_pw = Conv2d(in_ch, out_ch, 1, bias=False, device=device)
        self.bn2 = BatchNorm(out_ch, BN_EPS, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = swish(self.bn1(self.conv_dw(x)))
        h = self.bn2(self.conv_pw(self.se(h)))
        return h + x if self.residual else h


class MBConvBlock(nn.Module):
    """Inverted residual: expand, depthwise, SE, project."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expand: int, se_reduced: int, device=None):
        super().__init__()
        mid = in_ch * expand
        self.residual = stride == 1 and in_ch == out_ch
        self.conv_pw = Conv2d(in_ch, mid, 1, bias=False, device=device)
        self.bn1 = BatchNorm(mid, BN_EPS, device)
        self.conv_dw = DepthwiseConv(mid, kernel, stride, device)
        self.bn2 = BatchNorm(mid, BN_EPS, device)
        self.se = SqueezeExcite(mid, se_reduced, device)
        self.conv_pwl = Conv2d(mid, out_ch, 1, bias=False, device=device)
        self.bn3 = BatchNorm(out_ch, BN_EPS, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = swish(self.bn1(self.conv_pw(x)))
        h = swish(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(self.se(h)))
        return h + x if self.residual else h


class EfficientNetB5(nn.Module):
    """Returns the decoder's five feature taps (module docstring)."""

    def __init__(self, device=None):
        super().__init__()
        self.conv_stem = Conv2d(3, STEM_CH, 3, 2, "SAME", bias=False,
                                device=device)
        self.bn1 = BatchNorm(STEM_CH, BN_EPS, device)
        self.names: List[List[str]] = []
        in_ch = STEM_CH
        for s, (reps, k, stride, e, out_ch) in enumerate(B5_STAGES):
            stage = []
            for r in range(reps):
                se_red = max(1, int(in_ch * 0.25))
                st = stride if r == 0 else 1
                block = (DSConvBlock(in_ch, out_ch, k, st, se_red, device)
                         if e == 1 else
                         MBConvBlock(in_ch, out_ch, k, st, e, se_red, device))
                setattr(self, f"blocks_{s}_{r}", block)
                stage.append(f"blocks_{s}_{r}")
                in_ch = out_ch
            self.names.append(stage)
        self.conv_head = Conv2d(in_ch, HEAD_CH, 1, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = swish(self.bn1(self.conv_stem(x)))
        outs = []
        for stage in self.names:
            for name in stage:
                h = getattr(self, name)(h)
            outs.append(h)
        return [outs[0], outs[1], outs[2], outs[4], self.conv_head(h)]


class UpSampleBN(nn.Module):
    """bilinear (align_corners) up to the skip's size, concat, then twice
    conv3x3 - BatchNorm - leaky relu 0.01."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, device=device)
        self.bn1 = BatchNorm(out_ch, BN_EPS, device)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, device=device)
        self.bn2 = BatchNorm(out_ch, BN_EPS, device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = up(x, skip.shape[1], skip.shape[2])
        h = torch.cat([x, skip], dim=-1)
        h = F.leaky_relu(self.bn1(self.conv1(h)), 0.01)
        return F.leaky_relu(self.bn2(self.conv2(h)), 0.01)


def norm_normalize(x: torch.Tensor) -> torch.Tensor:
    """L2-normalised xyz, kappa = elu + 1.01."""
    xyz, kappa = x[..., :3], x[..., 3:]
    norm = torch.sqrt(torch.sum(xyz * xyz, dim=-1, keepdim=True)) + 1e-10
    return torch.cat([xyz / norm, F.elu(kappa) + 1.0 + 0.01], dim=-1)


class PointMLP(nn.Module):
    """The 1x1-conv refinement stack, as Dense layers."""

    def __init__(self, in_ch: int, device=None):
        super().__init__()
        for i in range(3):
            setattr(self, f"fc{i}", Dense(in_ch if i == 0 else 128, 128, FP32,
                                          device))
        self.fc3 = Dense(128, 4, FP32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return self.fc3(x)


class NNET(nn.Module):
    """The normal expert; input ImageNet-normalised NHWC; output the list
    [res8, res4, res2, res1] of (B, h, w, 4) predictions."""

    def __init__(self, device=None):
        super().__init__()
        self.encoder = EfficientNetB5(device)
        self.conv2 = Conv2d(HEAD_CH, 2048, 1, device=device)
        self.up1 = UpSampleBN(2048 + 176, 1024, device)
        self.up2 = UpSampleBN(1024 + 64, 512, device)
        self.up3 = UpSampleBN(512 + 40, 256, device)
        self.up4 = UpSampleBN(256 + 24, 128, device)
        self.out_conv_res8 = Conv2d(512, 4, 3, padding=1, device=device)
        self.out_conv_res4 = PointMLP(512 + 4, device)
        self.out_conv_res2 = PointMLP(256 + 4, device)
        self.out_conv_res1 = PointMLP(128 + 4, device)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        f0, f1, f2, f4, head = self.encoder(x.to(FP32))
        x_d0 = self.conv2(head)
        x_d1 = self.up1(x_d0, f4)
        x_d2 = self.up2(x_d1, f2)
        x_d3 = self.up3(x_d2, f1)
        x_d4 = self.up4(x_d3, f0)
        out_res8 = norm_normalize(self.out_conv_res8(x_d2))

        def refine(feat, prev, mlp):
            fm = up(feat, feat.shape[1] * 2, feat.shape[2] * 2)
            init = up(prev, prev.shape[1] * 2, prev.shape[2] * 2)
            return norm_normalize(mlp(torch.cat([fm, init], dim=-1)))

        out_res4 = refine(x_d2, out_res8, self.out_conv_res4)
        out_res2 = refine(x_d3, out_res4, self.out_conv_res2)
        out_res1 = refine(x_d4, out_res2, self.out_conv_res1)
        return [out_res8, out_res4, out_res2, out_res1]
