"""CharNet OCR expert (inference), NHWC: port of
prismer_tpu/experts/ocr_detection/model.py (the device part).

An Hourglass-88 backbone (two stacked depth-3 hourglass blocks over a
stride-4 stem; 2x2 / 2 max pools, bilinear x2 with align_corners back up,
BatchNorm eps 1e-5) with three heads at stride 4: the word detector
(foreground 2, tblr 4 scaled by 10 after a relu, orientation 1), the char
detector (foreground, tblr) and the 68-way char recogniser. The host-side
decoding is `postprocess.py`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from prismer_tpu_torch.experts.layers import BatchNorm, Conv2d, max_pool
from prismer_tpu_torch.ops.resize import bilinear_resize_align_corners

FP32 = torch.float32
NUM_CHAR_CLASSES = 68


class ConvBnRelu(nn.Module):
    def __init__(self, in_ch: int, out: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, device=None):
        super().__init__()
        self.conv = Conv2d(in_ch, out, kernel, stride,
                           dilation * (kernel // 2), dilation, bias=False,
                           device=device)
        self.bn = BatchNorm(out, 1e-5, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class Residual(nn.Module):
    """Two 3x3 conv-bn (relu between), a 3x3 conv-bn skip when the shape
    changes."""

    def __init__(self, in_ch: int, out: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out, 3, stride, 1, bias=False,
                            device=device)
        self.bn1 = BatchNorm(out, 1e-5, device)
        self.conv2 = Conv2d(out, out, 3, 1, 1, bias=False, device=device)
        self.bn2 = BatchNorm(out, 1e-5, device)
        if stride != 1 or in_ch != out:
            self.skip_conv = Conv2d(in_ch, out, 3, stride, 1, bias=False,
                                    device=device)
            self.skip_bn = BatchNorm(out, 1e-5, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        s = (self.skip_bn(self.skip_conv(x)) if hasattr(self, "skip_conv")
             else x)
        return F.relu(h + s)


class ResLayer(nn.Module):
    """`revr`: keep-dims blocks, then the transition; otherwise the
    transition first."""

    def __init__(self, in_ch: int, out: int, num_blocks: int,
                 revr: bool = False, device=None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            if revr:
                cin = in_ch
                cout = out if i == num_blocks - 1 else in_ch
            else:
                cin, cout = (in_ch if i == 0 else out), out
            setattr(self, f"res_{i}", Residual(cin, cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"res_{i}")(x)
        return x


class HourGlassBlock(nn.Module):
    def __init__(self, n: int, in_ch: int, channels: Sequence[int],
                 blocks: Sequence[int], device=None):
        super().__init__()
        c0, c1 = channels[0], channels[1]
        self.up_1 = ResLayer(in_ch, c0, blocks[0], device=device)
        self.low_1 = ResLayer(in_ch, c1, blocks[0], device=device)
        if n <= 1:
            self.low_2 = ResLayer(c1, c1, blocks[1], device=device)
        else:
            self.low_2 = HourGlassBlock(n - 1, c1, channels[1:], blocks[1:],
                                        device)
        self.low_3 = ResLayer(c1, c0, blocks[0], revr=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = self.up_1(x)
        low = self.low_3(self.low_2(self.low_1(max_pool(x, 2, 2))))
        low = bilinear_resize_align_corners(low, low.shape[1] * 2,
                                            low.shape[2] * 2)
        return low + up1


class Hourglass88(nn.Module):
    """HourGlassNet(3, [256, 256, 256, 512], [2, 2, 2, 2])."""

    def __init__(self, device=None):
        super().__init__()
        self.pre_conv = Conv2d(3, 128, 7, 2, 3, bias=False, device=device)
        self.pre_bn = BatchNorm(128, 1e-5, device)
        self.pre_res = Residual(128, 256, stride=2, device=device)
        for i in range(2):
            setattr(self, f"hg_{i}", HourGlassBlock(
                3, 256, (256, 256, 256, 512), (2, 2, 2, 2), device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.pre_bn(self.pre_conv(x.to(FP32))))
        h = self.pre_res(h)
        return self.hg_1(self.hg_0(h))


class DetHead(nn.Module):
    """Word / char detector head."""

    def __init__(self, in_ch: int, with_orient: bool, dilation: int = 1,
                 device=None):
        super().__init__()
        self.det_conv_final = ConvBnRelu(in_ch, 128, dilation=dilation,
                                         device=device)
        self.fg_feat = ConvBnRelu(128, 128, dilation=dilation, device=device)
        self.fg_pred = Conv2d(128, 2, 1, device=device)
        self.reg_feat = ConvBnRelu(128, 128, dilation=dilation, device=device)
        self.tblr_pred = Conv2d(128, 4, 1, device=device)
        if with_orient:
            self.orient_pred = Conv2d(128, 1, 1, device=device)

    def forward(self, x: torch.Tensor):
        feat = self.det_conv_final(x)
        fg = self.fg_pred(self.fg_feat(feat))
        reg = self.reg_feat(feat)
        tblr = F.relu(self.tblr_pred(reg)) * 10.0
        orient = (self.orient_pred(reg) if hasattr(self, "orient_pred")
                  else None)
        return fg, tblr, orient


class CharNet(nn.Module):
    """Returns the maps (NHWC, stride 4): {'word_fg': (B, h, w, 2),
    'word_tblr': 4, 'word_orient': 1, 'char_fg', 'char_tblr', 'char_cls':
    68}; the foregrounds and classes softmaxed."""

    def __init__(self, device=None):
        super().__init__()
        self.backbone = Hourglass88(device)
        self.word_detector = DetHead(256, True, device=device)
        self.char_detector = DetHead(256, False, device=device)
        for i in range(3):
            setattr(self, f"recog_{i}", ConvBnRelu(256 if i == 0 else 128,
                                                   128, device=device))
        self.recog_cls = Conv2d(128, NUM_CHAR_CLASSES, 1, device=device)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feat = self.backbone(x)
        w_fg, w_tblr, w_or = self.word_detector(feat)
        c_fg, c_tblr, _ = self.char_detector(feat)
        h = feat
        for i in range(3):
            h = getattr(self, f"recog_{i}")(h)
        return {"word_fg": torch.softmax(w_fg, dim=-1), "word_tblr": w_tblr,
                "word_orient": w_or, "char_fg": torch.softmax(c_fg, dim=-1),
                "char_tblr": c_tblr,
                "char_cls": torch.softmax(self.recog_cls(h), dim=-1)}
