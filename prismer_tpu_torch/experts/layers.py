"""NHWC building blocks shared by the label experts (depth, normal, edge,
object and OCR detection), with flax's numerics and names.

  * `Conv2d` is nn.Conv2d on NHWC tensors with flax's padding forms: an
    int (symmetric), ((top, bottom), (left, right)), "SAME" (TF's rule:
    the smaller half of the total before, whatever the stride) or "VALID".
    The permute to NCHW is a channels-last view, so cuDNN reads the NHWC
    data as it lies.
  * `ConvTranspose2d` holds its weight in F.conv_transpose2d's (in, out,
    kh, kw) layout. The JAX package keeps the kernel as (kh, kw, out, in)
    and flips it itself; `load_jax_variables`' ordinary 4-D kernel
    permutation (3, 2, 0, 1) already yields (in, out, kh, kw), so the leaf
    loads like any other kernel.
  * `BatchNorm` is flax's inference BatchNorm in fp32:
    (x - mean) * (scale * rsqrt(var + eps)) + bias.
  * `max_pool` pads with -inf (flax's and the JAX package's explicit
    -inf pads), `avg_pool` divides by the in-bounds count (torch's
    count_include_pad=False).

`init_random_` fills a module built on the meta device with flax's
initialisers' distributions, drawn from one seed in module order:
lecun-normal (truncated at two standard deviations) kernels, zero biases,
unit norm scales, BatchNorm statistics (0, 1), and the named raw
parameters from the caller's table.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from prismer_tpu_torch.experts.segmentation.swin import same_pad

Padding = Union[int, str, Tuple[Tuple[int, int], Tuple[int, int]]]


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """fp32 nn.Conv2d on NHWC tensors; see the module docstring for
    `padding`."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Padding = 0, dilation: int = 1, groups: int = 1,
                 bias: bool = True, device=None):
        sym = padding if isinstance(padding, int) else 0
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=sym,
                         dilation=dilation, groups=groups, bias=bias,
                         device=device)
        self.pad_spec = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.pad_spec
        if spec == "SAME":
            k = self.dilation[0] * (self.kernel_size[0] - 1) + 1
            x = same_pad(x, k, self.stride[0])
        elif isinstance(spec, tuple):
            (top, bottom), (left, right) = spec
            x = F.pad(x, (0, 0, left, right, top, bottom))
        return nhwc(super().forward(nchw(x)))


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch.nn.ConvTranspose2d on NHWC tensors (weight (in, out, k, k))."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 padding: int, device=None):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nhwc(super().forward(nchw(x)))


class BatchNorm(nn.Module):
    """flax BatchNorm(use_running_average=True) over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return (x.float() - self.running_mean) * mul + self.bias


def max_pool(x: torch.Tensor, kernel: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    """NHWC max pool; padded cells hold -inf."""
    return nhwc(F.max_pool2d(nchw(x), kernel, stride, padding))


def avg_pool(x: torch.Tensor, kernel: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    """NHWC average pool over the in-bounds cells (floor mode)."""
    return nhwc(F.avg_pool2d(nchw(x), kernel, stride, padding,
                             count_include_pad=False))


RawInit = Callable[[torch.Generator, Tuple[int, ...]], torch.Tensor]


def normal_init(std: float) -> RawInit:
    return lambda gen, shape: torch.randn(shape, generator=gen) * std


def zeros_init(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.zeros(shape)


def lecun_normal(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """flax variance_scaling(1, fan_in, truncated_normal)."""
    std = 1.0 / math.sqrt(fan_in) / .87962566103423978
    x = torch.empty(shape)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x * std


_KERNELS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


@torch.no_grad()
def init_random_(model: nn.Module, seed: int,
                 raw: Optional[Dict[str, RawInit]] = None) -> nn.Module:
    """Fill every parameter and buffer of `model` from `seed` (see the
    module docstring); `raw` maps a parameter's leaf name to its
    initialiser. Returns the model in eval mode, frozen."""
    raw = raw or {}
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        for leaf, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            shape = tuple(t.shape)
            if leaf in raw:
                value = raw[leaf](gen, shape)
            elif leaf == "weight" and isinstance(mod, _KERNELS):
                value = lecun_normal(gen, shape, math.prod(shape[1:]))
            elif leaf in ("bias", "running_mean"):
                value = torch.zeros(shape)
            elif leaf in ("weight", "running_var"):
                value = torch.ones(shape)
            else:
                raise KeyError(f"no initialiser for {type(mod).__name__}."
                               f"{leaf}")
            t.copy_(value.to(device=t.device, dtype=t.dtype))
    return model.eval().requires_grad_(False)


def build_random(cls, seed: int, device: torch.device | str,
                 raw: Optional[Dict[str, RawInit]] = None, **kwargs):
    """`cls(**kwargs)` built on the meta device, moved to `device` and
    filled by `init_random_` (so no default initialisation runs)."""
    model = cls(device="meta", **kwargs).to_empty(device=device)
    return init_random_(model, seed, raw)
