"""LayerNorm with fp32 statistics: the CUDA kernel's wrapper, the autograd
Function and the plain version.

Port of prismer_tpu/ops/layer_norm.py `fused_layer_norm`. The kernel is
`csrc/layer_norm.cu`; its header note says what it replaces, what bounds it
on the H100 and how it is built. Its LayerNorm row routine
(`csrc/layer_norm.cuh`) is also the prologue of `ops/ln_proj`'s kernels, so
the three compute the same statistics. No path of the JAX package runs this
kernel (its own tests only), and none of the port's does.

`fused_layer_norm` launches the kernel for CUDA tensors and computes
`fp32_layer_norm` for tensors on the CPU; launches are counted in
`fused_layer_norm.launches`. The backward is the JAX package's `_ln_bwd`
formula in plain PyTorch, with the statistics recomputed in fp32.
"""

from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 1280    # the widest row a kernel warp keeps in registers


def fp32_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis computed in fp32 (mean, the mean of the
    squared deviations, the affine), rounded to x's dtype: the model's
    LayerNorm and the kernels' plain version."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def width_ok(d: int, multiple: int) -> bool:
    """Whether the LayerNorm kernels take rows of width d: a multiple of
    `multiple` (8 for `fused_layer_norm`, 64 for `ln_proj` and
    `adaptor_fused`) and at most MAX_DIM. Every registry width is taken:
    768, 1024 and 1280."""
    return d >= multiple and d % multiple == 0 and d <= MAX_DIM


def check_rows(name: str, x2d: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, multiple: int) -> None:
    """Raise unless the kernels take x2d (R, D) and its LayerNorm affine:
    fp32 or bf16, `width_ok(D, multiple)`, contiguous, 16-byte aligned
    (scale and bias of any float dtype, (D,)). The launch's device guard
    (`_build.launch_device`) holds them to one device."""
    r, d = x2d.shape
    if x2d.dtype not in _DTYPE_CODES or not width_ok(d, multiple) or r < 1:
        raise ValueError(f"{name}: kernel takes {list(_DTYPE_CODES)} rows of "
                         f"D <= {MAX_DIM}, a multiple of {multiple}; got "
                         f"{x2d.dtype} ({r}, {d})")
    for what, t in (("x", x2d), ("scale", scale), ("bias", bias)):
        if (not t.is_contiguous() or t.data_ptr() % 16
                or not t.is_floating_point()
                or (t is not x2d and tuple(t.shape) != (d,))):
            raise ValueError(f"{name}: {what} is {t.dtype} {tuple(t.shape)}; "
                             f"kernel takes contiguous 16-byte aligned "
                             f"tensors")


def layer_norm_forward(x2d: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm of x2d (R, D): the kernel on CUDA, the plain version on
    the CPU."""
    if not x2d.is_cuda:
        return fp32_layer_norm(x2d, scale, bias, eps)
    from prismer_tpu_torch.ops import _build

    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    check_rows("fused_layer_norm", x2d, scale, bias, 8)
    r, d = x2d.shape
    out = torch.empty_like(x2d)
    with _build.launch_device("fused_layer_norm", x2d, scale, bias):
        err = _build.kernels().prismer_layer_norm(
            x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), r, d, float(eps), _DTYPE_CODES[x2d.dtype],
            torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(err, "fused_layer_norm")
    fused_layer_norm.launches += 1
    return out


def layer_norm_backward(x: torch.Tensor, scale: torch.Tensor,
                        g: torch.Tensor, eps: float):
    """(dx in x's dtype, dscale, dbias in scale's dtype): the standard
    LayerNorm gradient with recomputed fp32 statistics (JAX `_ln_bwd`)."""
    x32, g32 = x.float(), g.float()
    mean = x32.mean(-1, keepdim=True)
    xc = x32 - mean
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * inv
    gs = g32 * scale.float()
    dx = (gs - gs.mean(-1, keepdim=True)
          - xhat * (gs * xhat).mean(-1, keepdim=True)) * inv
    dims = tuple(range(x.ndim - 1))
    return (dx.to(x.dtype), (g32 * xhat).sum(dims).to(scale.dtype),
            g32.sum(dims).to(scale.dtype))


class _FusedLayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        d = x.shape[-1]
        out = layer_norm_forward(x.reshape(-1, d).contiguous(), scale, bias,
                                 eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward(x, scale, g, ctx.eps)
        return dx, dscale, dbias, None


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics; x of any rank,
    the result in x's dtype. Differentiable in x, scale and bias."""
    return _FusedLayerNorm.apply(x, scale, bias, float(eps))


fused_layer_norm.launches = 0
