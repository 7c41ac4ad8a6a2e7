"""LayerNorm fused into its consumers: the CUDA kernels' wrappers, the
autograd Functions and the plain versions.

Port of prismer_tpu/ops/ln_proj.py `ln_proj` and `adaptor_fused`. The
kernels are `csrc/ln_proj.cu`; its header note says what they replace, what
bounds them on the H100 and how the normalised rows stay in shared memory.
The encoder block runs them when `models.layers.set_ln_proj(True)` (off by
default, as in JAX):

    ln_proj:       q, k, v = LN(x) @ W_i^T + b_i           (one read of x)
                   h = quick_gelu(LN(x) @ W_fc^T + b_fc)   (the MLP's half)
    adaptor_fused: x + up(sq_relu(down(LN(x))))            (whole Adaptor)

Weights are in the port's nn.Linear layout (F, D) and in x's dtype; the
LayerNorm affine is fp32. The plain versions follow the kernels' rounding
points (the Pallas bodies', not `_ln_proj_ref`'s): LN(x) rounded to x's
dtype, each product summed in fp32 and rounded, the bias added in x's dtype,
`ln_proj`'s activation computed in fp32 on that rounded value, the
adaptor's relu, square and residual add in x's dtype.

`ln_proj` / `adaptor_fused` launch their kernels for CUDA tensors and
compute `ln_proj_reference` / `adaptor_reference` for tensors on the CPU;
launches are counted in their `launches` attributes. The backward of each
recomputes the plain version under autograd, as the JAX custom_vjp
recomputes its XLA composition: there is no backward kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from prismer_tpu_torch.ops.layer_norm import (_DTYPE_CODES, check_rows,
                                              fp32_layer_norm)

_ACT_CODES = {None: 0, "quick_gelu": 1}
MAX_OUTPUTS = 3


def _product(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """y @ w^T summed in fp32 from the compute-dtype operands, rounded to
    y's dtype, plus the bias in y's dtype."""
    return torch.matmul(y.float(), w.float().t()).to(y.dtype) + b.to(y.dtype)


def ln_proj_reference(x2d: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor],
                      activation: Optional[str] = None, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, ...]:
    """The plain version: act(round(LN(x)) @ W_i^T + b_i) for each weight,
    differentiable."""
    from prismer_tpu_torch.models.layers import ACTIVATIONS

    y = fp32_layer_norm(x2d, scale, bias, eps)
    outs = []
    for w, b in zip(weights, biases):
        o = _product(y, w, b)
        if activation is not None:
            o = ACTIVATIONS[activation](o.float()).to(x2d.dtype)
        outs.append(o)
    return tuple(outs)


def adaptor_reference(x2d: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, w_down: torch.Tensor,
                      b_down: torch.Tensor, w_up: torch.Tensor,
                      b_up: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The plain version: x + up(sq_relu(down(round(LN(x))))) with every
    step rounded to x's dtype, differentiable."""
    y = fp32_layer_norm(x2d, scale, bias, eps)
    r = torch.relu(_product(y, w_down, b_down))
    return x2d + _product(r * r, w_up, b_up)


def _check_params(name, x2d, params):
    for t in params:
        if (not t.is_cuda or t.device != x2d.device or t.dtype != x2d.dtype
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: a {t.dtype} {tuple(t.shape)} weight or "
                             f"bias on {t.device}; kernel takes contiguous "
                             f"16-byte aligned {x2d.dtype} on {x2d.device}")


def _ln_proj_forward(x2d, scale, bias, weights, biases, activation, eps):
    if not x2d.is_cuda:
        return ln_proj_reference(x2d, scale, bias, weights, biases,
                                 activation, eps)
    from prismer_tpu_torch.ops import _build

    r, d = x2d.shape
    n = len(weights)
    if activation not in _ACT_CODES or not 1 <= n <= MAX_OUTPUTS:
        raise ValueError(f"ln_proj: kernel takes 1-{MAX_OUTPUTS} weights and "
                         f"activation in {list(_ACT_CODES)}; got {n}, "
                         f"{activation!r}")
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    check_rows("ln_proj", x2d, scale, bias, 64)
    _check_params("ln_proj", x2d, (*weights, *biases))
    fs = [w.shape[0] for w in weights]
    if (any(tuple(w.shape) != (f, d) for w, f in zip(weights, fs))
            or any(tuple(b.shape) != (f,) for b, f in zip(biases, fs))):
        raise ValueError(f"ln_proj: weights {[tuple(w.shape) for w in weights]}"
                         f" and biases {[tuple(b.shape) for b in biases]} for "
                         f"D = {d}")
    outs = [torch.empty((r, f), dtype=x2d.dtype, device=x2d.device)
            for f in fs]
    pad = [None] * (MAX_OUTPUTS - n)
    err = _build.kernels().prismer_ln_proj(
        x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        *(t.data_ptr() for t in weights), *pad,
        *(t.data_ptr() for t in biases), *pad,
        *(t.data_ptr() for t in outs), *pad, *fs, *[0] * len(pad), n, r, d,
        float(eps), _ACT_CODES[activation], _DTYPE_CODES[x2d.dtype],
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(err, "ln_proj")
    ln_proj.launches += 1
    return tuple(outs)


def _adaptor_forward(x2d, scale, bias, wd, bd, wu, bu, eps):
    if not x2d.is_cuda:
        return adaptor_reference(x2d, scale, bias, wd, bd, wu, bu, eps)
    from prismer_tpu_torch.ops import _build

    r, d = x2d.shape
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    check_rows("adaptor_fused", x2d, scale, bias, 64)
    _check_params("adaptor_fused", x2d, (wd, bd, wu, bu))
    if (tuple(wd.shape) != (d, d) or tuple(wu.shape) != (d, d)
            or tuple(bd.shape) != (d,) or tuple(bu.shape) != (d,)):
        raise ValueError(f"adaptor_fused: weights {tuple(wd.shape)}, "
                         f"{tuple(wu.shape)} for D = {d}")
    out = torch.empty_like(x2d)
    err = _build.kernels().prismer_adaptor_fused(
        x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(), wd.data_ptr(),
        bd.data_ptr(), wu.data_ptr(), bu.data_ptr(), out.data_ptr(), r, d,
        float(eps), _DTYPE_CODES[x2d.dtype],
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(err, "adaptor_fused")
    adaptor_fused.launches += 1
    return out


def _recompute_grads(ctx, plain, grads):
    """Gradients of the saved inputs through `plain(*inputs)` rebuilt under
    autograd (JAX's recompute-in-backward); None where none is needed."""
    inputs = ctx.saved_tensors
    needs = ctx.needs_tensor_grad
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(inputs, needs)]
        outs = plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wanted = [t for t, need in zip(leaves, needs) if need]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wanted, [g for _, g in pairs],
                                       allow_unused=True))
    return [next(got) if need else None for need in needs]


class _LnProj(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2d, scale, bias, activation, eps, *params):
        n = len(params) // 2
        outs = _ln_proj_forward(x2d, scale, bias, params[:n], params[n:],
                                activation, eps)
        ctx.save_for_backward(x2d, scale, bias, *params)
        ctx.needs_tensor_grad = (ctx.needs_input_grad[:3]
                                 + ctx.needs_input_grad[5:])
        ctx.activation, ctx.eps, ctx.n = activation, eps, n
        return outs

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.n
        dx, dscale, dbias, *dparams = _recompute_grads(
            ctx, lambda x, s, b, *p: ln_proj_reference(
                x, s, b, p[:n], p[n:], ctx.activation, ctx.eps), grads)
        return (dx, dscale, dbias, None, None, *dparams)


class _Adaptor(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2d, scale, bias, wd, bd, wu, bu, eps):
        out = _adaptor_forward(x2d, scale, bias, wd, bd, wu, bu, eps)
        ctx.save_for_backward(x2d, scale, bias, wd, bd, wu, bu)
        ctx.needs_tensor_grad = ctx.needs_input_grad[:7]
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        grads = _recompute_grads(
            ctx, lambda *t: adaptor_reference(*t, ctx.eps), (g,))
        return (*grads, None)


def ln_proj(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
            activation: Optional[str] = None, eps: float = 1e-5
            ) -> Tuple[torch.Tensor, ...]:
    """act(LN(x) @ W_i^T + b_i) for every (W_i, b_i), reading x once.

    x (..., D) in the compute dtype; scale, bias (D,) the LayerNorm affine;
    weights (F_i, D) and biases (F_i,) in x's dtype; activation None or an
    `models.layers.ACTIVATIONS` name (the kernel takes None and
    'quick_gelu'). Returns one (..., F_i) tensor per weight."""
    lead, d = x.shape[:-1], x.shape[-1]
    outs = _LnProj.apply(x.reshape(-1, d).contiguous(), scale, bias,
                         activation, float(eps), *weights, *biases)
    return tuple(o.reshape(*lead, o.shape[-1]) for o in outs)


ln_proj.launches = 0


def adaptor_fused(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  w_down: torch.Tensor, b_down: torch.Tensor,
                  w_up: torch.Tensor, b_up: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The norm-early Adaptor x + up(sq_relu(down(LN(x)))) as one kernel;
    x (..., D), the (D, D) weights and (D,) biases in x's dtype."""
    d = x.shape[-1]
    out = _Adaptor.apply(x.reshape(-1, d).contiguous(), scale, bias, w_down,
                         b_down, w_up, b_up, float(eps))
    return out.reshape(x.shape)


adaptor_fused.launches = 0
