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
launches are counted in their `launches` attributes (one a wrapper call,
though bf16 runs two kernels: the rows' statistics, then the products).
`ln_proj_plan` / `adaptor_plan` mirror the C launch plans; the C entries
refuse a call whose plan differs. The backward of each
recomputes the plain version under autograd, as the JAX custom_vjp
recomputes its XLA composition: there is no backward kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import functools

import torch

from prismer_tpu_torch.ops.layer_norm import (_DTYPE_CODES, check_rows,
                                              fp32_layer_norm)

_ACT_CODES = {None: 0, "quick_gelu": 1}
MAX_OUTPUTS = 3
H100_SMS = 132
SMEM_LIMIT = 232448       # a block's shared memory on sm_90
_BOX = 64 * 128           # bytes of a 64-row, 128-byte-wide TMA box
# fp32 FMA kernels: 128-column tiles, six a block (ln_proj), three
# cp.async stages of 128 x 36 floats
_F32 = {"bn": 128, "group": 6, "stage_floats": 3 * 128 * 36,
        "ln_proj_rows": 32, "adaptor_rows": 16}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def ln_proj_plan(r: int, d: int, fs: Tuple[int, ...], dtype=torch.bfloat16,
                 sms: int = H100_SMS) -> dict:
    """The launch plan of `ln_proj`'s kernel, computed as `proj_plan` /
    `run_ln_proj_f32` in csrc/ln_proj.cu compute it (keep them in step).

    bf16 ("wgmma"): tiles of 128 rows x 256 columns of one output, output i
    owning column tiles [first[i], first[i] + ceil(F_i / 256)) of the
    outputs side by side; tile t is row tile t // col_tiles, column tile
    t % col_tiles; `blocks` (about one an SM) walk the tiles, block b taking
    b, b + blocks, ...; 384 threads (two consumer warpgroups of 64 rows, a
    producer warpgroup); shared memory: the 1024-byte alignment slack, a
    ring of 3 stages of x (128 x 64) and W (256 x 64) boxes, the output
    boxes, the affine and the tile's biases; the row statistics' scratch
    (R, 2) fp32. fp32 ("fma"): grid (column groups of 768, row tiles of
    32). Cached per call shape: the caller must not change the dict."""
    if dtype == torch.float32:
        groups = sum(_cdiv(f, _F32["bn"] * _F32["group"]) for f in fs)
        rows = _F32["ln_proj_rows"]
        return {"kind": "fma", "rows": rows, "grid": (groups, _cdiv(r, rows)),
                "blocks": groups * _cdiv(r, rows), "threads": 256,
                "cluster": (1, 1, 1), "scratch_bytes": 0,
                "smem": (rows * (d + 4) + _F32["stage_floats"]) * 4}
    rows, bn, stages = 128, 256, 3
    first, col_tiles = [], 0
    for f in fs:
        first.append(col_tiles)
        col_tiles += _cdiv(f, bn)
    tiles = _cdiv(r, rows) * col_tiles
    return {"kind": "wgmma", "R": r, "rows": rows, "bn": bn,
            "stages": stages, "threads": 3 * 128, "row_tiles": _cdiv(r, rows),
            "col_tiles": col_tiles, "first": first, "tiles": tiles,
            "blocks": min(tiles, sms), "chunks": d // 64,
            "cluster": (1, 1, 1), "scratch_bytes": r * 8,
            "smem": (1024 + stages * (rows + bn) * 128 + 2 * (bn // 64) * _BOX
                     + d * 8 + 2 * bn * 2 + 2 * stages * 8)}


def ln_proj_tiles(plan: dict, fs: Sequence[int]):
    """The tiles of a "wgmma" plan in each block's walk: (block, output,
    row0, col0, rows stored, columns stored) with the stores clipped to R
    and F_i as the TMA stores clip them; R = plan["R"]."""
    r = plan["R"]
    for block in range(plan["blocks"]):
        for t in range(block, plan["tiles"], plan["blocks"]):
            g = t % plan["col_tiles"]
            out = max(i for i, first in enumerate(plan["first"])
                      if g >= first)
            row0 = t // plan["col_tiles"] * plan["rows"]
            col0 = (g - plan["first"][out]) * plan["bn"]
            yield (block, out, row0, col0, min(plan["rows"], r - row0),
                   min(plan["bn"], fs[out] - col0))


@functools.lru_cache(maxsize=256)
def adaptor_plan(r: int, d: int, dtype=torch.bfloat16) -> dict:
    """The launch plan of `adaptor_fused`'s kernel, computed as `ad_plan` /
    `run_adaptor_f32` in csrc/ln_proj.cu compute them (keep them in step).

    bf16 ("wgmma"): a block of 160 threads (one consumer warpgroup, one
    producer warp) a 64-row tile, 128-column tiles of both products;
    shared memory: the alignment slack, h (64 x D bf16), two staging
    boxes, two column tiles' biases, then as many ring stages of x (64 x
    64) + W (128 x 64) boxes as fit, at most 4, and their barriers; the
    row statistics' scratch (R, 2) fp32. fp32 ("fma"): 16 rows a block.
    Cached per call shape, as ln_proj_plan."""
    if dtype == torch.float32:
        rows = _F32["adaptor_rows"]
        return {"kind": "fma", "rows": rows, "grid": (_cdiv(r, rows), 1),
                "blocks": _cdiv(r, rows), "threads": 256,
                "cluster": (1, 1, 1), "scratch_bytes": 0,
                "smem": (2 * rows * (d + 4) + _F32["stage_floats"]) * 4}
    rows, bn = 64, 128
    stage = _BOX + bn * 128
    fixed = 1024 + d * 128 + 2 * _BOX + 2 * bn * 2
    stages = min(4, (SMEM_LIMIT - fixed - 9 * 8) // stage)
    return {"kind": "wgmma", "rows": rows, "bn": bn, "stages": stages,
            "threads": 128 + 32, "blocks": _cdiv(r, rows),
            "col_tiles": _cdiv(d, bn), "chunks": d // 64,
            "cluster": (1, 1, 1), "scratch_bytes": r * 8,
            "smem": fixed + stages * stage + (2 * stages + 1) * 8}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stats_scratch(x2d: torch.Tensor, plan: dict):
    """The row statistics' (R, 2) fp32 scratch of a bf16 plan, else None."""
    if not plan["scratch_bytes"]:
        return None
    return torch.empty((x2d.shape[0], 2), dtype=torch.float32,
                       device=x2d.device)


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
        if (t.dtype != x2d.dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: a {t.dtype} {tuple(t.shape)} weight or "
                             f"bias; kernel takes contiguous 16-byte aligned "
                             f"{x2d.dtype}")


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
    plan = ln_proj_plan(r, d, tuple(fs), x2d.dtype, _sm_count(x2d.device))
    stats = _stats_scratch(x2d, plan)
    pad = [None] * (MAX_OUTPUTS - n)
    with _build.launch_device("ln_proj", x2d, scale, bias, *weights,
                              *biases):
        err = _build.kernels().prismer_ln_proj(
            x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            *(t.data_ptr() for t in weights), *pad,
            *(t.data_ptr() for t in biases), *pad,
            *(t.data_ptr() for t in outs), *pad, *fs, *[0] * len(pad), n, r,
            d, float(eps), _ACT_CODES[activation], _DTYPE_CODES[x2d.dtype],
            None if stats is None else stats.data_ptr(), plan["blocks"],
            plan["smem"], torch.cuda.current_stream(x2d.device).cuda_stream)
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
    plan = adaptor_plan(r, d, x2d.dtype)
    stats = _stats_scratch(x2d, plan)
    with _build.launch_device("adaptor_fused", x2d, scale, bias, wd, bd, wu,
                              bu):
        err = _build.kernels().prismer_adaptor_fused(
            x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), wu.data_ptr(), bu.data_ptr(), out.data_ptr(), r, d,
            float(eps), _DTYPE_CODES[x2d.dtype],
            None if stats is None else stats.data_ptr(), plan["blocks"],
            plan["smem"], torch.cuda.current_stream(x2d.device).cuda_stream)
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
