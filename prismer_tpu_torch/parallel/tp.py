"""Tensor parallelism on the 'model' axis, the port of JAX's `_tp_spec`.

Each rank keeps the slice of exactly the Dense kernels `_tp_spec` names:
a column slice (out features, port dim 0) of the q/k/v, c_fc,
intermediate and down_proj kernels, a row slice (in features, port dim
1) of the out_proj, c_proj and up_proj kernels. Biases stay whole, as
JAX replicates them. Each sliced projection puts its own full output back
together, so attention, the kernels and everything else see full tensors:

  column  y = all_gather(x @ W_r^T) + b
  row     y = all_reduce(x_r @ W_r^T) + b      (x_r: this rank's columns)

Everything outside the projections is computed the same on every rank of
the 'model' axis, so the collectives' backwards are the ones that keep
the gradients replicated there (Megatron's f / g operators): the column
form all-reduces its input gradient and slices its output gradient, the
row form all-gathers its input gradient and passes its output gradient
through. This is the simplest exact form; Megatron's column -> row
pairing, which keeps heads local and saves the collectives between the
two projections, is later work (ROADMAP).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from prismer_tpu_torch.models.layers import Dense
from prismer_tpu_torch.parallel.mesh import Spec, axis_dim


def _gather_last(x: torch.Tensor, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _own_last(x: torch.Tensor, group, n: int) -> torch.Tensor:
    return x.chunk(n, dim=-1)[dist.get_rank(group)].contiguous()


class _Replicate(torch.autograd.Function):
    """Identity; the backward sums the input gradients of the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    """Concatenate the ranks' last-dim slices; the backward keeps this
    rank's slice of the (replicated) output gradient."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _gather_last(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _own_last(g, ctx.group, ctx.n), None, None


class _OwnColumns(torch.autograd.Function):
    """This rank's last-dim slice; the backward gathers the slices'
    gradients."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _own_last(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group, ctx.n), None, None


class _SumPartials(torch.autograd.Function):
    """All-reduce of the ranks' partial products; the (replicated) output
    gradient is each partial's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class ParallelDense(nn.Module):
    """A Dense whose kernel is this rank's column (dim 0) or row (dim 1)
    slice; same parameter names, full-size output."""

    def __init__(self, dense: Dense, dim: int, group, index: int, n: int):
        super().__init__()
        self.in_features = dense.in_features
        self.out_features = dense.out_features
        self.compute_dtype = dense.compute_dtype
        self.dim, self.group, self.n = dim, group, n
        w = dense.weight
        self.weight = nn.Parameter(w.detach().chunk(n, dim)[index].clone(),
                                   requires_grad=w.requires_grad)
        self.bias = dense.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.to(cd)
        w = self.weight.to(cd)
        if self.dim == 0:
            y = F.linear(_Replicate.apply(x, self.group), w)
            y = _GatherColumns.apply(y, self.group, self.n)
        else:
            y = F.linear(_OwnColumns.apply(x, self.group, self.n), w)
            y = _SumPartials.apply(y, self.group)
        return y if self.bias is None else y + self.bias.to(cd)


def apply_tensor_parallel(model: nn.Module, placements: Dict[str, Spec],
                          group, index: int, n: int) -> None:
    """Swap every Dense whose weight the placements split on 'model' for
    its ParallelDense slice, in place."""
    for name, spec in placements.items():
        dim = axis_dim(spec, "model")
        if dim is None:
            continue
        path = name.rsplit(".", 1)[0]
        dense = model.get_submodule(path)
        if not isinstance(dense, Dense):
            raise TypeError(f"{name}: tensor parallelism slices Dense "
                            f"kernels, not {type(dense).__name__}")
        parent, _, attr = path.rpartition(".")
        setattr(model.get_submodule(parent), attr,
                ParallelDense(dense, dim, group, index, n))
