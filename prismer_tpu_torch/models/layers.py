"""Shared building blocks, ported from prismer_tpu/models/layers.py.

Numerics follow the JAX package:
  * `LayerNorm` is an fp32 island: statistics and affine in fp32 (two-pass
    mean/variance, the JAX CPU default), result cast back to the input dtype.
  * `Dense` / `Conv` hold their weights in the compute dtype and cast their
    input to it, as flax `Dense(dtype=...)` casts kernel, bias and input.
  * Attention scores and logits accumulate in fp32 from compute-dtype
    operands (`matmul_f32`); softmax runs in fp32 and its probabilities are
    cast to the compute dtype before the PV product.
  * `Dropout` is flax `nn.Dropout` in train mode, its masks drawn from a
    generator seeded per layer and step (see its docstring for why).
  * `set_ln_proj(True)` (off by default, as in JAX) fuses the encoder
    block's pre-LayerNorms into their consumers: q/k/v, the MLP's first
    projection + activation and the whole norm-early Adaptor run as the
    `ops/ln_proj` kernels, whose rounding points are the JAX Pallas
    kernels'.
Layouts are batch-first (B, L, D) and NHWC for images, as in JAX. The
packed-qkv projection is off by default in JAX and is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from prismer_tpu_torch.ops.flash_attention import (NEG_INF, flash_attention,
                                                   packed_attention)
from prismer_tpu_torch.ops.layer_norm import fp32_layer_norm
from prismer_tpu_torch.ops.ln_proj import adaptor_fused, ln_proj


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), CLIP's GELU approximation."""
    return x * torch.sigmoid(1.702 * x)


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = F.relu(x)
    return r * r


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu_exact,
    "quick_gelu": quick_gelu,
    "squared_relu": squared_relu,
}


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's rows [offset, offset + rows) of a global batch of
    `total` rows split over the process group `group` (data parallelism)."""
    group: Any
    offset: int
    rows: int
    total: int


_BATCH_SHARD: Optional[BatchShard] = None


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]) -> Iterator[None]:
    """Run the block (a data-parallel train step's forward and backward,
    train/step.py) on `shard`: BatchNorm (vit.py) all-reduces its batch
    statistics over the shard's group and Dropout draws the global
    batch's masks."""
    global _BATCH_SHARD
    prev, _BATCH_SHARD = _BATCH_SHARD, shard
    try:
        yield
    finally:
        _BATCH_SHARD = prev


def current_batch_shard() -> Optional[BatchShard]:
    return _BATCH_SHARD


class Dropout:
    """flax `nn.Dropout` in train mode: keep each element with probability
    1 - rate and scale what is kept by 1 / (1 - rate), in the input's dtype;
    the identity when `seed` is None (eval) or rate is 0.

    The masks come from a generator made here from `seed` on the input's
    device. A rematerialised layer gets its seed as an argument and builds
    its Dropout inside the checkpointed call, so the recomputation draws the
    same masks: torch.utils.checkpoint restores only the default generators'
    states, never an explicit generator's.

    Under data parallelism (`batch_shard`) the leading dim
    of x is this rank's rows of the global batch: the mask is drawn at the
    global batch's shape and this rank keeps its rows, so every rank draws
    what one process draws."""

    def __init__(self, rate: float, seed: Optional[int],
                 device: torch.device):
        self.keep = 1.0 - rate
        self.gen = None
        if seed is not None and rate > 0.0:
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(seed)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.gen is None:
            return x
        shard = current_batch_shard()
        if shard is None:
            keep = torch.rand(x.shape, generator=self.gen, device=x.device)
        else:
            if x.shape[0] != shard.rows:
                raise ValueError(f"dropout over {x.shape[0]} rows, the batch "
                                 f"shard has {shard.rows}")
            keep = torch.rand((shard.total,) + tuple(x.shape[1:]),
                              generator=self.gen, device=x.device)
            keep = keep[shard.offset:shard.offset + shard.rows]
        keep = keep < self.keep
        return torch.where(keep, x / self.keep, torch.zeros_like(x))


def remat(fn: Callable, *args):
    """fn(*args) with its activations recomputed in the backward (flax
    `nn.remat`), the non-reentrant checkpoint. No global RNG state is
    stashed: the model's random draws come from explicit seeds."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation and an fp32 result from compute-dtype
    operands (JAX `preferred_element_type=float32`). Products of bf16 values
    are exact in fp32, so upcasting the operands gives the same sum."""
    return torch.matmul(a.float(), b.float())


class LayerNorm(nn.Module):
    """fp32-pinned LayerNorm with learnable weight/bias (flax scale/bias)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fp32_layer_norm(x, self.weight, self.bias, self.eps)


def _at_use(w: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    """A weight in the compute dtype. Only fp32 weights standing in for the
    compute-dtype ones (parallel/zero.py "zero3") are cast, at use, as
    flax casts its fp32 params; the dtype test spares every other call a
    dispatch."""
    return w if w is None or w.dtype == dtype else w.to(dtype)


class Dense(nn.Linear):
    """nn.Linear in the compute dtype that casts its input to that dtype."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 device=None, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x.to(cd), _at_use(self.weight, cd),
                        _at_use(self.bias, cd))


class Conv(nn.Conv2d):
    """nn.Conv2d in the compute dtype on NHWC tensors, bias-free unless
    asked for."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 padding: int, dtype, device=None, bias: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, bias=bias, device=device,
                         dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        y = self._conv_forward(x.to(cd).permute(0, 3, 1, 2),
                               _at_use(self.weight, cd),
                               _at_use(self.bias, cd))
        return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=64)
def _bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) 1-D bicubic matrix of F.interpolate(mode='bicubic',
    align_corners=False): cubic kernel a = -0.75, edge-clamped taps."""
    a = -0.75

    def kernel(t: float) -> float:
        t = abs(t)
        if t <= 1.0:
            return (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0
        if t < 2.0:
            return a * t ** 3 - 5.0 * a * t ** 2 + 8.0 * a * t - 4.0 * a
        return 0.0

    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        base = int(np.floor(src))
        frac = src - base
        for k in range(-1, 3):
            idx = min(max(base + k, 0), in_size - 1)
            mat[i, idx] += kernel(k - frac)
    return mat.astype(np.float32)


def interpolate_pos_embed(pos_embed: torch.Tensor,
                          target_len: int) -> torch.Tensor:
    """Resize a square (L, D) positional-embedding grid to target_len tokens
    (bicubic, a = -0.75, align_corners=False), in fp32."""
    orig = int(round(pos_embed.shape[0] ** 0.5))
    new = int(round(target_len ** 0.5))
    if orig == new:
        return pos_embed
    d = pos_embed.shape[-1]
    w = torch.from_numpy(_bicubic_matrix(orig, new)).to(pos_embed.device)
    grid = pos_embed.float().reshape(orig, orig, d)
    out = torch.einsum("oi,ijd->ojd", w, grid)
    out = torch.einsum("oj,sjd->sod", w, out)
    return out.reshape(new * new, d).to(pos_embed.dtype)


_LN_PROJ = False


def set_ln_proj(mode: Optional[bool]) -> None:
    """Turn the fused LayerNorm -> consumer kernels on or off (None: the
    default, off), as JAX's set_ln_proj; read at each forward."""
    global _LN_PROJ
    _LN_PROJ = bool(mode)


def use_ln_proj() -> bool:
    """Whether pre-LN blocks run LN inside `ops/ln_proj`'s kernels. Off by
    default, as in JAX (rejected there on the TPU, where the calls broke
    XLA's fusions)."""
    return _LN_PROJ


class Mlp(nn.Module):
    """c_fc -> activation -> c_proj.

    pre_ln: the (weight, bias) of a LayerNorm to apply first. With
    `use_ln_proj()` it runs inside the c_fc + activation kernel (`ln_proj`);
    otherwise `fp32_layer_norm` runs first (JAX's Mlp(pre_ln=...))."""

    def __init__(self, dim: int, hidden: int, out: int, activation: str,
                 dtype, device=None):
        super().__init__()
        self.activation = activation
        self.act = ACTIVATIONS[activation]
        self.c_fc = Dense(dim, hidden, dtype, device)
        self.c_proj = Dense(hidden, out, dtype, device)

    def forward(self, x: torch.Tensor,
                pre_ln: Optional[tuple] = None) -> torch.Tensor:
        if pre_ln is not None and use_ln_proj():
            fc = self.c_fc
            (h,) = ln_proj(x.to(fc.weight.dtype), pre_ln[0], pre_ln[1],
                           [fc.weight], [fc.bias], self.activation)
            return self.c_proj(h)
        if pre_ln is not None:
            x = fp32_layer_norm(x, pre_ln[0], pre_ln[1])
        return self.c_proj(self.act(self.c_fc(x)))


class Adaptor(nn.Module):
    """Dim-preserving adaptor up(sq_relu(down(.))) with residual + LN.

    norm_late=False (ViT): x + adaptor(LN(x));
    norm_late=True (decoder): LN(adaptor(x) + x)."""

    def __init__(self, dim: int, norm_late: bool, dtype, device=None,
                 eps: float = 1e-5):
        super().__init__()
        self.norm_late = norm_late
        self.down_proj = Dense(dim, dim, dtype, device)
        self.up_proj = Dense(dim, dim, dtype, device)
        self.adaptor_ln = LayerNorm(dim, eps, device)

    def _proj(self, h: torch.Tensor) -> torch.Tensor:
        return self.up_proj(squared_relu(self.down_proj(h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_late:
            return self.adaptor_ln(self._proj(x) + x)
        if use_ln_proj():
            down, up, ln = self.down_proj, self.up_proj, self.adaptor_ln
            return adaptor_fused(x.to(down.weight.dtype), ln.weight, ln.bias,
                                 down.weight, down.bias, up.weight, up.bias,
                                 ln.eps)
        return self._proj(self.adaptor_ln(x)) + x


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).permute(0, 2, 1, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, l, h * dh)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_mask: Optional[torch.Tensor] = None,
              causal: bool = False) -> torch.Tensor:
    """Structured-mask attention on (B, H, L, Dh): the flash kernel on CUDA,
    its plain version on the CPU. key_mask (B, Lk), 1 = valid."""
    return flash_attention(q, k, v, key_mask, causal)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask_bias: Optional[torch.Tensor] = None,
                          ) -> torch.Tensor:
    """Plain attention with an additive fp32 bias broadcastable to
    (B, H, Lq, Lk); fp32 softmax, probabilities cast to v's dtype."""
    scores = matmul_f32(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(
        q.shape[-1]))
    if mask_bias is not None:
        scores = scores + mask_bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return matmul_f32(probs, v).to(v.dtype)


def padding_mask_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, Lk) {0,1} mask -> (B, 1, 1, Lk) additive fp32 bias."""
    bias = (1.0 - attention_mask.float()) * NEG_INF
    return bias[:, None, None, :]


class MultiHeadAttention(nn.Module):
    """MHA with separate q/k/v/out projections, batch-first, optional
    distinct key/value source; attention through the packed flash kernel."""

    def __init__(self, dim: int, num_heads: int, dtype, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Dense(dim, dim, dtype, device)
        self.k_proj = Dense(dim, dim, dtype, device)
        self.v_proj = Dense(dim, dim, dtype, device)
        self.out_proj = Dense(dim, dim, dtype, device)

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                pre_ln: Optional[tuple] = None) -> torch.Tensor:
        """pre_ln: the (weight, bias) of a LayerNorm to apply to x first
        (self-attention only). With `use_ln_proj()` it runs inside one
        q/k/v kernel (`ln_proj`); otherwise `fp32_layer_norm` runs first."""
        if pre_ln is not None:
            assert kv is None, "pre_ln fusion is a self-attention feature"
            if use_ln_proj():
                projs = (self.q_proj, self.k_proj, self.v_proj)
                q, k, v = ln_proj(x.to(self.q_proj.weight.dtype), pre_ln[0],
                                  pre_ln[1], [p.weight for p in projs],
                                  [p.bias for p in projs])
                return self.out_proj(packed_attention(q, k, v,
                                                      self.num_heads))
            x = fp32_layer_norm(x, pre_ln[0], pre_ln[1])
        kv = x if kv is None else kv
        out = packed_attention(self.q_proj(x), self.k_proj(kv),
                               self.v_proj(kv), self.num_heads)
        return self.out_proj(out)
