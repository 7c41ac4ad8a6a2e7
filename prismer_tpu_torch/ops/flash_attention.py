"""Flash attention: the CUDA kernels' wrappers, the autograd Functions and
the plain versions.

Port of prismer_tpu/ops/flash_attention.py, forward and backward. The
forward kernel is `csrc/flash_attention.cu`, the backward kernels (dq and
dk/dv) `csrc/flash_attention_bwd.cu`; their header notes say which TPU
kernels they replace, what bounds them on the H100 and what their design
does about that.

    flash_attention(q, k, v, key_mask=None, causal=False)   (B, H, L, Dh)
    flash_attention_packed(q, k, v, num_heads)              (B, L, H*Dh)
    packed_attention(...)                                   router, as in JAX
    flash_attention_bwd_dq / flash_attention_bwd_dkv        backward kernels
    mha_reference, bwd_dq_reference, bwd_dkv_reference      plain versions

Both attention entry points are differentiable (`torch.autograd.Function`):
the forward saves its output and the fp32 lse, the backward computes
delta = rowsum(dO * O) in fp32 and runs the dq and dk/dv kernels. A wrapper
launches its kernel for CUDA tensors and raises on what the kernel does not
take; it computes the plain version only for tensors on the CPU. Each
wrapper counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e9  # the attention mask fill (JAX flash_attention.py:54)
# the head dims the kernels are built for: every one of the model registry's
# (BASE 64 and its resampler 96, ViT-H/14 80, the LARGE and HUGE resamplers
# 128 and 160)
KERNEL_HEAD_DIMS = (64, 80, 96, 128, 160)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_mask: Optional[torch.Tensor] = None,
                  causal: bool = False) -> torch.Tensor:
    """Plain attention: q, k, v (B, H, L, Dh); key_mask (B, Lk), 1 = valid.

    Scores in fp32 from input-dtype operands, finite -1e9 fill, bottom-right
    aligned causal mask, fp32 softmax, probabilities cast to the input dtype
    before the PV product (accumulated in fp32)."""
    return _reference_with_lse(q, k, v, key_mask, causal)[0]


def _reference_with_lse(q, k, v, key_mask=None, causal=False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :].bool(), s,
                        torch.full_like(s, NEG_INF))
    if causal:
        lq, lk = q.shape[2], k.shape[2]
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(
            lk - lq)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(p.float(), v.float()).to(v.dtype)
    return out, lse


def _check(q, k, v, name):
    for t in (q, k, v):
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"{name}: dtype {t.dtype} (kernel takes one of "
                             f"{list(_DTYPE_CODES)}, all equal)")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: inner stride {t.stride(-1)} != 1")


def _launch(q4, k4, v4, o4, key_mask, causal, name) -> torch.Tensor:
    """Run the kernel on (B, H, L, Dh) views (any strides, unit inner)."""
    from prismer_tpu_torch.ops import _build

    b, h, lq, dh = q4.shape
    lk = k4.shape[2]
    if k4.shape != (b, h, lk, dh) or v4.shape != k4.shape:
        raise ValueError(f"{name}: q {tuple(q4.shape)} k {tuple(k4.shape)} "
                         f"v {tuple(v4.shape)}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh} not in {KERNEL_HEAD_DIMS}")
    if q4.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
            for t in (q4, k4, v4, o4)):
        raise ValueError(f"{name}: bf16 rows must start 16-byte aligned")
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q4.device)
    mask_ptr, mask_sb = None, 0
    if key_mask is not None:
        if key_mask.shape != (b, lk):
            raise ValueError(f"{name}: key_mask {tuple(key_mask.shape)}")
        key_mask = key_mask.to(torch.int32).contiguous()
        mask_ptr, mask_sb = key_mask.data_ptr(), key_mask.stride(0)
    with _build.launch_device(name, q4, k4, v4, o4, key_mask):
        err = _build.kernels().prismer_flash_attention(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            lse.data_ptr(), mask_ptr, b, h, lq, lk, dh,
            *q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
            *o4.stride()[:3], mask_sb, int(causal), _DTYPE_CODES[q4.dtype],
            1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q4.device).cuda_stream)
    _build.check(err, name)
    return lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: Optional[torch.Tensor] = None,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, Lq, Dh) in the input dtype, lse (B, H, Lq) fp32)."""
    if not q.is_cuda:
        return _reference_with_lse(q, k, v, key_mask, causal)
    _check(q, k, v, "flash_attention")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = _launch(q, k, v, out, key_mask, causal, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*Dh) -> strided (B, H, L, Dh) view."""
    b, l, w = t.shape
    return t.view(b, l, num_heads, w // num_heads).permute(0, 2, 1, 3)


def flash_attention_packed_lse(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, num_heads: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-free attention on packed (B, L, H*Dh) operands.

    Returns (out (B, Lq, H*Dh), lse (B, H, Lq) fp32). The kernel reads the
    packed layout through strides: no head transposes, no padding."""
    b, lq, width = q.shape
    if width % num_heads:
        raise ValueError(f"width {width} not divisible by {num_heads} heads")
    if not q.is_cuda:
        out4, lse = _reference_with_lse(
            _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads))
        return out4.permute(0, 2, 1, 3).reshape(b, lq, width), lse
    _check(q, k, v, "flash_attention_packed")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = _launch(_heads(q, num_heads), _heads(k, num_heads),
                  _heads(v, num_heads), _heads(out, num_heads), None, False,
                  "flash_attention_packed")
    flash_attention_packed.launches += 1
    return out, lse


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _bwd_p_ds(q, k, v, dout, lse, delta, key_mask, causal
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's recomputed probabilities and score gradients, fp32
    (B, H, Lq, Lk): p = exp(s - lse) with the forward's masking (finite
    -1e9 fill, bottom-right causal), ds = p * (dO . v - delta)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :].bool(), s,
                        torch.full_like(s, NEG_INF))
    if causal:
        lq, lk = q.shape[2], k.shape[2]
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(
            lk - lq)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def bwd_dq_reference(q, k, v, dout, lse, delta, key_mask=None, causal=False
                     ) -> torch.Tensor:
    """Plain dq = sum_k round(ds) k * scale in fp32, out in q's dtype."""
    _, ds = _bwd_p_ds(q, k, v, dout, lse, delta, key_mask, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (torch.matmul(ds.to(k.dtype).float(), k.float()) * scale).to(
        q.dtype)


def bwd_dkv_reference(q, k, v, dout, lse, delta, key_mask=None, causal=False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dk = sum_q round(ds) q * scale and dv = sum_q round(p) dO in
    fp32, out in k's and v's dtypes."""
    p, ds = _bwd_p_ds(q, k, v, dout, lse, delta, key_mask, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """t itself if the backward kernels can read it, else a contiguous copy
    (the incoming gradient's layout is autograd's choice): unit inner
    stride, 16-byte aligned, and (batch, head, row) strides in multiples of
    16 bytes for bf16 (the TMA boxes of the tensor-core kernels) or of 4
    elements for fp32 (the FMA kernels' 16-byte loads)."""
    unit = 8 if t.dtype == torch.bfloat16 else 4
    if (t.stride(-1) == 1 and all(s % unit == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def _launch_bwd(fn_name, q, k, v, dout, lse, delta, key_mask, causal, outs):
    """Run one backward kernel on (B, H, L, Dh) views; outs are the views
    it writes (dq, or dk and dv)."""
    from prismer_tpu_torch.ops import _build

    b, h, lq, dh = q.shape
    lk = k.shape[2]
    for t in (q, k, v, dout, *outs):
        if t.dtype != q.dtype:
            raise ValueError(f"{fn_name}: tensors must share q's dtype "
                             f"{q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn_name}: dtype {q.dtype} (kernel takes one of "
                         f"{list(_DTYPE_CODES)})")
    if (k.shape != (b, h, lk, dh) or v.shape != k.shape
            or dout.shape != q.shape or dh not in KERNEL_HEAD_DIMS):
        raise ValueError(f"{fn_name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} dout {tuple(dout.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, lq) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{fn_name}: {name} must be contiguous fp32 "
                             f"(B, H, Lq)")
    for t in outs:
        if _kernel_layout(t) is not t:
            raise ValueError(f"{fn_name}: cannot write an output view with "
                             f"strides {t.stride()} at {t.data_ptr() % 16} "
                             f"bytes past 16-byte alignment")
    q, k, v, dout = (_kernel_layout(t) for t in (q, k, v, dout))
    mask_ptr, mask_sb = None, 0
    if key_mask is not None:
        if key_mask.shape != (b, lk):
            raise ValueError(f"{fn_name}: key_mask {tuple(key_mask.shape)}")
        key_mask = key_mask.to(torch.int32).contiguous()
        mask_ptr, mask_sb = key_mask.data_ptr(), key_mask.stride(0)
    full = (outs * 3)[:3] if len(outs) == 1 else (outs[0], outs[0], outs[1])
    strides = [s for t in (q, k, v, dout, *full) for s in t.stride()[:3]]
    with _build.launch_device(fn_name, q, k, v, dout, lse, delta, key_mask,
                              *outs):
        fn = getattr(_build.kernels(), fn_name)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), mask_ptr,
                 *(t.data_ptr() for t in outs), b, h, lq, lk, dh,
                 (ctypes.c_int64 * 21)(*strides), mask_sb, int(causal),
                 _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(dh),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, fn_name)


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, key_mask=None,
                           causal=False, out=None) -> torch.Tensor:
    """dq of head-split (B, H, L, Dh) attention, written into `out` (a
    (B, H, Lq, Dh) view, by default a new tensor in q's layout). lse and
    delta are (B, H, Lq) fp32."""
    if out is None:
        out = torch.empty_like(q)
    if not q.is_cuda:
        out.copy_(bwd_dq_reference(q, k, v, dout, lse, delta, key_mask,
                                   causal))
        return out
    _launch_bwd("prismer_flash_attention_bwd_dq", q, k, v, dout, lse, delta,
                key_mask, causal, (out,))
    flash_attention_bwd_dq.launches += 1
    return out


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, key_mask=None,
                            causal=False, out=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of head-split attention, written into `out` (a pair of
    (B, H, Lk, Dh) views, by default new tensors in k's and v's layouts)."""
    if out is None:
        out = (torch.empty_like(k), torch.empty_like(v))
    if not q.is_cuda:
        for o, r in zip(out, bwd_dkv_reference(q, k, v, dout, lse, delta,
                                               key_mask, causal)):
            o.copy_(r)
        return out
    _launch_bwd("prismer_flash_attention_bwd_dkv", q, k, v, dout, lse, delta,
                key_mask, causal, tuple(out))
    flash_attention_bwd_dkv.launches += 1
    return out


flash_attention_bwd_dkv.launches = 0


def attention_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32 over the last axis, contiguous."""
    return (dout.float() * out.float()).sum(-1).contiguous()


class _FlashAttention(torch.autograd.Function):
    """flash_attention with the backward kernels (JAX's custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        out, lse = flash_attention_lse(q, k, v, key_mask, causal)
        ctx.save_for_backward(q, k, v, out, lse, key_mask)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, key_mask = ctx.saved_tensors
        delta = attention_delta(dout, out)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, key_mask,
                                    ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, key_mask,
                                         ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Attention on head-split (B, H, L, Dh) operands; key_mask (B, Lk).
    Differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, key_mask, causal)


flash_attention.launches = 0


class _FlashAttentionPacked(torch.autograd.Function):
    """flash_attention_packed with the backward kernels reading the packed
    layout through strides (no head transposes, unlike JAX's _packed_bwd)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        out, lse = flash_attention_packed_lse(q, k, v, num_heads)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        h = ctx.num_heads
        b, lq, width = q.shape
        dout = dout.contiguous()
        delta = attention_delta(dout.view(b, lq, h, width // h),
                                out.view(b, lq, h, width // h))
        delta = delta.transpose(1, 2).contiguous()          # (B, H, Lq)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        views = [_heads(t, h) for t in (q, k, v, dout)]
        flash_attention_bwd_dq(*views, lse, delta, out=_heads(dq, h))
        flash_attention_bwd_dkv(*views, lse, delta,
                                out=(_heads(dk, h), _heads(dv, h)))
        return dq, dk, dv, None


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Differentiable mask-free attention on packed (B, L, H*Dh) operands."""
    return _FlashAttentionPacked.apply(q, k, v, num_heads)


flash_attention_packed.launches = 0


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, key_mask: Optional[torch.Tensor] = None,
                     causal: bool = False) -> torch.Tensor:
    """Attention on packed (B, L, H*Dh) operands: mask-free shapes take the
    packed kernel, masked or causal ones the head-split kernel."""
    if key_mask is None and not causal:
        return flash_attention_packed(q, k, v, num_heads)
    b, lq, width = q.shape
    out = flash_attention(_heads(q, num_heads), _heads(k, num_heads),
                          _heads(v, num_heads), key_mask, causal)
    return out.permute(0, 2, 1, 3).reshape(b, lq, width)
