"""Flash attention: the CUDA kernel's wrappers and the plain version.

Port of prismer_tpu/ops/flash_attention.py (forward only). The kernel is
`csrc/flash_attention.cu`; its header note says which TPU kernels it
replaces, what bounds it on the H100 and what its design does about that.

    flash_attention(q, k, v, key_mask=None, causal=False)   (B, H, L, Dh)
    flash_attention_packed(q, k, v, num_heads)              (B, L, H*Dh)
    packed_attention(...)                                   router, as in JAX
    mha_reference(...)                                      the plain version

A wrapper launches the kernel for CUDA tensors and raises on what the kernel
does not take; it computes the plain version only for tensors on the CPU.
Each wrapper counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e9  # the attention mask fill (JAX flash_attention.py:54)
KERNEL_HEAD_DIMS = (64, 96)
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
        if not t.is_cuda:
            raise ValueError(f"{name}: mixed devices")
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
        if key_mask.shape != (b, lk) or not key_mask.is_cuda:
            raise ValueError(f"{name}: key_mask {tuple(key_mask.shape)}")
        key_mask = key_mask.to(torch.int32).contiguous()
        mask_ptr, mask_sb = key_mask.data_ptr(), key_mask.stride(0)
    err = _build.kernels().prismer_flash_attention(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
        lse.data_ptr(), mask_ptr, b, h, lq, lk, dh,
        *q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
        *o4.stride()[:3], mask_sb, int(causal), _DTYPE_CODES[q4.dtype],
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q4.device).cuda_stream)
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Attention on head-split (B, H, L, Dh) operands; key_mask (B, Lk)."""
    return flash_attention_lse(q, k, v, key_mask, causal)[0]


flash_attention.launches = 0


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


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    return flash_attention_packed_lse(q, k, v, num_heads)[0]


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
