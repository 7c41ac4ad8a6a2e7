"""Beam-grouped decode cross-attention: the CUDA kernel's wrappers and the
plain versions.

Port of prismer_tpu/ops/decode_attention.py, both of its Pallas kernels,
which `csrc/decode_attention.cu` serves in two rounding modes (its header
note says what bounds it on the H100 and what its design does about it):

    grouped_cross_attention(q, k, v, mode="cross_t")   kernel 11
        (grouped_cross_attention_t): scores in fp32 from compute-dtype
        operands, p = exp2((s - m) log2 e) against the row max, l = sum p,
        p rounded to the compute dtype before the fp32 PV, o / max(l, 1e-30);
    grouped_decode_attention(q, k, v)                   kernel 12
        (grouped_decode_attention): operands widened to fp32, exp, fp32 p,
        the same division; `grouped_cross_attention(..., mode="decode")`.

q (B, H, Q, Dh) holds a sample's query rows (beams x tokens); k and v
(B, H, L, Dh) are the sample's natural-layout cross K/V, the per-layer
decode cache's layout, unpadded (JAX's pre-transposed K^T and its 128-lane
padding of L were TPU workarounds). Returns (B, H, Q, Dh) in q's dtype.

The per-layer decode path runs kernel 11 when
`models.roberta.set_decode_cross("kernel")`; no path runs kernel 12, as in
JAX. The wrappers launch the kernel for CUDA tensors (Dh 64, Q <= 64, fp32
or bf16) and raise on what it does not take; they compute the plain version
only for tensors on the CPU. Launches are counted in each wrapper's
`launches`.
"""

from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634
MODES = ("cross_t", "decode")
KERNEL_HEAD_DIM = 64
MAX_QUERIES = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def grouped_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, mode: str) -> torch.Tensor:
    """The plain version of both modes (module docstring)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(q.shape[-1]))
    m = s.amax(dim=-1, keepdim=True)
    if mode == "cross_t":
        p = torch.exp2((s - m) * LOG2E)
        o = torch.matmul(p.to(v.dtype).float(), v.float())
    else:
        p = torch.exp(s - m)
        o = torch.matmul(p, v.float())
    return (o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def _check(q, k, v) -> None:
    b, h, nq, dh = q.shape
    if k.dim() != 4 or k.shape[:2] != (b, h) or k.shape[3] != dh \
            or v.shape != k.shape:
        raise ValueError(f"grouped attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")


def _launch(q, k, v, mode: str) -> torch.Tensor:
    from prismer_tpu_torch.ops import _build

    b, h, nq, dh = q.shape
    if (q.dtype not in _DTYPE_CODES or dh != KERNEL_HEAD_DIM
            or not 1 <= nq <= MAX_QUERIES):
        raise ValueError(f"grouped attention: kernel takes "
                         f"{list(_DTYPE_CODES)}, Dh {KERNEL_HEAD_DIM}, 1 to "
                         f"{MAX_QUERIES} query rows; got {q.dtype}, Dh {dh}, "
                         f"Q {nq}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (not t.is_cuda or t.device != q.device or t.dtype != q.dtype
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"grouped attention: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; kernel takes "
                             f"contiguous 16-byte aligned {q.dtype} on "
                             f"{q.device}")
    out = torch.empty_like(q)
    err = _build.kernels().prismer_grouped_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, nq,
        k.shape[2], dh, MODES.index(mode), _DTYPE_CODES[q.dtype],
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"grouped attention ({mode})")
    return out


def grouped_decode_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """Kernel 12's attention (mode "decode")."""
    _check(q, k, v)
    if not q.is_cuda:
        return grouped_attention_reference(q, k, v, "decode")
    out = _launch(q, k, v, "decode")
    grouped_decode_attention.launches += 1
    return out


grouped_decode_attention.launches = 0


def grouped_cross_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mode: str = "cross_t"
                            ) -> torch.Tensor:
    """Kernel 11's attention (mode "cross_t"), or kernel 12's ("decode",
    counted by `grouped_decode_attention`)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if mode == "decode":
        return grouped_decode_attention(q, k, v)
    _check(q, k, v)
    if not q.is_cuda:
        return grouped_attention_reference(q, k, v, mode)
    out = _launch(q, k, v, mode)
    grouped_cross_attention.launches += 1
    return out


grouped_cross_attention.launches = 0
