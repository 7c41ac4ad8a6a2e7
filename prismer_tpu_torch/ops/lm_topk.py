"""Tied LM head + exact top-2K beam candidates: the CUDA kernel's wrapper and
the plain version.

Port of prismer_tpu/ops/lm_topk.py `lm_topk`. The kernel is
`csrc/lm_topk.cu`; its header note says what it replaces, what bounds it on
the H100 and how it is built. `lm_topk` launches the kernel for CUDA tensors
and computes `lm_topk_reference` for tensors on the CPU. Launches are counted
in `lm_topk.launches`.

The embedding stays in its natural (V, D) layout, unpadded: the TPU
kernel's pre-transposed, 128-lane padded vocab (`pad_layout`,
`pad_embedding`) and its row chunking are not carried over.
"""

from __future__ import annotations

from typing import Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_V = 256     # vocab rows per block of the kernel's first pass
MAX_KK = 16       # candidates a kernel call can return per sample
MAX_BEAMS = 8


@torch.no_grad()
def lm_topk_reference(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
                      alive_scores: torch.Tensor, mask_eos: bool, *,
                      beams: int, kk: int, eos_token_id: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: the port's LM-head product (fp32 sum of
    compute-dtype operands, + fp32 bias), then
    `models.generation.lazy_top_candidates`."""
    from prismer_tpu_torch.models.generation import lazy_top_candidates
    from prismer_tpu_torch.models.layers import matmul_f32

    logits = matmul_f32(h, emb.t()) + bias
    b = h.shape[0] // beams
    return lazy_top_candidates(logits.reshape(b, beams, -1), alive_scores,
                               kk, eos_token_id, mask_eos)


def lm_topk(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
            alive_scores: torch.Tensor, mask_eos: bool, *, beams: int,
            kk: int, eos_token_id: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-kk of alive[b, k] + log_softmax(h @ emb^T + bias)[b, k, v]
    over the flat (beams * V) axis, the EOS lane exactly alive + NEG_INF
    while `mask_eos` (cur_len < min_length); ties lowest flat index first.

    h (N, D) LM-head features in the compute dtype, N = B * beams; emb
    (V, D) tied embeddings in the same dtype; bias (V,) fp32; alive_scores
    (B, beams) fp32. Returns (vals (B, kk) fp32, beam (B, kk) int32, token
    (B, kk) int32)."""
    n, d = h.shape
    v = emb.shape[0]
    b = n // beams
    if (b * beams != n or tuple(emb.shape) != (v, d)
            or tuple(bias.shape) != (v,)
            or tuple(alive_scores.shape) != (b, beams)
            or not 0 < kk <= beams * v or not 0 <= eos_token_id < v):
        raise ValueError(f"lm_topk: h {tuple(h.shape)} emb "
                         f"{tuple(emb.shape)} bias {tuple(bias.shape)} alive "
                         f"{tuple(alive_scores.shape)} beams {beams} kk {kk}")
    if not h.is_cuda:
        return lm_topk_reference(h, emb, bias, alive_scores, mask_eos,
                                 beams=beams, kk=kk,
                                 eos_token_id=eos_token_id)
    from prismer_tpu_torch.ops import _build

    dtype = h.dtype
    if dtype not in _DTYPE_CODES or kk > MAX_KK or beams > MAX_BEAMS \
            or d % (32 if dtype == torch.bfloat16 else 8):
        raise ValueError(f"lm_topk: kernel takes {list(_DTYPE_CODES)}, kk <= "
                         f"{MAX_KK}, beams <= {MAX_BEAMS}, D a multiple of 8 "
                         f"(32 in bf16); got {dtype}, {kk}, {beams}, {d}")
    for name, x, dt in (("h", h, dtype), ("emb", emb, dtype),
                        ("bias", bias, torch.float32),
                        ("alive_scores", alive_scores, torch.float32)):
        if (not x.is_cuda or x.device != h.device or x.dtype != dt
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"lm_topk: {name} is {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}; kernel takes "
                             f"contiguous 16-byte aligned {dt} on {h.device}")
    dev = h.device
    ntiles = -(-v // _TILE_V)
    work = torch.empty(n * v + 2 * n * ntiles, dtype=torch.float32,
                       device=dev)
    vals = torch.empty((b, kk), dtype=torch.float32, device=dev)
    beam = torch.empty((b, kk), dtype=torch.int32, device=dev)
    tok = torch.empty((b, kk), dtype=torch.int32, device=dev)
    err = _build.kernels().prismer_lm_topk(
        h.data_ptr(), emb.data_ptr(), bias.data_ptr(), alive_scores.data_ptr(),
        work.data_ptr(), vals.data_ptr(), beam.data_ptr(), tok.data_ptr(),
        n, b, d, v, ntiles, kk, int(bool(mask_eos)), eos_token_id,
        _DTYPE_CODES[dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lm_topk")
    lm_topk.launches += 1
    return vals, beam, tok


lm_topk.launches = 0
