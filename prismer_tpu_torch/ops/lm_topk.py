"""Tied LM head + exact top-2K beam candidates: the CUDA kernel's wrapper and
the plain version.

Port of prismer_tpu/ops/lm_topk.py `lm_topk`. The kernel is
`csrc/lm_topk.cu`; its header note says what it replaces, what bounds it on
the H100 and how it is built. `lm_topk` launches the kernel for CUDA tensors
and computes `lm_topk_reference` for tensors on the CPU. Launches are counted
in `lm_topk.launches`.

The embedding stays in its natural (V, D) layout, unpadded: the TPU
kernel's pre-transposed, 128-lane padded vocab (`pad_layout`,
`pad_embedding`) and its row chunking are not carried over. The kernel's
bf16 logits launch is planned by `lm_topk_plan`, the C `logits_plan`
mirrored.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE_V = 64       # vocab rows per tile (the wgmma M; the selection's unit)
CHUNK = 64        # D columns per TMA box of the embedding (128 bytes)
RINGS = 2         # consumer warpgroups a block, each with its own ring
MAX_STAGES = 8    # embedding boxes in flight per ring
MAX_TILE_ROWS = 64
SMEM_LIMIT = 227 * 1024   # a block's shared memory on sm_90
H100_SMS = 132
MAX_KK = 16       # candidates a kernel call can return per sample
SELECT_THREADS = 256   # the selection's threads per sample; thread t owns
#                        tiles t, t + 256, ... of every row
MAX_BEAMS = 8


class LogitsPlan(NamedTuple):
    rows: int        # feature rows per row tile: N rounded up to 8..32, 48, 64
    row_tiles: int   # row tiles of N
    chunks: int      # 64-column chunks of D
    tiles: int       # 64-row vocab tiles
    blocks: int      # blocks per row tile, each walking tiles blocks apart
    stages: int      # embedding boxes in flight per ring (two a block)
    smem_bytes: int  # dynamic shared memory per block


def _logits_smem(rows: int, chunks: int, stages: int) -> int:
    """Two rings of 64 x 64 bf16 boxes, the feature rows (chunks x rows x
    128 bytes), each warpgroup's cross-warp max and sum, stage barriers,
    1 KB of alignment slack."""
    return (RINGS * stages * TILE_V * CHUNK * 2 + chunks * rows * 128
            + RINGS * 2 * 4 * rows * 4 + RINGS * 2 * stages * 8 + 1024)


@functools.lru_cache(maxsize=64)
def lm_topk_plan(n: int, d: int, v: int, sms: int = H100_SMS) -> LogitsPlan:
    """The bf16 logits launch as the C entry computes it (`logits_plan`;
    keep the two in step): grid (blocks, row_tiles) of 320 threads (two
    wgmma warpgroups, each with a TMA producer warp and a ring); block x of
    a row tile takes vocab tiles x, x + blocks, ..., which alternate between
    its warpgroups."""
    r8 = -(-min(n, MAX_TILE_ROWS) // 8) * 8
    rows = r8 if r8 <= 32 else (48 if r8 <= 48 else 64)
    row_tiles = -(-n // rows)
    chunks = -(-d // CHUNK)
    tiles = -(-v // TILE_V)
    blocks = min(tiles, max(1, sms // row_tiles))
    per_block = -(-tiles // blocks)
    stages = min(MAX_STAGES, -(-per_block // RINGS) * chunks)
    while stages > 2 and _logits_smem(rows, chunks, stages) > SMEM_LIMIT:
        stages -= 1
    return LogitsPlan(rows, row_tiles, chunks, tiles, blocks, stages,
                      _logits_smem(rows, chunks, stages))


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
    if (dtype not in _DTYPE_CODES or kk > MAX_KK or beams > MAX_BEAMS
            or d % 8 or (dtype == torch.bfloat16 and lm_topk_plan(
                n, d, v).smem_bytes > SMEM_LIMIT)):
        raise ValueError(f"lm_topk: kernel takes {list(_DTYPE_CODES)}, kk <= "
                         f"{MAX_KK}, beams <= {MAX_BEAMS}, D a multiple of 8 "
                         f"whose feature rows fit shared memory; got {dtype}, "
                         f"{kk}, {beams}, {d}")
    for name, x, dt in (("h", h, dtype), ("emb", emb, dtype),
                        ("bias", bias, torch.float32),
                        ("alive_scores", alive_scores, torch.float32)):
        if x.dtype != dt or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"lm_topk: {name} is {x.dtype} "
                             f"{tuple(x.shape)}; kernel takes contiguous "
                             f"16-byte aligned {dt}")
    # one allocation: the (N, V) logits and the (N, tiles) partials, then
    # the outputs (their int32 parts viewed from the same floats)
    tiles = -(-v // TILE_V)
    scratch = n * v + 2 * n * tiles
    buf = torch.empty(scratch + 3 * b * kk, dtype=torch.float32,
                      device=h.device)
    vals, beam, tok = buf[scratch:].view(3, b, kk).unbind(0)
    beam, tok = beam.view(torch.int32), tok.view(torch.int32)
    with _build.launch_device("lm_topk", h, emb, bias, alive_scores):
        err = _build.kernels().prismer_lm_topk(
            h.data_ptr(), emb.data_ptr(), bias.data_ptr(),
            alive_scores.data_ptr(), buf.data_ptr(), vals.data_ptr(),
            beam.data_ptr(), tok.data_ptr(), n, b, d, v, tiles, kk,
            int(bool(mask_eos)), eos_token_id, _DTYPE_CODES[dtype],
            torch._C._cuda_getCurrentRawStream(h.get_device()))
    _build.check(err, "lm_topk")
    lm_topk.launches += 1
    return vals, beam, tok


lm_topk.launches = 0
