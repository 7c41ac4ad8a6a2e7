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
(B, H, L, Dh) are the sample's natural-layout cross K/V, unpadded (JAX's
pre-transposed K^T and its 128-lane padding of L were TPU workarounds):
the per-layer decode cache, or the prefill's head-split views of the
projected (B, L, D) K/V, taken as they are. Returns (B, H, Q, Dh) in q's
dtype.

The kernel splits each (sample, head)'s keys over a cluster of SPLITS
blocks (`split_ranges`); `split_plan` gives a call's tiles and shared
memory. The per-layer decode path runs kernel 11 when
`models.roberta.set_decode_cross("kernel")`; no path runs kernel 12, as in
JAX. The wrappers launch the kernel for CUDA tensors (Dh 64, Q <= 64, fp32
or bf16, q contiguous, K/V strides that TMA takes: `tma_layout_ok`) and
raise on what it does not take; they compute the plain version only for
tensors on the CPU. Launches are counted in each wrapper's `launches`.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

LOG2E = 1.4426950408889634
MODES = ("cross_t", "decode")
KERNEL_HEAD_DIM = 64
MAX_QUERIES = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's split (csrc/decode_attention.cu): blocks per cluster, keys
# per TMA tile, query rows per pass, warps, tiles a block may hold, and a
# block's shared memory on sm_90
SPLITS = 4
TILE_KEYS = 64
PASS_ROWS = 16
WARPS = 4
MAX_TILES = 8
MAX_SMEM = 227 * 1024
MAX_BLOCK_ROWS = 65535    # B * H: the grid's y extent


class SplitPlan(NamedTuple):
    splits: int          # blocks per (sample, head)
    keys_per_block: int  # ceil(L / splits); the last blocks may hold fewer
    tiles: int           # 64-key tiles a full block loads
    smem_bytes: int      # dynamic shared memory per block


def split_ranges(length: int, splits: int = SPLITS) -> List[Tuple[int, int]]:
    """The key range [start, end) of each block of a (sample, head)'s
    cluster: contiguous, in rank order, ceil(length / splits) keys each,
    empty past the end."""
    per = -(-length // splits)
    return [(min(length, r * per), min(length, (r + 1) * per))
            for r in range(splits)]


def split_plan(length: int, queries: int, dtype: torch.dtype,
               mode: str) -> SplitPlan:
    """The kernel's split and per-block shared memory for L = `length`
    keys and Q = `queries` rows, as the C entry point computes them
    (`make_layout`): K tiles, and V tiles beside them with several passes
    of 16 query rows (one pass loads V where K was), fp32 queries (fp32
    only), the scores
    (unless bf16 cross_t, whose scores stay in registers), row maxima and
    sums, the slots the cluster's blocks' warps store their partial O
    columns and row sums into, one mbarrier per K tile and one per V tile,
    1 KB of alignment slack. Raises where the kernel cannot
    take the shape."""
    if dtype not in _DTYPE_CODES or mode not in MODES:
        raise ValueError(f"grouped attention: {dtype} {mode!r}")
    if length < 1 or not 1 <= queries <= MAX_QUERIES:
        raise ValueError(f"grouped attention: L {length}, Q {queries}")
    elt = 2 if dtype == torch.bfloat16 else 4
    per = -(-length // SPLITS)
    tiles = -(-per // TILE_KEYS)
    rows = min(queries, PASS_ROWS)
    rows4 = -(-rows // 4) * 4
    cols = KERNEL_HEAD_DIM // SPLITS
    tc_pv = dtype == torch.bfloat16 and mode == "cross_t"
    tile = TILE_KEYS * KERNEL_HEAD_DIM * elt
    smem = ((1 if queries <= PASS_ROWS else 2) * tiles * tile
            + (rows * KERNEL_HEAD_DIM * 4 if elt == 4 else 0)
            + (0 if tc_pv else rows * tiles * TILE_KEYS * 4)
            + (WARPS * PASS_ROWS + 2 * PASS_ROWS) * 4
            + SPLITS * WARPS * (rows * cols + rows4) * 4
            + 2 * tiles * 8 + 1024)
    if tiles > MAX_TILES or smem > MAX_SMEM:
        raise ValueError(
            f"grouped attention: L {length} needs {tiles} tiles of "
            f"{TILE_KEYS} keys and {smem} bytes of shared memory per block "
            f"({str(dtype)[6:]} {mode}); the kernel takes at most "
            f"{MAX_TILES} tiles and {MAX_SMEM} bytes")
    return SplitPlan(SPLITS, per, tiles, smem)


def tma_layout_ok(t: torch.Tensor) -> bool:
    """Whether the kernel's TMA loads can read a (B, H, L, Dh) view as it
    is: unit inner stride, 16-byte aligned base, and (batch, head, row)
    strides in multiples of 16 bytes."""
    unit = 16 // t.element_size()
    return (t.dim() == 4 and t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % unit == 0 for s in t.stride()[:3]))


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
            or not 1 <= nq <= MAX_QUERIES or b * h > MAX_BLOCK_ROWS):
        raise ValueError(f"grouped attention: kernel takes "
                         f"{list(_DTYPE_CODES)}, Dh {KERNEL_HEAD_DIM}, 1 to "
                         f"{MAX_QUERIES} query rows, B * H <= "
                         f"{MAX_BLOCK_ROWS}; got {q.dtype}, Dh {dh}, Q {nq}, "
                         f"B * H {b * h}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"grouped attention: {name} is {t.dtype}; "
                             f"kernel takes {q.dtype}")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("grouped attention: q must be contiguous and "
                         "16-byte aligned")
    for name, t in (("k", k), ("v", v)):
        if not tma_layout_ok(t):
            raise ValueError(f"grouped attention: TMA cannot read {name} "
                             f"with strides {t.stride()} at "
                             f"{t.data_ptr() % 16} bytes past 16-byte "
                             f"alignment (unit inner stride, 16-byte "
                             f"multiples)")
    split_plan(k.shape[2], nq, q.dtype, mode)
    out = torch.empty_like(q)
    with _build.launch_device("grouped attention", q, k, v):
        err = _build.kernels().prismer_grouped_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            nq, k.shape[2], dh, *k.stride()[:3], *v.stride()[:3],
            MODES.index(mode), _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream)
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
