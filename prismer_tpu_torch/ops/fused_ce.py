"""Fused tied LM head + label-smoothed cross-entropy: the CUDA kernels'
wrappers, the autograd Function and the plain versions.

Port of prismer_tpu/ops/fused_ce.py. The kernels are `csrc/fused_ce.cu`; its
header note says what they replace, what bounds them on the H100 and how the
logits stay out of device memory. Per token, with x = h . emb^T + bias
(fp32 sums of compute-dtype products):

    lse, sumx = sum_v x, xlab = x[label]             ce_stats  (forward)
    per_tok = (1 - s) (lse - xlab) + s (lse - sumx / V)
    dx = gv (exp(x - lse) - s / V) - (1 - s) gv onehot(label)
    dh = dx emb, demb = dx^T h, dbias = sum dx        ce_grads  (backward)

`ce_stats` / `ce_grads` launch their kernels for CUDA tensors and compute
`ce_stats_reference` / `ce_grads_reference` (the materialised logits) only
for tensors on the CPU. Launches are counted in their `launches`
attributes. In bf16, `ce_grads` rounds dx once to bf16 (in a scratch that
lives for the call) before the two products, as the TPU kernel's
default-precision fp32 products do on the MXU, and sums dbias from the fp32
dx; `ce_plan` gives the bf16 kernels' launch plan and scratch.

`use_fused_ce` keeps the JAX package's rule: 'auto' takes the kernels for
training on the accelerator (CUDA here) and the plain logits path for
forward-only surfaces (the eval loss); 'on' / 'off' force both surfaces.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_V = {torch.float32: 64, torch.bfloat16: 128}   # vocab rows a tile
_D_MULTIPLE = {torch.float32: 32, torch.bfloat16: 64}
_DH_GROUPS = 32   # fp32: vocab groups of the dh kernel, summed in order
_BOX = 64 * 128   # bytes of a 64-row, 64-column bf16 TMA box
H100_SMS = 132

_FUSED_CE = "auto"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ce_plan(n: int, d: int, v: int, sms: int = H100_SMS) -> dict:
    """The bf16 kernels' launch plan, computed as `make_plan` in
    csrc/fused_ce.cu computes it (keep the two in step): per kernel its
    consumer warpgroups, threads, grid, ring stages and dynamic shared
    memory, and the scratch bytes of `ce_grads` (dx rounded to bf16, the
    dbias partials, the dh partials).

    * "stats" / "dx" (G1): 64 x wg feature rows (the wgmma M) x 128 vocab
      rows a block, K = D in 64-column chunks; grid (row tiles, vocab
      tiles).
    * "dh" (G3): dh^T = emb^T dx^T, 64 x wg columns of D x `rows` feature
      rows a block, the vocab (K) split `ksplit` ways of `per` 64-row
      chunks; grid (row tiles, D slices, ksplit), about one block an SM.
    * "demb" (G2): steps of 128 vocab rows x 128 columns of D, K = the
      feature rows; about one block an SM walks the vocab tiles. Its shared
      memory holds the ring and two steps' output staging.
    """
    wg = 1 if n <= 64 else (2 if n <= 128 else 4)
    row_tiles = _cdiv(n, 64 * wg)
    vtiles = _cdiv(v, 128)
    vp = vtiles * 128
    stages = min(_cdiv(d, 64), 3 if wg == 2 else 4)

    def logits_smem(grad: bool) -> int:
        return (1024 + stages * (wg + 2) * _BOX + 128 * 4
                + (wg * 4 * 128 * 4 if grad else 0) + 2 * stages * 8)

    nt = 64 if n <= 64 else (128 if n <= 128 else 256)
    h_wg = 2 if nt == 256 else 4
    h_row_tiles = _cdiv(n, nt)
    h_dslices = _cdiv(d, 64 * h_wg)
    h_chunks = vp // 64
    split = max(1, min(h_chunks, sms // (h_row_tiles * h_dslices)))
    per = _cdiv(h_chunks, split)
    ksplit = _cdiv(h_chunks, per)
    h_stages = min(per, 4)
    e_stages = 4
    logits = {"wg": wg, "threads": wg * 128, "grid": (row_tiles, vtiles, 1),
              "chunks": _cdiv(d, 64), "stages": stages}
    scratch = {"dx": n * vp * 2, "dbias": row_tiles * vp * 4,
               "dh": ksplit * n * d * 4}
    return {
        "vp": vp,
        "vtiles": vtiles,
        "stats": dict(logits, smem=logits_smem(False)),
        "dx": dict(logits, smem=logits_smem(True)),
        "dh": {"wg": h_wg, "rows": nt, "threads": h_wg * 128 + 32,
               "grid": (h_row_tiles, h_dslices, ksplit), "ksplit": ksplit,
               "per": per, "stages": h_stages,
               "smem": 1024 + h_stages * (h_wg * _BOX + nt * 128)
               + 2 * h_stages * 8},
        "demb": {"wg": 2, "threads": 2 * 128,
                 "grid": (min(vtiles, sms), 1, 1), "dslices": _cdiv(d, 128),
                 "chunks": _cdiv(n, 64), "stages": e_stages,
                 "smem": 1024 + (e_stages + 2) * 4 * _BOX
                 + 2 * e_stages * 8},
        "scratch": scratch,
        "scratch_bytes": sum(scratch.values()),
    }


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def set_fused_ce(mode: str) -> None:
    """'on' | 'off' | 'auto'."""
    global _FUSED_CE
    if mode not in ("on", "off", "auto"):
        raise ValueError(f"fused CE mode {mode!r}")
    _FUSED_CE = mode


def use_fused_ce(train: bool, device: torch.device) -> bool:
    """auto: the kernels for training on CUDA, the plain logits path for
    forward-only surfaces (as prismer_tpu/ops/fused_ce.py:69-87 decides on
    the TPU)."""
    if _FUSED_CE == "auto":
        return train and torch.device(device).type == "cuda"
    return _FUSED_CE == "on"


def _logits(h2, emb, bias):
    from prismer_tpu_torch.models.layers import matmul_f32
    return matmul_f32(h2, emb.t()) + bias.float()


def ce_stats_reference(h2: torch.Tensor, emb: torch.Tensor,
                       bias: torch.Tensor, lab: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xlab, sumx, lse), each (N,) fp32, from the materialised logits."""
    x = _logits(h2, emb, bias)
    xlab = x.gather(1, lab.long()[:, None])[:, 0]
    return xlab, x.sum(1), torch.logsumexp(x, dim=1)


def ce_grads_reference(h2: torch.Tensor, emb: torch.Tensor,
                       bias: torch.Tensor, lab: torch.Tensor,
                       gv: torch.Tensor, lse: torch.Tensor,
                       smoothing: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dh in h's dtype, demb in emb's dtype, dbias fp32) from the
    materialised logits, all products in fp32."""
    v = emb.shape[0]
    x = _logits(h2, emb, bias)
    dx = gv[:, None] * (torch.exp(x - lse[:, None]) - smoothing / v)
    onehot = torch.zeros_like(dx).scatter_(1, lab.long()[:, None], 1.0)
    dx = dx - (1.0 - smoothing) * gv[:, None] * onehot
    dh = torch.matmul(dx, emb.float()).to(h2.dtype)
    demb = torch.matmul(dx.t(), h2.float()).to(emb.dtype)
    return dh, demb, dx.sum(0)


def _check(name, h2, emb, bias, lab, *rows):
    n, d = h2.shape
    v = emb.shape[0]
    if (emb.shape != (v, d) or bias.shape != (v,) or lab.shape != (n,)
            or any(r.shape != (n,) for r in rows)):
        raise ValueError(f"{name}: h {tuple(h2.shape)} emb {tuple(emb.shape)}"
                         f" bias {tuple(bias.shape)} labels "
                         f"{tuple(lab.shape)}")
    if h2.dtype not in _DTYPE_CODES or d % _D_MULTIPLE[h2.dtype]:
        raise ValueError(f"{name}: kernel takes fp32 with D a multiple of "
                         f"32 or bf16 with D a multiple of 64; got "
                         f"{h2.dtype}, D = {d}")
    for t, dt in ((h2, h2.dtype), (emb, h2.dtype), (bias, torch.float32),
                  (lab, torch.int32), *((r, torch.float32) for r in rows)):
        if t.dtype != dt or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: a {t.dtype} {tuple(t.shape)} operand; "
                             f"kernel takes contiguous 16-byte aligned {dt}")


def ce_stats(h2: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
             lab: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xlab, sumx, lse) of logits = h2 @ emb^T + bias without storing them.
    h2 (N, D) and emb (V, D) in the compute dtype, bias (V,) fp32, lab (N,)
    int32 in [0, V)."""
    if not h2.is_cuda:
        return ce_stats_reference(h2, emb, bias, lab)
    from prismer_tpu_torch.ops import _build

    _check("ce_stats", h2, emb, bias, lab)
    n, d = h2.shape
    v = emb.shape[0]
    ntiles = _cdiv(v, _TILE_V[h2.dtype])
    work = torch.empty(4 * n * ntiles, dtype=torch.float32, device=h2.device)
    xlab, sumx, lse = (torch.empty(n, dtype=torch.float32, device=h2.device)
                       for _ in range(3))
    with _build.launch_device("ce_stats", h2, emb, bias, lab):
        err = _build.kernels().prismer_ce_stats(
            h2.data_ptr(), emb.data_ptr(), bias.data_ptr(), lab.data_ptr(),
            work.data_ptr(), xlab.data_ptr(), sumx.data_ptr(),
            lse.data_ptr(), n, d, v, ntiles, _DTYPE_CODES[h2.dtype],
            torch.cuda.current_stream(h2.device).cuda_stream)
    _build.check(err, "ce_stats")
    ce_stats.launches += 1
    return xlab, sumx, lse


ce_stats.launches = 0


def ce_grads(h2: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
             lab: torch.Tensor, gv: torch.Tensor, lse: torch.Tensor,
             smoothing: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dh, demb, dbias) of sum_n gv[n] * per_tok[n] without storing the
    fp32 logits or their gradient. gv and lse (N,) fp32."""
    if not h2.is_cuda:
        return ce_grads_reference(h2, emb, bias, lab, gv, lse, smoothing)
    from prismer_tpu_torch.ops import _build

    _check("ce_grads", h2, emb, bias, lab, gv, lse)
    n, d = h2.shape
    v = emb.shape[0]
    ntiles = _cdiv(v, _TILE_V[h2.dtype])
    if h2.dtype == torch.float32:
        groups = min(_DH_GROUPS, ntiles)
        words = groups * n * d
    else:
        plan = ce_plan(n, d, v, _sm_count(h2.device))
        groups = plan["dh"]["ksplit"]
        words = plan["scratch_bytes"] // 4
    work = torch.empty(words, dtype=torch.float32, device=h2.device)
    dh = torch.empty_like(h2)
    demb = torch.empty_like(emb)
    dbias = torch.empty(v, dtype=torch.float32, device=h2.device)
    with _build.launch_device("ce_grads", h2, emb, bias, lab, gv, lse):
        err = _build.kernels().prismer_ce_grads(
            h2.data_ptr(), emb.data_ptr(), bias.data_ptr(), lab.data_ptr(),
            gv.data_ptr(), lse.data_ptr(), work.data_ptr(), dh.data_ptr(),
            demb.data_ptr(), dbias.data_ptr(), n, d, v, ntiles, groups,
            smoothing / v, 1.0 - smoothing, _DTYPE_CODES[h2.dtype],
            torch.cuda.current_stream(h2.device).cuda_stream)
    _build.check(err, "ce_grads")
    ce_grads.launches += 1
    return dh, demb, dbias


ce_grads.launches = 0


class _PerTokenLoss(torch.autograd.Function):
    """Per-token smoothed CE with the stats kernel forward and the gradient
    kernel backward (JAX's _per_token_loss custom_vjp)."""

    @staticmethod
    def forward(ctx, h2, emb, bias, lab, valid, smoothing):
        v = emb.shape[0]
        xlab, sumx, lse = ce_stats(h2, emb, bias, lab)
        per_tok = valid * ((1.0 - smoothing) * (lse - xlab)
                           + smoothing * (lse - sumx / v))
        ctx.save_for_backward(h2, emb, bias, lab, valid, lse)
        ctx.smoothing = smoothing
        return per_tok

    @staticmethod
    def backward(ctx, g):
        h2, emb, bias, lab, valid, lse = ctx.saved_tensors
        gv = (g * valid).float().contiguous()
        dh, demb, dbias = ce_grads(h2, emb, bias, lab, gv, lse,
                                   ctx.smoothing)
        return dh, demb, dbias.to(bias.dtype), None, None, None


def fused_label_smoothed_loss(h: torch.Tensor, emb: torch.Tensor,
                              bias: torch.Tensor, labels: torch.Tensor,
                              smoothing: float = 0.1) -> torch.Tensor:
    """Per-sample summed label-smoothed CE of the tied-embedding LM head
    without materialising logits; equal to
    roberta.label_smoothed_loss(h @ emb^T + bias, labels).

    h (B, L, D) LM-head features in the compute dtype; emb (V, D) tied
    embeddings in the same dtype; bias (V,) fp32; labels (B, L) with -100
    ignored. Returns (B,) fp32, differentiable in h, emb and bias."""
    b, l, d = h.shape
    if l < 2:
        return torch.zeros(b, dtype=torch.float32, device=h.device)
    h2 = h[:, :-1, :].reshape(b * (l - 1), d).contiguous()
    lab2 = labels[:, 1:].reshape(-1)
    valid = lab2 != -100
    lab_safe = torch.where(valid, lab2, torch.zeros_like(lab2)).to(
        torch.int32).contiguous()
    per_tok = _PerTokenLoss.apply(h2, emb.contiguous(), bias.contiguous(),
                                  lab_safe, valid.float(), float(smoothing))
    return per_tok.reshape(b, l - 1).sum(1)
