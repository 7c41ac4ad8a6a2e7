"""Beam-search bookkeeping: the CUDA kernel's wrapper and the plain version.

Port of prismer_tpu/ops/beam_update.py `beam_update` and of its spec,
prismer_tpu/models/generation.py `beam_bookkeeping`. The kernel is
`csrc/beam_update.cu`; its header note says what it replaces and why it is
built as it is. `beam_update` launches the kernel for CUDA tensors and
computes `beam_bookkeeping` for tensors on the CPU; the two are
bit-identical. Launches are counted in `beam_update.launches`.

Sequences are (N, T) int32 rows, N = B*K (the (B, K, T) view is the same
memory); scores are (B, K) fp32; candidates (B, 2K).
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1.0e7  # generation NEG_INF (JAX generation.py:38)
MAX_BEAMS = 16    # the kernel's K: 2K candidates in one warp's lanes


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, equal values lowest index first (the
    `lax.top_k` order; `torch.topk` does not promise one)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_bookkeeping(top_scores: torch.Tensor, top_beam: torch.Tensor,
                     top_token: torch.Tensor, alive_seqs: torch.Tensor,
                     alive_scores: torch.Tensor, finished_seqs: torch.Tensor,
                     finished_scores: torch.Tensor, index: int, pen: float, *,
                     eos_token_id: int, pad_token_id: int
                     ) -> Tuple[torch.Tensor, ...]:
    """Plain bookkeeping step, HF beam-search semantics.

    Returns (alive_seqs (N, T), alive_scores (B, K), finished_seqs (N, T),
    finished_scores (B, K), tokens (B, K), flat_beam (B, K))."""
    b, kk = top_scores.shape
    n, t = alive_seqs.shape
    k = n // b
    dev = top_scores.device
    pen_t = torch.tensor(pen, dtype=torch.float32, device=dev)
    aseq = alive_seqs.view(b, k, t)
    fseq = finished_seqs.view(b, k, t)
    top_beam = top_beam.long()
    is_eos = top_token == eos_token_id
    rank = torch.arange(kk, device=dev)[None, :]

    # done rule on the OLD state (generation.batch_done)
    done = finished_scores.amin(dim=1) >= alive_scores.amax(dim=1) / pen_t

    # retire EOS candidates ranked below K
    fin_valid = is_eos & (rank < k) & ~done[:, None]
    fin_cand = torch.where(fin_valid, top_scores / pen_t,
                           torch.full_like(top_scores, NEG_INF))
    cand_seqs = torch.gather(aseq, 1, top_beam[:, :, None].expand(b, kk, t))
    cand_seqs = cand_seqs.clone()
    cand_seqs[:, :, index] = eos_token_id
    merged_scores = torch.cat([finished_scores, fin_cand], dim=1)
    merged_seqs = torch.cat([fseq, cand_seqs], dim=1)
    new_fscore, fin_idx = stable_top_k(merged_scores, k)
    new_fseq = torch.gather(merged_seqs, 1, fin_idx[:, :, None].expand(b, k, t))

    # continue with the top-K non-EOS candidates
    cont = torch.where(is_eos, torch.full_like(top_scores, NEG_INF),
                       top_scores)
    new_ascore, cont_idx = stable_top_k(cont, k)
    new_beam = torch.gather(top_beam, 1, cont_idx)
    new_tok = torch.gather(top_token, 1, cont_idx)
    new_aseq = torch.gather(aseq, 1, new_beam[:, :, None].expand(b, k, t))
    new_aseq = new_aseq.clone()
    new_aseq[:, :, index] = new_tok.to(new_aseq.dtype)

    # freeze done samples
    keep = done[:, None]
    new_ascore = torch.where(keep, alive_scores, new_ascore)
    new_fscore = torch.where(keep, finished_scores, new_fscore)
    new_aseq = torch.where(keep[:, :, None], aseq, new_aseq)
    new_fseq = torch.where(keep[:, :, None], fseq, new_fseq)
    new_tok = torch.where(keep, torch.full_like(new_tok, pad_token_id),
                          new_tok)
    flat_beam = new_beam + torch.arange(b, device=dev)[:, None] * k
    return (new_aseq.reshape(n, t), new_ascore, new_fseq.reshape(n, t),
            new_fscore, new_tok.to(torch.int32), flat_beam.to(torch.int32))


def beam_update(vals: torch.Tensor, beam: torch.Tensor, tok: torch.Tensor,
                alive_seqs: torch.Tensor, alive_scores: torch.Tensor,
                finished_seqs: torch.Tensor, finished_scores: torch.Tensor,
                index: int, pen: float, *, eos_token_id: int,
                pad_token_id: int) -> Tuple[torch.Tensor, ...]:
    """One bookkeeping step (see `beam_bookkeeping` for the outputs).

    `index` is the write position (0 <= index < T); `pen` is
    cur_len ** length_penalty as an fp32 value."""
    b, kk = vals.shape
    n, t = alive_seqs.shape
    k = n // b
    if k * b != n or kk != 2 * k or not 0 <= index < t:
        raise ValueError(f"beam_update: vals {tuple(vals.shape)} seqs "
                         f"{tuple(alive_seqs.shape)} index {index}")
    if not vals.is_cuda:
        return beam_bookkeeping(vals, beam, tok, alive_seqs, alive_scores,
                                finished_seqs, finished_scores, index, pen,
                                eos_token_id=eos_token_id,
                                pad_token_id=pad_token_id)
    from prismer_tpu_torch.ops import _build

    for i, (x, dt, shape) in enumerate((
            (vals, torch.float32, (b, kk)), (beam, torch.int32, (b, kk)),
            (tok, torch.int32, (b, kk)), (alive_seqs, torch.int32, (n, t)),
            (alive_scores, torch.float32, (b, k)),
            (finished_seqs, torch.int32, (n, t)),
            (finished_scores, torch.float32, (b, k)))):
        if x.dtype != dt or x.shape != shape or not x.is_contiguous():
            raise ValueError(f"beam_update: input {i} is {x.dtype} "
                             f"{tuple(x.shape)}; kernel takes contiguous "
                             f"{dt} {shape}")
    if k > MAX_BEAMS:
        raise ValueError(f"beam_update: kernel takes K <= {MAX_BEAMS}, got "
                         f"{k}")
    # one allocation for the six outputs, each 16-byte aligned (the fused
    # step takes the flat beams so; the sequences when T % 4 == 0): the four
    # (B, K) rows, each padded to 4 words, then the two (N, T) blocks; the
    # scores are fp32 views of their int32 words
    bk4 = -(-b * k // 4) * 4
    buf = torch.empty(4 * bk4 + 2 * n * t, dtype=torch.int32,
                      device=vals.device)
    flat, new_tok, ascore, fscore = buf.as_strided((4, b, k),
                                                   (bk4, k, 1)).unbind(0)
    aseq, fseq = buf.as_strided((2, n, t), (n * t, t, 1), 4 * bk4).unbind(0)
    ascore, fscore = ascore.view(torch.float32), fscore.view(torch.float32)
    with _build.launch_device("beam_update", vals, beam, tok, alive_seqs,
                              alive_scores, finished_seqs, finished_scores):
        err = _build.kernels().prismer_beam_update(
            vals.data_ptr(), beam.data_ptr(), tok.data_ptr(),
            alive_seqs.data_ptr(), alive_scores.data_ptr(),
            finished_seqs.data_ptr(), finished_scores.data_ptr(),
            aseq.data_ptr(), ascore.data_ptr(), fseq.data_ptr(),
            fscore.data_ptr(), new_tok.data_ptr(), flat.data_ptr(), b, k, t,
            index, pen, eos_token_id, pad_token_id,
            torch._C._cuda_getCurrentRawStream(vals.get_device()))
    _build.check(err, "beam_update")
    beam_update.launches += 1
    return aseq, ascore, fseq, fscore, new_tok, flat


beam_update.launches = 0
