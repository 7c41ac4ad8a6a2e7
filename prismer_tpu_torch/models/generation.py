"""KV-cached beam search, ported from prismer_tpu/models/generation.py.

HF beam-search semantics, as in JAX:
  * beams expand to 2K candidates per step; EOS candidates ranked >= K are
    dropped; EOS candidates within the top K retire to the finished set with
    score = sum_logprob / len**length_penalty; the top-K non-EOS candidates
    continue (ops/beam_update: the CUDA kernel on the card);
  * EOS is masked while cur_len < min_length;
  * early_stopping=False done rule; at the end, still-alive beams join the
    finished pool for samples that never finished.

The loop is plain Python: one host sync per step reads the all-done flag.
Cross K/V are per sample and never move. Two decode paths, as in JAX:
  * fused (roberta.use_fused_decode, the default on CUDA): the self-cache
    reorder is folded into the fused decode step (`perm`); with the serving
    state of prismer.prepare_serving_variables the loop carries the (N, D)
    LM-head features and ops/lm_topk projects and selects the top 2K in one
    call, so the (N, V) logits never reach Python;
  * per layer: the self cache is reordered by the flat beam permutation
    (index_select on the row axis), and lazy_top_candidates selects from
    the logits.

`rank_answers` is the two-pass rank inference over a candidate list.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from prismer_tpu_torch.models.prismer import Prismer
from prismer_tpu_torch.models.roberta import (num_valid_targets,
                                              use_fused_decode)
from prismer_tpu_torch.ops.beam_update import NEG_INF, beam_update
from prismer_tpu_torch.ops.lm_topk import lm_topk


def lazy_top_candidates(logits: torch.Tensor, alive_scores: torch.Tensor,
                        kk: int, eos_token_id: int, mask_eos: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-kk of cand[b, k, v] = alive[b, k] + log_softmax(logits)[b,
    k, v] over the flat (K*V) axis, the EOS lane forced to alive + NEG_INF
    while `mask_eos` (min-length rule). Ties go lowest flat index first.

    Same op order as the JAX function (alive + ((x - max) - log(sum exp)));
    unlike it, this plain version materialises the candidate matrix.
    Returns (vals (B, kk) fp32, beam (B, kk) int32, token (B, kk) int32)."""
    b, k, v = logits.shape
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    ls = torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True))
    cand = alive_scores[:, :, None] + ((logits - m) - ls)
    if mask_eos:
        cand[:, :, eos_token_id] = alive_scores + NEG_INF
    cand = cand.reshape(b, k * v)
    # -inf would tie with other -inf lanes; clamp as JAX exact_top_k does
    cand = torch.where(torch.isneginf(cand),
                       torch.full_like(cand, torch.finfo(cand.dtype).min),
                       cand)
    vals, idx = torch.sort(cand, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :kk].contiguous(), idx[:, :kk]
    return (vals, torch.div(idx, v, rounding_mode="floor").to(torch.int32),
            (idx % v).to(torch.int32))


def _pen(length: int, length_penalty: float) -> float:
    """cur_len ** length_penalty as an fp32 value (JAX computes it in f32)."""
    return float(np.float32(length) ** np.float32(length_penalty))


@torch.no_grad()
def beam_search(model: Prismer, encoder_hidden_states: torch.Tensor,
                prompt_ids: torch.Tensor, prompt_mask: torch.Tensor, *,
                num_beams: int, max_length: int, min_length: int,
                length_penalty: float = 1.0, eos_token_id: int = 2,
                pad_token_id: int = 1,
                serving: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sequences (B, max_length) int64, scores (B,) fp32).

    max_length / min_length count the whole sequence, prompt included.
    `serving` is prismer.prepare_serving_variables' state: on the fused
    path it supplies the packed weights and switches on ops/lm_topk."""
    b, p = prompt_ids.shape
    k, t = num_beams, max_length
    if p >= t:
        raise ValueError("prompt longer than max_length")
    dev = prompt_ids.device
    fused = use_fused_decode(dev)
    use_lm_topk = fused and serving is not None and "emb" in serving
    prompt_ids = prompt_ids.to(torch.int32)
    prompt_mask = prompt_mask.to(torch.int32)

    ids_tiled = prompt_ids.repeat_interleave(k, dim=0)
    mask_tiled = prompt_mask.repeat_interleave(k, dim=0)
    # with lm_topk the loop carries the (N, D) LM-head features, not logits
    out, cache = model.init_cache(
        ids_tiled, mask_tiled, encoder_hidden_states, t, k,
        return_h=use_lm_topk, packed=serving if fused else None)

    alive_seqs = torch.full((b * k, t), pad_token_id, dtype=torch.int32,
                            device=dev)
    alive_seqs[:, :p] = ids_tiled
    alive_scores = torch.full((b, k), NEG_INF, dtype=torch.float32,
                              device=dev)
    alive_scores[:, 0] = 0.0
    finished_seqs = torch.full_like(alive_seqs, pad_token_id)
    finished_scores = torch.full((b, k), NEG_INF, dtype=torch.float32,
                                 device=dev)
    prompt_nonpad = prompt_mask.sum(dim=1)                     # (B,)
    positions = torch.arange(t, device=dev)[None, :]
    prompt_cols = torch.zeros((b, t), dtype=torch.int32, device=dev)
    prompt_cols[:, :p] = prompt_mask

    def batch_done(index: int) -> torch.Tensor:
        pen = torch.tensor(_pen(index, length_penalty), device=dev)
        return finished_scores.amin(dim=1) >= alive_scores.amax(dim=1) / pen

    index = p
    while index < t and not bool(batch_done(index).all()):
        if use_lm_topk:
            top = lm_topk(out, serving["emb"], serving["lm_bias"],
                          alive_scores, index < min_length, beams=k,
                          kk=2 * k, eos_token_id=eos_token_id)
        else:
            top = lazy_top_candidates(out.reshape(b, k, -1), alive_scores,
                                      2 * k, eos_token_id, index < min_length)
        (alive_seqs, alive_scores, finished_seqs, finished_scores, tokens,
         flat_beam) = beam_update(
            *top, alive_seqs, alive_scores, finished_seqs, finished_scores,
            index, _pen(index, length_penalty), eos_token_id=eos_token_id,
            pad_token_id=pad_token_id)

        perm = flat_beam.reshape(-1)
        if not fused:
            cache["self_k"] = cache["self_k"].index_select(1, perm.long())
            cache["self_v"] = cache["self_v"].index_select(1, perm.long())
            perm = None

        pos_ids = prompt_nonpad + (index - p) + 1 + pad_token_id   # (B,)
        pos_ids = pos_ids.repeat_interleave(k)
        key_mask_b = torch.where(positions < p, prompt_cols,
                                 (positions <= index).to(torch.int32))
        key_mask = key_mask_b.repeat_interleave(k, dim=0)
        out, cache = model.decode_step(
            tokens.reshape(-1), index, pos_ids, key_mask, cache, k,
            perm=perm, return_h=use_lm_topk)
        index += 1

    alive_pen = alive_scores / torch.tensor(_pen(index, length_penalty),
                                            device=dev)
    not_done = ~batch_done(index)
    alive_pen = torch.where(not_done[:, None], alive_pen,
                            torch.full_like(alive_pen, NEG_INF))
    all_scores = torch.cat([finished_scores, alive_pen], dim=1)
    all_seqs = torch.cat([finished_seqs.reshape(b, k, t),
                          alive_seqs.reshape(b, k, t)], dim=1)
    best = all_scores.argmax(dim=1)
    rows = torch.arange(b, device=dev)
    return all_seqs[rows, best].long(), all_scores[rows, best]


def top_k_lowest_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, k) of the k largest values of each row of x (B, A),
    equal values in index order (jax.lax.top_k's order; torch.topk on CUDA
    promises no order among equals)."""
    return torch.sort(x, dim=1, descending=True, stable=True)[1][:, :k]


@torch.no_grad()
def rank_candidates(model: Prismer, encoder_hidden_states: torch.Tensor,
                    prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
                    first_tokens: torch.Tensor, k_test: int) -> torch.Tensor:
    """Rank pass 1: (B, k_test) int64 indices of the answers whose first
    token (first_tokens (A,)) is likeliest after the prompt, read from the
    softmax of the logits at the prompt's last column (a pad for a
    right-padded prompt, as in JAX and the reference); equal
    probabilities, as answers sharing a first token get, in index order."""
    logits = model.decode_logits(prompt_ids, prompt_mask,
                                 encoder_hidden_states)
    probs = torch.softmax(logits[:, -1, :], dim=-1)
    return top_k_lowest_first(probs[:, first_tokens.long()], k_test)


@torch.no_grad()
def score_candidates(model: Prismer, encoder_hidden_states: torch.Tensor,
                     prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
                     answer_ids: torch.Tensor, answer_mask: torch.Tensor,
                     candidates: torch.Tensor, pad_token_id: int = 1
                     ) -> torch.Tensor:
    """Rank pass 2: (B, k) fp32 scores of the candidates (B, k) (indices
    into the (A, La) answers): the decoder over [prompt ; answer], the
    encoder states untiled (cross_groups = k); a candidate's score is its
    label-smoothed loss over the answer tokens, negated and divided by
    their count."""
    b, p = prompt_ids.shape
    k = candidates.shape[1]
    la = answer_ids.shape[1]
    full_ids = torch.cat([prompt_ids[:, None, :].expand(b, k, p),
                          answer_ids[candidates].to(prompt_ids.dtype)],
                         dim=2).reshape(b * k, p + la)
    full_mask = torch.cat([prompt_mask[:, None, :].expand(b, k, p),
                           answer_mask[candidates].to(prompt_mask.dtype)],
                          dim=2).reshape(b * k, p + la)
    targets = torch.where(full_ids == pad_token_id,
                          torch.full_like(full_ids, -100), full_ids)
    targets[:, :p] = -100
    loss = model.decode_loss(full_ids, full_mask, encoder_hidden_states,
                             targets, cross_groups=k)
    denom = num_valid_targets(targets).clamp_min(1)
    return (-loss / denom).reshape(b, k)


def rank_answers(model: Prismer, encoder_hidden_states: torch.Tensor,
                 prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
                 answer_ids: torch.Tensor, answer_mask: torch.Tensor, *,
                 k_test: int, pad_token_id: int = 1) -> torch.Tensor:
    """Two-pass rank inference (`rank_candidates`, then `score_candidates`)
    over the answers (A, La), tokenized without added specials and ending
    in '</s>'; returns (B,) int64 indices of the best-scored candidate
    (the first among equals)."""
    candidates = rank_candidates(model, encoder_hidden_states, prompt_ids,
                                 prompt_mask, answer_ids[:, 0], k_test)
    scores = score_candidates(model, encoder_hidden_states, prompt_ids,
                              prompt_mask, answer_ids, answer_mask,
                              candidates, pad_token_id)
    return candidates.gather(1, scores.argmax(dim=1)[:, None])[:, 0]
