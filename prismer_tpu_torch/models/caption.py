"""Captioning task head, ported from prismer_tpu/models/caption.py: the
training loss (captions of at most 30 tokens, pads and prompt positions
masked to -100, mean of per-sample summed label-smoothed CE), generation
(beam 3, max_length 20, min_length 8) and rank inference over a candidate
list (candidates ' <ans></s>', lowercased).

The serving entry points `build_generate_fn` and `build_rank_fn` take a raw
expert batch and run on the device of their inputs
(`build_sharded_generate_fn`: over the ranks of a mesh); the string-level
helpers (`generate_captions`, `rank_captions`) tokenize on the host around
a function they built.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from prismer_tpu_torch.data.device import materialize_experts
from prismer_tpu_torch.models.generation import beam_search, rank_answers
from prismer_tpu_torch.models.prismer import (Prismer, compute_dtype,
                                              prepare_serving_variables)
from prismer_tpu_torch.tokenizer import BPETokenizer

CAPTION_MAX_TOKENS = 30
GEN_NUM_BEAMS = 3
GEN_MAX_LENGTH = 20
GEN_MIN_LENGTH = 8


def prefix_prompt_ids(tokenizer: BPETokenizer, prefix: str, batch: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The tokenized prefix without its trailing </s>, repeated over the
    batch: (ids, mask), each (batch, P) int32."""
    enc = tokenizer([prefix], padding="longest")
    ids = enc.input_ids[:, :-1]
    mask = enc.attention_mask[:, :-1]
    return (np.repeat(ids, batch, axis=0), np.repeat(mask, batch, axis=0))


def prefix_length(tokenizer: BPETokenizer, prefix: str) -> int:
    """Caption positions the prefix covers (masked out of the loss):
    len(encode(prefix)) - 1 drops the </s>."""
    if not prefix:
        return 0
    return len(tokenizer.encode(prefix)) - 1


def caption_targets(input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    prompt_len: int, pad_token_id: int) -> torch.Tensor:
    """-100-masked labels: pads and the first `prompt_len` positions."""
    targets = torch.where(input_ids == pad_token_id,
                          torch.full_like(input_ids, -100), input_ids)
    if prompt_len > 0:
        targets[:, :prompt_len] = -100
    return targets


def caption_loss(model: Prismer, experts: Dict[str, Any],
                 input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 prompt_len: int, train: bool = True,
                 generator: Optional[torch.Generator] = None,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the batch of the per-sample summed CE. In train mode the
    stems' BatchNorm running statistics are updated in place (the JAX
    version returns them as `batch_stats` updates)."""
    targets = caption_targets(input_ids, attention_mask, prompt_len,
                              model.cfg.decoder.pad_token_id)
    per_sample = model.forward_loss(experts, input_ids, attention_mask,
                                    targets, train, generator)
    if weights is not None:
        per_sample = per_sample * weights
    return per_sample.mean()


def build_generate_fn(model: Prismer, *, num_beams: int = GEN_NUM_BEAMS,
                      max_length: int = GEN_MAX_LENGTH,
                      min_length: int = GEN_MIN_LENGTH,
                      length_penalty: float = 1.0):
    """The serving entry point: raw expert batch -> caption token ids.

    fn(experts_raw, prompt_ids, prompt_mask, instance_slots=None) runs
    materialize_experts -> encode -> beam_search on the device of its inputs
    and returns (B, max_length) int64 ids. When fused decode is in use on
    the model's device (the default on CUDA), the serving state (packed
    decoder weights, compute-dtype embedding, fp32 LM bias) is built here,
    once, and every call decodes through ops/fused_decode and ops/lm_topk."""
    dtype = compute_dtype(model.cfg)
    dec = model.cfg.decoder
    serving = prepare_serving_variables(model)

    @torch.no_grad()
    def fn(experts_raw: Dict[str, Any], prompt_ids: torch.Tensor,
           prompt_mask: torch.Tensor,
           instance_slots: Optional[torch.Tensor] = None) -> torch.Tensor:
        experts = materialize_experts(experts_raw, dtype)
        enc = model.encode(experts, instance_slots)
        seqs, _ = beam_search(
            model, enc, prompt_ids, prompt_mask, num_beams=num_beams,
            max_length=max_length, min_length=min_length,
            length_penalty=length_penalty, eos_token_id=dec.eos_token_id,
            pad_token_id=dec.pad_token_id, serving=serving)
        return seqs

    return fn


def build_sharded_generate_fn(model: Prismer, mesh, *,
                              num_beams: int = GEN_NUM_BEAMS,
                              max_length: int = GEN_MAX_LENGTH,
                              min_length: int = GEN_MIN_LENGTH,
                              length_penalty: float = 1.0):
    """Data-parallel serving over the ranks of `mesh` (parallel/mesh.py).

    fn(experts_raw, prompt_ids, prompt_mask, instance_slots=None) takes
    the global batch on every rank and returns its (B, max_length) ids on
    every rank. Each rank runs `build_generate_fn`'s pipeline on its rows
    (`batch_rows` over 'data'; the batch must divide that axis), with the
    fused decode kernels on CUDA as one process runs them, and the rows'
    ids are put back together in rank order. The model is replicated (JAX
    replicates the variables, P()); the instance slots are the ones one
    process uses, never the rank's own. No collective runs inside the
    loop: a sample's beams attend only that sample's encoder states."""
    import torch.distributed as dist

    from prismer_tpu_torch.parallel.mesh import batch_rows, shard_batch
    local = build_generate_fn(model, num_beams=num_beams,
                              max_length=max_length, min_length=min_length,
                              length_penalty=length_penalty)
    group = mesh.get_group("data")

    @torch.no_grad()
    def fn(experts_raw: Dict[str, Any], prompt_ids: torch.Tensor,
           prompt_mask: torch.Tensor,
           instance_slots: Optional[torch.Tensor] = None) -> torch.Tensor:
        rows = batch_rows(prompt_ids.shape[0], mesh)
        seqs = local(shard_batch(experts_raw, mesh), prompt_ids[rows],
                     prompt_mask[rows], instance_slots)
        # an all-gather in rank order, as the sum of each rank's rows put
        # in place: gloo takes CUDA tensors for all_reduce, not all_gather
        out = seqs.new_zeros((prompt_ids.shape[0], seqs.shape[1]))
        out[rows] = seqs
        dist.all_reduce(out, group=group)
        return out

    return fn


def build_rank_fn(model: Prismer, *, k_test: int):
    """The rank serving entry point: raw expert batch -> best answer index.

    fn(experts_raw, prompt_ids, prompt_mask, answer_ids, answer_mask,
    instance_slots=None) runs materialize_experts -> encode -> rank_answers
    on the device of its inputs and returns (B,) int64 indices into the
    (A, La) answer list."""
    dtype = compute_dtype(model.cfg)
    pad = model.cfg.decoder.pad_token_id

    @torch.no_grad()
    def fn(experts_raw: Dict[str, Any], prompt_ids: torch.Tensor,
           prompt_mask: torch.Tensor, answer_ids: torch.Tensor,
           answer_mask: torch.Tensor,
           instance_slots: Optional[torch.Tensor] = None) -> torch.Tensor:
        experts = materialize_experts(experts_raw, dtype)
        enc = model.encode(experts, instance_slots)
        return rank_answers(model, enc, prompt_ids, prompt_mask, answer_ids,
                            answer_mask, k_test=k_test, pad_token_id=pad)

    return fn


def to_expert_device(experts_raw: Dict[str, Any], *arrays: np.ndarray):
    """numpy arrays as tensors on the device of the expert batch."""
    device = experts_raw["rgb"].device
    return [torch.from_numpy(a).to(device) for a in arrays]


def generate_captions(generate: Callable, experts_raw: Dict[str, Any],
                      tokenizer: BPETokenizer, prefix: str = "",
                      instance_slots: Optional[torch.Tensor] = None
                      ) -> List[str]:
    """Captions as strings, the prefix stripped; `generate` is
    `build_generate_fn(model)` (its serving state built once per model)."""
    batch = experts_raw["rgb"].shape[0]
    ids, mask = to_expert_device(
        experts_raw, *prefix_prompt_ids(tokenizer, prefix, batch))
    seqs = generate(experts_raw, ids, mask, instance_slots)
    return decode_captions(seqs.cpu(), tokenizer, prefix)


def decode_captions(seqs, tokenizer, prefix: str) -> List[str]:
    """Decode with any tokenizer that has `decode(ids,
    skip_special_tokens=True)` and strip the prefix."""
    captions = []
    space = 1 if len(prefix) > 0 else 0
    for row in np.asarray(seqs):
        text = tokenizer.decode(row, skip_special_tokens=True)
        captions.append(text[len(prefix) + space:])
    return captions


def tokenize_answer_list(tokenizer: BPETokenizer, answers: Sequence[str],
                         lowercase: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Candidate answers as ' <ans></s>' (captioning) or ' <Ans></s>'
    capitalized (VQA), padded to the longest: (ids, mask) (A, La) int32."""
    if lowercase:
        texts = [" " + a.lower() + tokenizer.eos_token for a in answers]
    else:
        texts = [" " + a.capitalize() + tokenizer.eos_token for a in answers]
    enc = tokenizer(texts, padding="longest", add_special_tokens=False)
    return enc.input_ids, enc.attention_mask


def rank_captions(rank: Callable, experts_raw: Dict[str, Any],
                  tokenizer: BPETokenizer, answers: Sequence[str],
                  prefix: str = "",
                  instance_slots: Optional[torch.Tensor] = None
                  ) -> np.ndarray:
    """Classification-style rank inference: (B,) indices into `answers`;
    `rank` is `build_rank_fn(model, k_test=...)` (32 in the reference)."""
    batch = experts_raw["rgb"].shape[0]
    ans = tokenize_answer_list(tokenizer, answers, lowercase=True)
    prompt = prefix_prompt_ids(tokenizer, prefix, batch)
    best = rank(experts_raw, *to_expert_device(experts_raw, *prompt, *ans),
                instance_slots)
    return best.cpu().numpy()
