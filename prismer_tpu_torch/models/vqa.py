"""VQA task head, ported from prismer_tpu/models/vqa.py:

  * questions rendered as '<s>' + capitalize(q), at most 35 tokens, the BOS
    id prepended by hand;
  * training: [question ; ' Answer</s>'], loss on the answer span only,
    per-sample weights (VQA's multi-answer weighting);
  * generation: beam 3, max_length q_len + 10, min_length q_len + 2,
    length_penalty -1, through `build_answer_fn` (the serving state built
    once per model, as `caption.build_generate_fn` does);
  * rank inference over the dataset's answer list (k_test 128 in the
    reference), through `caption.build_rank_fn`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from prismer_tpu_torch.data.device import materialize_experts
from prismer_tpu_torch.models.caption import (to_expert_device,
                                              tokenize_answer_list)
from prismer_tpu_torch.models.generation import beam_search
from prismer_tpu_torch.models.prismer import (Prismer, compute_dtype,
                                              prepare_serving_variables)
from prismer_tpu_torch.tokenizer import BPETokenizer

QUESTION_MAX_TOKENS = 35
GEN_NUM_BEAMS = 3
GEN_EXTRA_TOKENS = 10     # max_length = q_len + 10
GEN_MIN_EXTRA = 2         # min_length = q_len + 2
GEN_LENGTH_PENALTY = -1.0


def render_question(q: str) -> str:
    return "<s>" + q.capitalize()


def tokenize_questions(tokenizer: BPETokenizer, questions: Sequence[str],
                       max_length: int = QUESTION_MAX_TOKENS
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, mask) (B, Q) int32 of '<s>' + capitalize(q), right-padded:
    the questions tokenized without added specials and truncated to
    max_length - 1 tokens, the BOS id prepended."""
    enc = tokenizer([q.capitalize() for q in questions], padding="longest",
                    truncation=True, max_length=max_length - 1,
                    add_special_tokens=False)
    b = enc.input_ids.shape[0]
    ids = np.concatenate(
        [np.full((b, 1), tokenizer.bos_token_id, np.int32), enc.input_ids],
        axis=1)
    mask = np.concatenate([np.ones((b, 1), np.int32), enc.attention_mask],
                          axis=1)
    return ids, mask


def vqa_training_batch(tokenizer: BPETokenizer, questions: Sequence[str],
                       answers: Sequence[str]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(input_ids, attention_mask, targets) of [question ; answer], the
    targets -100 on the question and on pads."""
    q_ids, q_mask = tokenize_questions(tokenizer, questions)
    a_ids, a_mask = tokenize_answer_list(tokenizer, answers, lowercase=False)
    ids = np.concatenate([q_ids, a_ids], axis=1)
    mask = np.concatenate([q_mask, a_mask], axis=1)
    targets = np.where(ids == tokenizer.pad_token_id, -100, ids)
    targets[:, :q_ids.shape[1]] = -100
    return ids, mask, targets


def vqa_loss(model: Prismer, experts: Dict[str, Any],
             input_ids: torch.Tensor, attention_mask: torch.Tensor,
             targets: torch.Tensor, weights: torch.Tensor,
             train: bool = True,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean over the batch of weights * the per-sample summed CE. In train
    mode the stems' BatchNorm running statistics are updated in place, as
    `caption.caption_loss` does."""
    per_sample = model.forward_loss(experts, input_ids, attention_mask,
                                    targets, train, generator)
    return (weights * per_sample).mean()


def beam_answers(model: Prismer, encoder_hidden_states: torch.Tensor,
                 question_ids: torch.Tensor, question_mask: torch.Tensor,
                 serving: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Beam search with VQA's settings over right-padded questions:
    (B, Q + 10) int64 ids, the questions included."""
    dec = model.cfg.decoder
    q_len = question_ids.shape[1]
    seqs, _ = beam_search(
        model, encoder_hidden_states, question_ids, question_mask,
        num_beams=GEN_NUM_BEAMS, max_length=q_len + GEN_EXTRA_TOKENS,
        min_length=q_len + GEN_MIN_EXTRA, length_penalty=GEN_LENGTH_PENALTY,
        eos_token_id=dec.eos_token_id, pad_token_id=dec.pad_token_id,
        serving=serving)
    return seqs


def build_answer_fn(model: Prismer):
    """The VQA generation entry point: raw expert batch -> answer ids.

    fn(experts_raw, question_ids, question_mask, instance_slots=None) runs
    materialize_experts -> encode -> `beam_answers` on the device of its
    inputs. The serving state (prismer.prepare_serving_variables) is built
    here, once, so on CUDA every call decodes through ops/fused_decode and
    ops/lm_topk."""
    dtype = compute_dtype(model.cfg)
    serving = prepare_serving_variables(model)

    @torch.no_grad()
    def fn(experts_raw: Dict[str, Any], question_ids: torch.Tensor,
           question_mask: torch.Tensor,
           instance_slots: Optional[torch.Tensor] = None) -> torch.Tensor:
        enc = model.encode(materialize_experts(experts_raw, dtype),
                           instance_slots)
        return beam_answers(model, enc, question_ids, question_mask, serving)

    return fn


def generate_answers(answer: Callable, experts_raw: Dict[str, Any],
                     tokenizer: BPETokenizer, questions: Sequence[str],
                     instance_slots: Optional[torch.Tensor] = None
                     ) -> List[str]:
    """Open-ended answers as lowercased strings; `answer` is
    `build_answer_fn(model)`."""
    ids, mask = to_expert_device(experts_raw,
                                 *tokenize_questions(tokenizer, questions))
    seqs = answer(experts_raw, ids, mask, instance_slots).cpu().numpy()
    q_len = ids.shape[1]
    return [tokenizer.decode(row[q_len:], skip_special_tokens=True)
            .lower().strip() for row in seqs]


def rank_vqa_answers(rank: Callable, experts_raw: Dict[str, Any],
                     tokenizer: BPETokenizer, questions: Sequence[str],
                     answer_list: Sequence[str],
                     instance_slots: Optional[torch.Tensor] = None
                     ) -> np.ndarray:
    """Answer-list rank inference: (B,) indices into answer_list; `rank` is
    `caption.build_rank_fn(model, k_test=...)` (128 in the reference)."""
    q = tokenize_questions(tokenizer, questions)
    ans = tokenize_answer_list(tokenizer, answer_list, lowercase=False)
    best = rank(experts_raw, *to_expert_device(experts_raw, *q, *ans),
                instance_slots)
    return best.cpu().numpy()
