"""The VQA head of the port against the JAX package on the CPU
(prismer_tiny, six experts, 64 px, weights from a numpy seed loaded into
both packages, the synthetic tokenizer): question and training-batch
tokenization, the weighted loss, generation over right-padded questions
with fused decode forced on (the path the card takes: JAX's interpret-mode
Pallas kernels against the port's plain versions of kernels 3-5), caption
generation with a prefix, and answer-list ranking.

Tolerances: the loss to 1e-5 relative; token ids, strings and indices
exactly. JAX's generate_captions and generate_answers are encode + beam
search + decode; the tests run its jitted pieces and decode as it does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu import tokenizer as jax_tok
from prismer_tpu.data.device import materialize_experts
from prismer_tpu.models import caption as jax_caption
from prismer_tpu.models import roberta as jax_rb
from prismer_tpu.models import vqa as jax_vqa
from prismer_tpu.models.generation import beam_search
from prismer_tpu.models.prismer import Prismer, prepare_serving_variables
from prismer_tpu_torch import tokenizer as port_tok
from prismer_tpu_torch.data.device import \
    materialize_experts as port_materialize
from prismer_tpu_torch.models import caption as port_caption
from prismer_tpu_torch.models import roberta as port_rb
from prismer_tpu_torch.models import vqa as port_vqa
from tests.test_torch_model import (build_pair, instance_slots, raw_batch,
                                    to_jax, to_torch)

torch.set_num_threads(2)

QUESTIONS = ["what is on the mat?", "is it red"]          # 20 and 9 tokens
LONG = "is the cat " * 20 + "there?"
ANSWERS = ["yes", "no", "red", "the cat", "a cat", "two", "on the mat",
           "in the car", "then", "the end", "an apple", "there", "at home",
           "the sky", "one", "none"]


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def tokenizers():
    return jax_tok.synthetic_tokenizer(), port_tok.synthetic_tokenizer()


def test_question_and_training_tokenization_match_jax(tokenizers):
    jt, pt = tokenizers
    qs = QUESTIONS + [LONG, "", "WHY?"]
    want = jax_vqa.tokenize_questions(jt, qs)
    got = port_vqa.tokenize_questions(pt, qs)
    for a, b in zip(want, got):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(b, a)
    assert got[0].shape[1] == port_vqa.QUESTION_MAX_TOKENS
    assert port_vqa.render_question("is it") == \
        jax_vqa.render_question("is it")
    ans = ["yes", "the cat", "", "on the mat"] + ["no"]
    for a, b in zip(jax_vqa.vqa_training_batch(jt, qs, ans),
                    port_vqa.vqa_training_batch(pt, qs, ans)):
        np.testing.assert_array_equal(b, a)


def test_vqa_loss_with_weights_matches_jax(pair, tokenizers, monkeypatch):
    """Eval mode: both encoders take JAX's fixed instance-slot draw."""
    from prismer_tpu_torch.models import vit
    monkeypatch.setattr(vit, "draw_instance_slots",
                        lambda *a: torch.from_numpy(instance_slots()))
    model, variables, port = pair
    jt, pt = tokenizers
    ids, mask, targets = port_vqa.vqa_training_batch(
        pt, QUESTIONS, ["the cat", "no"])
    weights = np.array([0.25, 1.5], np.float32)
    raw = raw_batch(41)
    want = jax.jit(lambda v, e, *a: jax_vqa.vqa_loss(
        model, v, materialize_experts(e), *a, train=False))(
            variables, to_jax(raw), ids, mask, targets, weights)
    with torch.no_grad():
        per = port.forward_loss(
            port_materialize(to_torch(raw)), torch.from_numpy(ids),
            torch.from_numpy(mask), torch.from_numpy(targets))
        got = port_vqa.vqa_loss(
            port, port_materialize(to_torch(raw)), torch.from_numpy(ids),
            torch.from_numpy(mask), torch.from_numpy(targets),
            torch.from_numpy(weights), train=False)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got.item(),
                               (per * torch.from_numpy(weights)).mean().item(),
                               rtol=1e-6)
    assert got.item() != pytest.approx(per.mean().item())


@pytest.fixture
def fused_on(monkeypatch):
    """Fused decode forced on in both packages (reset to 'auto' after), the
    port's plain versions of fused_decode_step and lm_topk counted."""
    from prismer_tpu_torch.ops import fused_decode, lm_topk
    calls = {"fused": 0, "lm_topk": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fused_decode, "fused_decode_step_reference",
                        count("fused", fused_decode.fused_decode_step_reference))
    monkeypatch.setattr(lm_topk, "lm_topk_reference",
                        count("lm_topk", lm_topk.lm_topk_reference))
    jax_rb.set_fused_decode("on")
    port_rb.set_fused_decode("on")
    try:
        yield calls
    finally:
        jax_rb.set_fused_decode("auto")
        port_rb.set_fused_decode("auto")


def test_generate_answers_matches_jax_with_fused_decode(pair, tokenizers,
                                                        fused_on):
    model, variables, port = pair
    jt, pt = tokenizers
    serving = prepare_serving_variables(model, variables)
    raw = raw_batch(43)
    ids, mask = jax_vqa.tokenize_questions(jt, QUESTIONS)
    assert mask[1].sum() < mask.shape[1]          # a right-padded question
    q_len = ids.shape[1]
    enc = jax.jit(lambda v, e: model.apply(
        v, materialize_experts(e), method=Prismer.encode))(
            variables, to_jax(raw))
    want_ids, _ = jax.jit(lambda v, e, i, m: beam_search(
        model, v, e, i, m, num_beams=3, max_length=q_len + 10,
        min_length=q_len + 2, length_penalty=-1.0, eos_token_id=2,
        pad_token_id=1))(serving, enc, ids, mask)
    want_ids = np.asarray(want_ids)
    want = [jt.decode(r[q_len:]).lower().strip() for r in want_ids]

    answer = port_vqa.build_answer_fn(port)
    slots = torch.from_numpy(instance_slots())
    got_ids = answer(to_torch(raw), torch.from_numpy(ids),
                     torch.from_numpy(mask), slots)
    assert got_ids.shape == (2, q_len + 10)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    got = port_vqa.generate_answers(answer, to_torch(raw), pt, QUESTIONS,
                                    slots)
    assert got == want
    assert fused_on["fused"] > 0 and fused_on["lm_topk"] == fused_on["fused"]


def test_generate_captions_matches_jax_with_fused_decode(pair, tokenizers,
                                                         fused_on):
    model, variables, port = pair
    jt, pt = tokenizers
    serving = prepare_serving_variables(model, variables)
    raw = raw_batch(44)
    ids, mask = jax_caption.prefix_prompt_ids(jt, "A picture of", 2)
    seqs = jax_caption.build_generate_fn(model)(serving, to_jax(raw), ids,
                                                mask)
    want = jax_caption.decode_captions(np.asarray(seqs), jt, "A picture of")
    got = port_caption.generate_captions(
        port_caption.build_generate_fn(port), to_torch(raw), pt,
        prefix="A picture of", instance_slots=torch.from_numpy(
            instance_slots()))
    assert got == want and len(got) == 2
    assert fused_on["fused"] > 0 and fused_on["lm_topk"] == fused_on["fused"]


def test_rank_vqa_answers_matches_jax(pair, tokenizers):
    """JAX's rank_vqa_answers is build_rank_fn on the question and
    capitalized answer ids; the port's takes the strings."""
    model, variables, port = pair
    jt, pt = tokenizers
    raw = raw_batch(45)
    q_ids, q_mask = jax_vqa.tokenize_questions(jt, QUESTIONS)
    a_ids, a_mask = jax_caption.tokenize_answer_list(jt, ANSWERS,
                                                     lowercase=False)
    want = np.asarray(jax_caption.build_rank_fn(model, k_test=6)(
        variables, to_jax(raw), q_ids, q_mask, a_ids, a_mask))
    got = port_vqa.rank_vqa_answers(
        port_caption.build_rank_fn(port, k_test=6), to_torch(raw), pt,
        QUESTIONS, ANSWERS, torch.from_numpy(instance_slots()))
    np.testing.assert_array_equal(got, want)
