"""Rank inference of the port against the JAX package on the CPU
(prismer_tiny, six experts, 64 px, weights from a numpy seed loaded into
both packages): the grouped full-sequence cross-attention, the decoder loss
with cross_groups, `rank_answers` with many answers sharing a first token,
`build_rank_fn` and `rank_captions`, and the caption text helpers.

Tolerances: fp32 outputs to 1e-5 relative (1e-6 absolute), bf16 attention
outputs to 2e-2 (a bf16 ulp near 1 is 2^-8, and the two packages sum in
another order); indices and token ids exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu import tokenizer as jax_tok
from prismer_tpu.data.device import materialize_experts
from prismer_tpu.models import caption as jax_caption
from prismer_tpu.models.generation import rank_answers as jax_rank_answers
from prismer_tpu.models.prismer import Prismer
from prismer_tpu.models.roberta import num_valid_targets as jax_num_valid
from prismer_tpu_torch import tokenizer as port_tok
from prismer_tpu_torch.config import TextDecoderConfig, load_registry
from prismer_tpu_torch.models import caption as port_caption
from prismer_tpu_torch.models.generation import (rank_answers,
                                                 rank_candidates,
                                                 score_candidates,
                                                 top_k_lowest_first)
from prismer_tpu_torch.models.roberta import (SelfAttentionCore,
                                              num_valid_targets)
from tests.test_torch_model import (build_pair, instance_slots, raw_batch,
                                    to_jax, to_torch)

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
ENC_LEN, WIDTH = 80, 64          # prismer_tiny: 16 patches + 64 latents
K_TEST = 8


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _cross_attn(module):
    return module.text_decoder.layers[0].cross_attn


def _grouped_case(seed, b=2, groups=3, p=5):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((b * groups, p, WIDTH)).astype(np.float32)
    enc = rng.standard_normal((b, ENC_LEN, WIDTH)).astype(np.float32)
    return hidden, enc, groups


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_grouped_full_matches_jax(dtype):
    model, variables, port = build_pair(dtype)
    hidden, enc, g = _grouped_case(1)
    want = model.apply(
        variables, jnp.asarray(hidden), jnp.asarray(enc), g,
        method=lambda m, h, e, gg: _cross_attn(m).attend_grouped_full(
            h, e, gg))
    with torch.no_grad():
        got = port.text_decoder.layers_0.cross_attn.attend_grouped_full(
            torch.from_numpy(hidden), torch.from_numpy(enc), g)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape == (6, 5, WIDTH)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                   rtol=2e-2)


def test_grouped_scale_is_jax_division_at_every_registry_head_width():
    """attend_grouped multiplies the scores by 1/sqrt(Dh) where JAX divides
    by sqrt(Dh): the same fp32 values when sqrt(Dh) is a power of two,
    which holds for every registry decoder (Dh 64 at BASE and LARGE, 16 in
    prismer_tiny); other widths are refused."""
    for name, entry in load_registry().items():
        dec = entry["roberta_model"]
        dh = dec["hidden_size"] // dec["num_attention_heads"]
        assert math.frexp(math.sqrt(dh))[0] == 0.5, (name, dh)
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 50
    assert torch.equal(x / math.sqrt(64), x * (1.0 / math.sqrt(64)))
    assert not torch.equal(x / math.sqrt(32), x * (1.0 / math.sqrt(32)))
    odd = SelfAttentionCore(TextDecoderConfig(hidden_size=96,
                                              num_attention_heads=3), 96,
                            torch.float32)
    with pytest.raises(ValueError, match="power of two"):
        odd.attend_grouped_full(torch.zeros(2, 1, 96), torch.zeros(1, 4, 96),
                                2)
    with pytest.raises(ValueError, match="query rows"):
        odd.attend_grouped_full(torch.zeros(3, 1, 96), torch.zeros(1, 4, 96),
                                2)


def test_attend_grouped_full_at_dh64_equals_the_division_bit_for_bit():
    """At BASE's head width the reused path gives JAX's division exactly."""
    cfg = TextDecoderConfig(hidden_size=128, num_attention_heads=2)
    gen = torch.Generator().manual_seed(3)
    core = SelfAttentionCore(cfg, 96, torch.float32)
    with torch.no_grad():
        for p in core.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        hidden = torch.randn(6, 4, 128, generator=gen)
        enc = torch.randn(2, 9, 96, generator=gen)
        got = core.attend_grouped_full(hidden, enc, 3)
        q = core.project_q(hidden).reshape(2, 3, 2, 4, 64)
        k, v = core.project_kv(enc)
        s = torch.einsum("bghpd,bhld->bghpl", q, k) / math.sqrt(64)
        out = torch.einsum("bghpl,bhld->bghpd", torch.softmax(s, -1), v)
        want = out.reshape(6, 2, 4, 64).permute(0, 2, 1, 3).reshape(6, 4, 128)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def _loss_case(seed, b=2, groups=3, length=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 512, (b * groups, length)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[1, -2:], mask[1, -2:] = 1, 0            # right-padded rows
    ids[4, -3:], mask[4, -3:] = 1, 0
    targets = np.where(ids == 1, -100, ids)
    targets[:, :3] = -100
    enc = rng.standard_normal((b, ENC_LEN, WIDTH)).astype(np.float32)
    return ids, mask, targets, enc, groups


def test_decode_loss_with_cross_groups_matches_jax(pair):
    model, variables, port = pair
    ids, mask, targets, enc, g = _loss_case(4)
    want = jax.jit(lambda v, *a: model.apply(
        v, *a, cross_groups=g, method=Prismer.decode_loss))(
            variables, ids, mask, enc, targets)
    logits_want = jax.jit(lambda v, *a: model.apply(
        v, *a, cross_groups=g, method=Prismer.decode_logits))(
            variables, ids, mask, enc)
    t = [torch.from_numpy(x) for x in (ids, mask, enc, targets)]
    with torch.no_grad():
        got = port.decode_loss(*t, cross_groups=g)
        logits = port.decode_logits(*t[:3], cross_groups=g)
        tiled = port.decode_loss(t[0], t[1], t[2].repeat_interleave(g, 0),
                                 t[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_want),
                               rtol=RTOL, atol=1e-5)
    # the grouped path is the tiled computation without the G-fold K/V
    np.testing.assert_allclose(got.numpy(), tiled.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(num_valid_targets(t[3]).numpy(),
                                  np.asarray(jax_num_valid(targets)))


def test_top_k_lowest_first_matches_jax_on_ties():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 6, (4, 3000)).astype(np.float32) / 7.0
    x[3] = 0.25                                     # one long tie
    _, want = jax.lax.top_k(jnp.asarray(x), 16)
    got = top_k_lowest_first(torch.from_numpy(x), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[3].tolist() == list(range(16))


def _rank_case(seed, n_answers=40):
    """Right-padded prompts (5 and 3 tokens) and answers of 1-4 tokens
    whose first tokens take 4 values only, so pass 1 ties within each
    group."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(4, 512, (2, 5)).astype(np.int32)
    pmask = np.ones_like(prompt)
    prompt[1, 3:], pmask[1, 3:] = 1, 0
    first = rng.choice(rng.integers(4, 512, 4), n_answers).astype(np.int32)
    ans = np.full((n_answers, 5), 1, np.int32)
    amask = np.zeros_like(ans)
    for a in range(n_answers):
        n = rng.integers(1, 5)
        ans[a, 0] = first[a]
        ans[a, 1:n] = rng.integers(4, 512, n - 1)
        ans[a, n] = 2                               # '</s>'
        amask[a, :n + 1] = 1
    enc = rng.standard_normal((2, ENC_LEN, WIDTH)).astype(np.float32)
    return prompt, pmask, ans, amask, enc


@pytest.mark.parametrize("seed", [7, 8])
def test_rank_answers_matches_jax_with_tied_first_tokens(pair, seed):
    model, variables, port = pair
    prompt, pmask, ans, amask, enc = _rank_case(seed)
    want = jax.jit(lambda v, *a: jax_rank_answers(
        model, v, *a, k_test=K_TEST, pad_token_id=1))(
            variables, enc, prompt, pmask, ans, amask)
    logits = model.apply(variables, prompt, pmask, enc,
                         method=Prismer.decode_logits)
    probs = jax.nn.softmax(logits[:, -1, :], axis=-1)[:, ans[:, 0]]
    _, want_top = jax.lax.top_k(probs, K_TEST)
    t = [torch.from_numpy(x) for x in (enc, prompt, pmask, ans, amask)]
    top = rank_candidates(port, t[0], t[1], t[2], t[3][:, 0], K_TEST)
    scores = score_candidates(port, *t, top)
    got = rank_answers(port, *t, k_test=K_TEST)
    np.testing.assert_array_equal(top.numpy(), np.asarray(want_top))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int64
    # the ties are real: some top-k entries share a first token
    firsts = ans[top.numpy(), 0]
    assert any(len(set(r)) < len(r) for r in firsts)
    assert torch.isfinite(scores).all() and scores.shape == (2, K_TEST)


@pytest.fixture(scope="module")
def tokenizers():
    return jax_tok.synthetic_tokenizer(), port_tok.synthetic_tokenizer()


ANSWERS = ["a cat", "A dog", "the man", "the mat", "two", "the sky",
           "an apple", "a car", "a cart", "the theatre", "on", "in", "at",
           "the end", "anything", "there", "then", "The", "red", "a"]


def test_caption_text_helpers_match_jax(tokenizers):
    jt, pt = tokenizers
    for prefix in ("", "A picture of", "the"):
        for a, b in zip(jax_caption.prefix_prompt_ids(jt, prefix, 3),
                        port_caption.prefix_prompt_ids(pt, prefix, 3)):
            np.testing.assert_array_equal(b, a)
        assert port_caption.prefix_length(pt, prefix) == \
            jax_caption.prefix_length(jt, prefix)
    for lower in (True, False):
        for a, b in zip(jax_caption.tokenize_answer_list(jt, ANSWERS, lower),
                        port_caption.tokenize_answer_list(pt, ANSWERS,
                                                          lower)):
            assert b.dtype == np.int32
            np.testing.assert_array_equal(b, a)


def test_build_rank_fn_and_rank_captions_match_jax(pair, tokenizers):
    """JAX's build_rank_fn is its rank_captions (encode + rank_answers)
    under jit, on the prompt and answer ids rank_captions makes."""
    model, variables, port = pair
    jt, pt = tokenizers
    prefix = "A picture of"
    raw = raw_batch(31)
    ids, mask = jax_caption.prefix_prompt_ids(jt, prefix, 2)
    a_ids, a_mask = jax_caption.tokenize_answer_list(jt, ANSWERS)
    want = np.asarray(jax_caption.build_rank_fn(model, k_test=K_TEST)(
        variables, to_jax(raw), ids, mask, a_ids, a_mask))
    rank = port_caption.build_rank_fn(port, k_test=K_TEST)
    slots = torch.from_numpy(instance_slots())
    got = rank(to_torch(raw), *[torch.from_numpy(x) for x in
                                (ids, mask, a_ids, a_mask)], slots)
    np.testing.assert_array_equal(got.numpy(), want)
    strings = port_caption.rank_captions(rank, to_torch(raw), pt, ANSWERS,
                                         prefix=prefix, instance_slots=slots)
    np.testing.assert_array_equal(strings, want)
