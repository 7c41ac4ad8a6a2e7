"""Parity of the port's `lm_topk` (prismer_tpu_torch.ops.lm_topk) with the
JAX package's, on the CPU, on the cases of tests/test_lm_topk.py.

On the CPU the port computes its plain version (the LM-head product, then
`lazy_top_candidates`); the JAX kernel runs in interpret mode on its padded
layout (`pad_embedding`). Inputs come from numpy seeds. Indices must agree
exactly (tie order included); values to 2e-5 relative + 2e-5 absolute, the
tolerance the JAX tests hold the TPU kernel to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.ops.lm_topk import lm_topk as jax_lm_topk
from prismer_tpu.ops.lm_topk import pad_embedding
from prismer_tpu_torch.ops.beam_update import NEG_INF
from prismer_tpu_torch.ops.lm_topk import lm_topk, lm_topk_reference

torch.set_num_threads(2)

EOS = 2


def _both(h, emb, bias, alive, mask_eos, beams, kk):
    """(JAX kernel, port) results as numpy."""
    emb_tp, bias_p = pad_embedding(jnp.asarray(emb.T), jnp.asarray(bias),
                                   emb.shape[0])
    want = jax_lm_topk(jnp.asarray(h), emb_tp, bias_p, jnp.asarray(alive),
                       jnp.asarray(mask_eos), vocab=emb.shape[0],
                       beams=beams, kk=kk, eos_token_id=EOS)
    got = lm_topk(torch.from_numpy(h), torch.from_numpy(emb),
                  torch.from_numpy(bias), torch.from_numpy(alive), mask_eos,
                  beams=beams, kk=kk, eos_token_id=EOS)
    assert [g.dtype for g in got] == [torch.float32, torch.int32, torch.int32]
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


def _check(want, got):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("v,b,k,d", [
    (1000, 2, 3, 64),
    (50265, 2, 3, 128),   # the RoBERTa vocab: ragged against any tile
    (797, 4, 2, 32),
])
@pytest.mark.parametrize("mask_eos", [False, True])
def test_matches_jax_lm_topk(v, b, k, d, mask_eos):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((b * k, d)).astype(np.float32)
    emb = (rng.standard_normal((v, d)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((v,)) * 0.1).astype(np.float32)
    alive = np.where(rng.random((b, k)) < 0.3, NEG_INF,
                     rng.standard_normal((b, k))).astype(np.float32)
    _check(*_both(h, emb, bias, alive, mask_eos, k, 2 * k))


def test_eos_lane_is_alive_plus_neg_inf():
    """With mask_eos the EOS candidate is exactly alive + NEG_INF; without
    it a dominant EOS lane is picked."""
    rng = np.random.default_rng(1)
    v, b, k, d = 300, 1, 2, 16
    h = rng.standard_normal((b * k, d)).astype(np.float32)
    emb = (rng.standard_normal((v, d)) * 0.01).astype(np.float32)
    bias = np.zeros((v,), np.float32)
    bias[EOS] = 50.0
    alive = np.array([[0.0, -1.5]], np.float32)
    want, got = _both(h, emb, bias, alive, False, k, 4)
    _check(want, got)
    assert EOS in got[2][0]
    want, got = _both(h, emb, bias, alive, True, k, 4)
    _check(want, got)
    assert EOS not in got[2][0]
    # kk = every candidate: both EOS lanes come last, at their exact
    # sentinel values
    got = [x.numpy() for x in lm_topk(
        torch.from_numpy(h), torch.from_numpy(emb), torch.from_numpy(bias),
        torch.from_numpy(alive), True, beams=k, kk=2 * v, eos_token_id=EOS)]
    eos_at = np.flatnonzero(got[2][0] == EOS)
    assert eos_at.tolist() == [2 * v - 2, 2 * v - 1]
    assert got[1][0, eos_at].tolist() == [0, 1]
    np.testing.assert_array_equal(got[0][0, eos_at],
                                  (torch.from_numpy(alive[0]) + NEG_INF))


def test_tie_order_lowest_flat_index():
    """Exact ties, forced by duplicated embedding rows and identical beams,
    resolve to the lowest flat (beam-major) candidate index."""
    v, b, k, d = 256, 2, 3, 8
    rng = np.random.default_rng(2)
    h = np.abs(rng.standard_normal((b * k, d))).astype(np.float32)
    h[1] = h[0]                                 # sample 0: beams 0, 1 equal
    emb = (rng.standard_normal((v, d)) * 0.1).astype(np.float32)
    emb[[3, 7, 200]] = 1.0                      # three tied top rows
    bias = np.zeros((v,), np.float32)
    alive = np.zeros((b, k), np.float32)
    want, got = _both(h, emb, bias, alive, False, k, 6)
    _check(want, got)
    vals, flat = got[0][0], got[1][0] * v + got[2][0]
    assert (vals[:-1] == vals[1:]).any()         # the ties are real
    for i in range(len(vals) - 1):
        assert vals[i] > vals[i + 1] or (vals[i] == vals[i + 1]
                                         and flat[i] < flat[i + 1])

    h = np.ones((b * k, d), np.float32)          # every logit identical
    want, got = _both(h, np.zeros((v, d), np.float32), bias, alive, False, k,
                      4)
    _check(want, got)
    np.testing.assert_array_equal(got[1][0], [0, 0, 0, 0])
    np.testing.assert_array_equal(got[2][0], [0, 1, 2, 3])


def test_bf16_operands_accumulate_in_fp32():
    """bf16 features and embedding: the plain version's logits are the fp32
    sums of exact bf16 products (no bf16 rounding of the logits)."""
    rng = np.random.default_rng(3)
    v, b, k, d = 500, 2, 3, 64
    h = torch.from_numpy(rng.standard_normal((b * k, d)).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    bias = torch.zeros(v)
    alive = torch.zeros(b, k)
    hb, eb = h.to(torch.bfloat16), emb.to(torch.bfloat16)
    got = lm_topk(hb, eb, bias, alive, False, beams=k, kk=6,
                  eos_token_id=EOS)
    want = lm_topk_reference(hb.float(), eb.float(), bias, alive, False,
                             beams=k, kk=6, eos_token_id=EOS)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["beams", "emb", "bias", "kk", "eos"])
def test_rejects_bad_shapes(bad):
    h, emb = torch.zeros(6, 8), torch.zeros(20, 8)
    bias, alive = torch.zeros(20), torch.zeros(2, 3)
    kw = dict(beams=3, kk=6, eos_token_id=EOS)
    if bad == "beams":
        kw["beams"] = 4
    elif bad == "emb":
        emb = torch.zeros(20, 9)
    elif bad == "bias":
        bias = torch.zeros(21)
    elif bad == "kk":
        kw["kk"] = 61
    else:
        kw["eos_token_id"] = 20
    with pytest.raises(ValueError):
        lm_topk(h, emb, bias, alive, False, **kw)
