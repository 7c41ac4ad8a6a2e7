"""Attention parity of the PyTorch port (prismer_tpu_torch.ops.
flash_attention) with the JAX package on the CPU.

On the CPU the port's wrappers compute their plain version; they are held
against JAX `mha_reference` and against the JAX Pallas kernels
`flash_attention` / `flash_attention_packed`, which run in interpret mode
here as tests/test_flash_attention.py runs them. lse is compared where the
JAX kernel returns it (after un-broadcasting its 8-lane layout). atol 1e-5,
fp32. The CUDA kernel itself is checked on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.ops import flash_attention as jfa
from prismer_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

ATOL = 1e-5


def make_qkv(seed, b, h, lq, lk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))


def key_mask(b, lk):
    mask = np.ones((b, lk), np.int32)
    mask[0, lk - 5:] = 0
    mask[-1, lk - 2:] = 0
    return mask


def pack(t):
    b, h, l, d = t.shape
    return np.ascontiguousarray(t.transpose(0, 2, 1, 3).reshape(b, l, h * d))


CASES = [  # (name, lq, lk, masked, causal)
    ("unmasked", 21, 37, False, False),
    ("padding_mask", 20, 33, True, False),
    ("causal", 29, 29, True, True),
    ("causal_cross_shape", 7, 19, False, True),
]


@pytest.mark.parametrize("dh", [16, 64, 96])
@pytest.mark.parametrize("name,lq,lk,masked,causal", CASES)
def test_head_split_matches_jax(name, lq, lk, masked, causal, dh):
    q, k, v = make_qkv(dh + lq, 2, 2, lq, lk, dh)
    mask = key_mask(2, lk) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))

    want_ref = np.asarray(jfa.mha_reference(q, k, v, jmask, causal))
    got_ref = tfa.mha_reference(tq, tk, tv, tmask, causal).numpy()
    np.testing.assert_allclose(got_ref, want_ref, atol=ATOL, rtol=0)

    got, got_lse = tfa.flash_attention_lse(tq, tk, tv, tmask, causal)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL, rtol=0)
    if causal and lq != lk:
        return  # the Pallas kernel's causal rule is defined at Lq == Lk only
    want, want_lse = jfa._flash_forward(q, k, v, jmask, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    want_lse = np.asarray(want_lse)[:, :lq, 0].reshape(2, 2, lq)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tfa.flash_attention(tq, tk, tv, tmask, causal).numpy(),
        np.asarray(jfa.flash_attention(q, k, v, jmask, causal)), atol=ATOL,
        rtol=0)


# H a multiple of the JAX kernel's lane group: 8 heads at Dh=16, 2 at 64,
# 4 at 96, 8 at 80, 1 at 128, 4 at 160 (ops/flash_attention.py
# _head_group); 80, 128 and 160 are the LARGE / HUGE head dims
@pytest.mark.parametrize("h,dh,lq,lk", [
    (8, 16, 13, 40),
    (4, 64, 37, 37),
    (2, 64, 13, 70),
    (4, 96, 20, 53),
    (8, 80, 9, 21),
    (2, 128, 11, 26),
    (4, 160, 7, 19),
])
def test_packed_matches_jax(h, dh, lq, lk):
    q, k, v = make_qkv(h * dh + lk, 2, h, lq, lk, dh)
    qp, kp, vp = pack(q), pack(k), pack(v)
    want_ref = pack(np.asarray(jfa.mha_reference(q, k, v)))
    want, want_lse = jfa._packed_forward(qp, kp, vp, h)
    got, got_lse = tfa.flash_attention_packed_lse(
        *map(torch.from_numpy, (qp, kp, vp)), h)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    g = jfa._head_group(dh)
    want_lse = np.asarray(want_lse).reshape(2, h // g, lq, g, 8)[..., 0]
    want_lse = want_lse.transpose(0, 1, 3, 2).reshape(2, h, lq)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tfa.flash_attention_packed(*map(torch.from_numpy, (qp, kp, vp)),
                                   h).numpy(),
        np.asarray(jfa.flash_attention_packed(qp, kp, vp, h)), atol=ATOL,
        rtol=0)


@pytest.mark.parametrize("masked,causal", [(True, False), (False, True)])
def test_packed_attention_routes_match_jax(masked, causal):
    """Masked or causal packed calls take the head-split path in both."""
    q, k, v = make_qkv(3, 2, 4, 24, 24, 16)
    mask = key_mask(2, 24) if masked else None
    want = jfa.packed_attention(
        pack(q), pack(k), pack(v), 4,
        key_mask=None if mask is None else jnp.asarray(mask), causal=causal)
    got = tfa.packed_attention(
        *(torch.from_numpy(pack(t)) for t in (q, k, v)), 4,
        key_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_bf16_probabilities_cast_before_pv():
    """The plain version rounds the softmax probabilities to bf16 before the
    PV product, as JAX does (layers.py:345-346); bf16 in, bf16 out."""
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16)
               for t in make_qkv(5, 1, 2, 9, 11, 16))
    got = tfa.mha_reference(q, k, v)
    assert got.dtype == torch.bfloat16
    s = (q.float() @ k.float().transpose(-1, -2)) * 0.25
    p = torch.softmax(s, -1).to(torch.bfloat16).float()
    torch.testing.assert_close(got, (p @ v.float()).to(torch.bfloat16),
                               atol=0, rtol=0)
    want = jfa.mha_reference(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                               for t in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=0)



@pytest.mark.parametrize("h,dh,lq,lk", [(8, 80, 9, 23)])
def test_bf16_packed_matches_jax_reference(h, dh, lq, lk):
    """bf16 packed attention at ViT-H/14's head dim against JAX
    mha_reference in bf16 (probabilities and output rounded where JAX
    rounds them); atol 1e-2, as above."""
    q, k, v = (torch.from_numpy(pack(t)).to(torch.bfloat16)
               for t in make_qkv(dh + lk, 2, h, lq, lk, dh))
    got, lse = tfa.flash_attention_packed_lse(q, k, v, h)
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    heads = [jnp.asarray(tfa._heads(t, h).float().numpy(), jnp.bfloat16)
             for t in (q, k, v)]
    want = pack(np.asarray(jfa.mha_reference(*heads).astype(jnp.float32)))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=0)
