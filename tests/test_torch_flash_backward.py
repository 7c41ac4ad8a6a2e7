"""Flash-attention backward of the PyTorch port (prismer_tpu_torch) against
the JAX package on the CPU: the port's autograd Functions, whose backward
runs the plain versions of the dq and dk/dv kernels here, against
`jax.vjp` of the JAX `flash_attention` / `flash_attention_packed` (Pallas
in interpret mode, as the JAX package's own tests run it).

Inputs and cotangents come from numpy seeds. fp32: max abs <= 1e-5; bf16:
rel L2 <= 1e-2 (the two frameworks round the bf16 forward output, which
feeds delta, at different places).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.ops import flash_attention as jfa
from prismer_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(2)

TOL_FP32 = 1e-5
TOL_BF16 = 1e-2

# (name, B, H, Lq, Lk, Dh, mask lengths or None, causal)
HEAD_SPLIT = [
    ("self causal key mask", 2, 3, 30, 30, 64, (30, 23), True),
    # sample 1 has no valid key: every row is fully masked (Lk = 128 so
    # the JAX kernel pads nothing and its masked rows see the same keys)
    ("fully masked rows", 2, 2, 128, 128, 64, (128, 0), True),
    ("cross Lq != Lk", 2, 3, 30, 77, 64, None, False),
    ("cross Dh 96", 1, 2, 20, 45, 96, None, False),
]
# (name, B, Lq, Lk, H, Dh). Dh 80 and 160 are the head dims whose tiles the
# bf16 kernels cut into 64-column blocks with a partial last block (HUGE's
# trunk, the HUGE resampler); JAX's packed kernel groups 8 and 4 such heads
# into 128-lane groups, so H is 8 and 4
PACKED = [
    ("packed Dh 64", 2, 40, 40, 2, 64),
    ("packed Dh 96 Lq != Lk", 2, 16, 50, 4, 96),
    ("packed Dh 80 H 8", 1, 12, 12, 8, 80),
    ("packed Dh 160 Lq != Lk", 1, 8, 20, 4, 160),
]


def _close(got, want, dtype, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.all(np.isfinite(got)), what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FP32,
                                   err_msg=what)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= TOL_BF16, (what, rel)


def _port_grads(fn, arrays, g, dtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(g).to(tdt))
    assert all(t.grad.dtype == tdt for t in ts)
    return [t.grad.float().numpy() for t in ts]


def _jax_grads(fn, arrays, g, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    xs = [jnp.asarray(a, jdt) for a in arrays]
    _, vjp = jax.vjp(fn, *xs)
    return [np.asarray(d.astype(jnp.float32))
            for d in vjp(jnp.asarray(g, jdt))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", HEAD_SPLIT, ids=[c[0] for c in HEAD_SPLIT])
def test_head_split_backward_matches_jax_vjp(case, dtype):
    name, b, h, lq, lk, dh, lens, causal = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = rng.standard_normal((b, h, lq, dh)).astype(np.float32)
    k = rng.standard_normal((b, h, lk, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, dh)).astype(np.float32)
    g = rng.standard_normal((b, h, lq, dh)).astype(np.float32)
    mask = None
    if lens is not None:
        mask = (np.arange(lk)[None] < np.asarray(lens)[:, None]).astype(
            np.int32)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    want = _jax_grads(lambda a, c, d: jfa.flash_attention(a, c, d, jmask,
                                                          causal),
                      (q, k, v), g, dtype)
    got = _port_grads(lambda a, c, d: pfa.flash_attention(a, c, d, tmask,
                                                          causal),
                      (q, k, v), g, dtype)
    for n, gg, ww in zip("qkv", got, want):
        _close(gg, ww, dtype, f"{name} d{n}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PACKED, ids=[c[0] for c in PACKED])
def test_packed_backward_matches_jax_vjp(case, dtype):
    name, b, lq, lk, h, dh = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = rng.standard_normal((b, lq, h * dh)).astype(np.float32)
    k = rng.standard_normal((b, lk, h * dh)).astype(np.float32)
    v = rng.standard_normal((b, lk, h * dh)).astype(np.float32)
    g = rng.standard_normal((b, lq, h * dh)).astype(np.float32)
    want = _jax_grads(lambda a, c, d: jfa.flash_attention_packed(a, c, d, h),
                      (q, k, v), g, dtype)
    got = _port_grads(lambda a, c, d: pfa.flash_attention_packed(a, c, d, h),
                      (q, k, v), g, dtype)
    for n, gg, ww in zip("qkv", got, want):
        _close(gg, ww, dtype, f"{name} d{n}")


def test_backward_wrappers_are_the_plain_versions_on_cpu():
    """On CPU tensors the dq and dk/dv wrappers compute the plain backward
    (written into the given output views) and launch nothing."""
    rng = np.random.default_rng(3)
    b, h, lq, lk, dh = 2, 2, 9, 13, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, h, lq, dh), (b, h, lk, dh), (b, h, lk, dh)))
    dout = torch.from_numpy(rng.standard_normal((b, h, lq, dh)).astype(
        np.float32))
    mask = torch.ones(b, lk, dtype=torch.int32)
    mask[1, 7:] = 0
    out, lse = pfa.flash_attention_lse(q, k, v, mask, True)
    delta = pfa.attention_delta(dout, out)
    before = (pfa.flash_attention_bwd_dq.launches,
              pfa.flash_attention_bwd_dkv.launches)
    dq = torch.full_like(q, float("nan"))
    got_dq = pfa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, mask, True,
                                        out=dq)
    got_dk, got_dv = pfa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                 mask, True)
    assert got_dq is dq
    torch.testing.assert_close(
        dq, pfa.bwd_dq_reference(q, k, v, dout, lse, delta, mask, True),
        rtol=0, atol=0)
    want_dk, want_dv = pfa.bwd_dkv_reference(q, k, v, dout, lse, delta, mask,
                                             True)
    torch.testing.assert_close(got_dk, want_dk, rtol=0, atol=0)
    torch.testing.assert_close(got_dv, want_dv, rtol=0, atol=0)
    assert (pfa.flash_attention_bwd_dq.launches,
            pfa.flash_attention_bwd_dkv.launches) == before


def test_kernel_layout_takes_the_dtype_into_account():
    """The bf16 kernels read their operands as TMA boxes, whose strides are
    multiples of 16 bytes (8 bf16): a bf16 view with a head stride of 4
    elements is copied. The fp32 kernels need multiples of 4 elements: an
    fp32 view with that stride is read in place."""
    base = torch.zeros(2, 6, 3 * 4 + 64)
    # (B, H, L, Dh) = (2, 3, 6, 64) with head stride 4, row stride 76
    view = base.as_strided((2, 3, 6, 64), (6 * 76, 4, 76, 1))
    assert pfa._kernel_layout(view) is view
    bf = base.to(torch.bfloat16).as_strided((2, 3, 6, 64), (6 * 76, 4, 76, 1))
    copy = pfa._kernel_layout(bf)
    assert copy is not bf and copy.is_contiguous()
    assert torch.equal(copy, bf)
    ok = torch.zeros(2, 6, 3 * 64, dtype=torch.bfloat16)
    heads = pfa._heads(ok, 3)
    assert pfa._kernel_layout(heads) is heads


def test_backward_rounds_p_and_ds_to_the_input_dtype():
    """bf16: p is rounded before p^T dO and ds before the dq / dk products
    (as the TPU kernels do), so the plain backward differs from the same
    formulas without those roundings, and equals them with them."""
    rng = np.random.default_rng(4)
    b, h, l, dh = 1, 1, 16, 64
    q, k, v, dout = (torch.from_numpy(
        rng.standard_normal((b, h, l, dh)).astype(np.float32)).to(
            torch.bfloat16) for _ in range(4))
    out, lse = pfa.flash_attention_lse(q, k, v)
    delta = pfa.attention_delta(dout, out)
    p, ds = pfa._bwd_p_ds(q, k, v, dout, lse, delta, None, False)
    dv = pfa.bwd_dkv_reference(q, k, v, dout, lse, delta)[1]
    want = (p.to(torch.bfloat16).float().transpose(-1, -2)
            @ dout.float()).to(torch.bfloat16)
    unrounded = (p.transpose(-1, -2) @ dout.float()).to(torch.bfloat16)
    torch.testing.assert_close(dv, want, rtol=0, atol=0)
    assert not torch.equal(dv, unrounded)
