"""Parity of the port's beam-grouped decode cross-attention
(prismer_tpu_torch/ops/decode_attention.py, kernels 11 and 12) with the JAX
package's Pallas kernels, on the CPU.

On the CPU the port's wrappers compute their plain versions; JAX's kernels
run in interpret mode, as its own tests run them (JAX's K^T layout is the
transpose of the port's natural K). L = 100 is no multiple of 128, so JAX
pads the keys and masks them with -1e9. Tolerances: fp32 2e-5 (JAX's own
test against its XLA reference); bf16 outputs within one bf16 ulp of each
other (1e-2 relative + 1e-2 absolute): both sides round p to bf16 at the
same point, but exp2 and the sums run in another order, so a rounding can
flip. The tiny per-layer decoder with the kernel switch on is held to JAX's
decoder with its Pallas path on: fp32 logits to 2e-4, bf16 to 0.15, as
tests/test_torch_fused_decode.py holds the fused path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prismer_tpu.models.roberta as jax_rb
from prismer_tpu.ops.decode_attention import (grouped_cross_attention_t,
                                              grouped_decode_attention)
from prismer_tpu_torch.models import roberta as port_rb
from prismer_tpu_torch.ops import decode_attention as da
from tests.test_fused_decode import _run_steps
from tests.test_torch_fused_decode import (K, L_ENC, decoder_pair,
                                           _port_run_steps)
from tests.test_torch_model import to_jax

torch.set_num_threads(2)

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
TOLS = {jnp.float32: 2e-5, jnp.bfloat16: 1e-2}


def _inputs(nq, dtype, b=2, h=3, l=100, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32)
               for n in (nq, l, l))
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        TORCH_DTYPES[dtype]) for x in (jq, jk, jv))
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("nq", [3, 12])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cross_t_matches_jax_kernel(nq, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(nq, dtype)
    want = grouped_cross_attention_t(jq, jk.transpose(0, 1, 3, 2), jv,
                                     interpret=True)
    got = da.grouped_cross_attention(tq, tk, tv, "cross_t")
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.parametrize("nq", [3, 12])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_mode_matches_jax_kernel(nq, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(nq, dtype, seed=1)
    want = grouped_decode_attention(jq, jk, jv, interpret=True)
    got = da.grouped_decode_attention(tq, tk, tv)
    np.testing.assert_array_equal(
        got.float().numpy(),
        da.grouped_cross_attention(tq, tk, tv, "decode").float().numpy())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


def test_modes_round_where_jax_does():
    """cross_t rounds the unnormalised p to bf16 before PV; decode keeps p
    in fp32. On the same bf16 inputs the two differ, and each matches its
    JAX kernel more closely than the other mode does."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(3, jnp.bfloat16, seed=2)
    want_t = np.asarray(grouped_cross_attention_t(
        jq, jk.transpose(0, 1, 3, 2), jv, interpret=True).astype(jnp.float32))
    got_t = da.grouped_cross_attention(tq, tk, tv, "cross_t").float().numpy()
    got_d = da.grouped_decode_attention(tq, tk, tv).float().numpy()
    assert not np.array_equal(got_t, got_d)
    assert np.abs(got_t - want_t).sum() < np.abs(got_d - want_t).sum()


def test_wrappers_check_shapes_and_count_no_cpu_launch():
    _, (tq, tk, tv) = _inputs(3, jnp.float32)
    with pytest.raises(ValueError):
        da.grouped_cross_attention(tq, tk[:, :, :, :32], tv, "cross_t")
    with pytest.raises(ValueError):
        da.grouped_cross_attention(tq, tk, tv, "exact")
    before = (da.grouped_cross_attention.launches,
              da.grouped_decode_attention.launches)
    da.grouped_cross_attention(tq, tk, tv)
    da.grouped_decode_attention(tq, tk, tv)
    assert (da.grouped_cross_attention.launches,
            da.grouped_decode_attention.launches) == before


def test_decode_cross_switch():
    assert port_rb._DECODE_CROSS == "matmul"
    with pytest.raises(ValueError):
        port_rb.set_decode_cross("pallas")


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-4),
                                       (jnp.bfloat16, 0.15)])
def test_per_layer_decoder_with_kernel_matches_jax_pallas_path(
        dtype, tol, monkeypatch):
    """init_cache + 2 per-layer decode steps, prompt with a pad hole: the
    port with set_decode_cross("kernel") against JAX with
    DECODE_CROSS_IMPL = "pallas" (bound at JAX's import, so set on the
    module). The port's cross-attention runs the plain cross_t version in
    the prefill and every step (2 layers x 3 calls)."""
    dec, variables, port = decoder_pair(dtype)
    rng = np.random.default_rng(0)
    b, p = 2, 4
    ids = rng.integers(4, 120, (b, p)).astype(np.int32)
    enc = rng.standard_normal((b, L_ENC, 48)).astype(np.float32)
    prompt_mask = np.ones((b, p), np.int32)
    prompt_mask[1, 2] = 0
    ids_tiled, mask_tiled = np.repeat(ids, K, 0), np.repeat(prompt_mask, K, 0)

    monkeypatch.setattr(jax_rb, "DECODE_CROSS_IMPL", "pallas")
    calls = []
    real = da.grouped_attention_reference

    def counting(q, k, v, mode):
        calls.append((mode, tuple(q.shape)))
        return real(q, k, v, mode)

    monkeypatch.setattr(da, "grouped_attention_reference", counting)
    jax_rb.set_fused_decode("off")
    port_rb.set_fused_decode("off")
    port_rb.set_decode_cross("kernel")
    try:
        want, _ = _run_steps(dec, to_jax(variables), jnp.asarray(enc),
                             jnp.asarray(ids_tiled), jnp.asarray(mask_tiled),
                             jnp.asarray(prompt_mask), n_steps=2)
        got, cache = _port_run_steps(port, enc, ids_tiled, mask_tiled,
                                     prompt_mask, n_steps=2)
    finally:
        port_rb.set_decode_cross("matmul")
        port_rb.set_fused_decode("auto")
        jax_rb.set_fused_decode("auto")
    assert "w_all" not in cache
    assert len(calls) == 2 * 3 and {m for m, _ in calls} == {"cross_t"}
    assert calls[0][1] == (b, 4, K * p, 16) and calls[-1][1] == (b, 4, K, 16)
    for s, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=tol,
                                   rtol=0, err_msg=f"step {s}")
