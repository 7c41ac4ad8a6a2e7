"""Parity of the port's beam-grouped decode cross-attention
(prismer_tpu_torch/ops/decode_attention.py, kernels 11 and 12) with the JAX
package's Pallas kernels, on the CPU, at the model's shapes and at the
CUDA kernel's split edges (fewer keys than the blocks of a cluster, a
64-key tile across a block's range end, one and several 16-row query
passes); and the kernel's split plan and the K/V layouts its TMA loads
take, which are pure Python.

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
from prismer_tpu_torch import config as port_config
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


# the kernel's split edges as (L, Q): L 1 and 7 leave blocks of the
# cluster without keys (7 with 4 blocks: the last holds one key), L 65 puts
# a 64-key tile across a range end; Q 1 and 16 take one 16-row pass, 17 and
# 64 several
EDGES = [(1, 3), (7, 3), (65, 3), (100, 1), (100, 16), (100, 17), (100, 64)]


@pytest.mark.parametrize("l,nq", EDGES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cross_t_edge_shapes_match_jax_kernel(l, nq, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(nq, dtype, l=l, seed=3)
    want = grouped_cross_attention_t(jq, jk.transpose(0, 1, 3, 2), jv,
                                     interpret=True)
    got = da.grouped_cross_attention(tq, tk, tv, "cross_t")
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.parametrize("l,nq", EDGES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_mode_edge_shapes_match_jax_kernel(l, nq, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(nq, dtype, l=l, seed=4)
    want = grouped_decode_attention(jq, jk, jv, interpret=True)
    got = da.grouped_decode_attention(tq, tk, tv)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


SPLIT_SIZES = [1, 7, 64, 65, 640, 964, 1220]


@pytest.mark.parametrize("splits", SPLIT_SIZES)
@pytest.mark.parametrize("length", SPLIT_SIZES)
def test_split_ranges_cover_the_keys_in_order(length, splits):
    ranges = da.split_ranges(length, splits)
    assert len(ranges) == splits
    per = -(-length // splits)
    pos = 0
    for start, end in ranges:
        assert start == pos and start <= end <= length
        assert end - start <= per
        pos = end
    assert pos == length
    assert sum(end - start for start, end in ranges) == length


# every registry decoder's cross-attention at the resolution it is served
# at: BASE and HUGE 480 px, LARGE 336 px
REGISTRY = (("prismer_base", 480), ("prismer_large", 336),
            ("prismer_huge", 480))


@pytest.mark.parametrize("model,px", REGISTRY)
def test_split_plan_fits_every_registry_shape(model, px):
    cfg = port_config.build_prismer_config(
        {"experts": port_config.CAPTION_EXPERTS, "image_resolution": px,
         "prismer_model": model})
    length = cfg.vision.num_output_tokens
    assert length == {"prismer_base": 964, "prismer_large": 640,
                      "prismer_huge": 1220}[model]
    assert cfg.decoder.head_dim == da.KERNEL_HEAD_DIM
    for nq in (3, 12, 64):
        for dtype in (torch.float32, torch.bfloat16):
            for mode in da.MODES:
                plan = da.split_plan(length, nq, dtype, mode)
                assert plan.splits == da.SPLITS == 4
                assert plan.keys_per_block == -(-length // 4)
                assert plan.tiles * da.TILE_KEYS >= plan.keys_per_block
                assert plan.smem_bytes <= da.MAX_SMEM
    # BASE's decode step in bf16 (one pass): four tiles of K, which V
    # replaces once the scores are in registers, the row statistics, the
    # slots the 4 blocks' 4 warps store into (3 rows of 16 columns, the sums
    # of 4 rows), eight tile barriers, the slack: six blocks fit an SM's
    # 228 KB, more than the 384 blocks of batch 8 (H 12) need to run at once
    # on the 132 SMs
    if model == "prismer_base":
        plan = da.split_plan(964, 3, torch.bfloat16, "cross_t")
        assert plan == (4, 241, 4, 4 * 8192 + 384
                        + 16 * (3 * 16 + 4) * 4 + 8 * 8 + 1024)
        assert 6 * (plan.smem_bytes + 1024) <= 228 * 1024
        # several passes keep K and V both
        assert (da.split_plan(964, 17, torch.bfloat16, "cross_t").smem_bytes
                > 8 * 8192)


def test_split_plan_raises_past_the_limits():
    # fp32 with two passes (Q 17): 6 tiles of K and V are 192 KB, and the
    # scores and slots of 16 query rows pass 227 KB; one pass keeps K's
    # room only (V takes its place), so 8 tiles fit
    with pytest.raises(ValueError, match="bytes of shared memory"):
        da.split_plan(da.SPLITS * 6 * 64, 17, torch.float32, "cross_t")
    da.split_plan(da.SPLITS * 5 * 64, 17, torch.float32, "cross_t")
    da.split_plan(da.SPLITS * 8 * 64, 16, torch.float32, "cross_t")
    # bf16: at most 8 tiles of 64 keys a block
    da.split_plan(da.SPLITS * 8 * 64, 64, torch.bfloat16, "cross_t")
    with pytest.raises(ValueError, match="at most 8 tiles"):
        da.split_plan(da.SPLITS * 8 * 64 + 1, 3, torch.bfloat16, "cross_t")
    for bad in ((0, 3), (100, 0), (100, 65)):
        with pytest.raises(ValueError):
            da.split_plan(*bad, torch.bfloat16, "cross_t")
    with pytest.raises(ValueError):
        da.split_plan(100, 3, torch.float16, "cross_t")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tma_layout_takes_head_split_views_and_refuses_others(dtype):
    b, l, h = 2, 100, 12
    nat = torch.zeros(b, l, h * 64, dtype=dtype)
    view = nat.view(b, l, h, 64).permute(0, 2, 1, 3)   # the prefill's K/V
    assert not view.is_contiguous() and da.tma_layout_ok(view)
    assert da.tma_layout_ok(view.contiguous())
    wide = torch.zeros(b, h, l, 72, dtype=dtype)
    assert da.tma_layout_ok(wide[..., :64])             # rows 144 / 288 B
    assert not da.tma_layout_ok(wide[..., 2:66])        # base off 16 bytes
    assert not da.tma_layout_ok(torch.zeros(b, h, l, 66, dtype=dtype)[
        ..., :64])                                       # rows of 66
    assert not da.tma_layout_ok(view.transpose(-1, -2))  # Dh not unit


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
        calls.append((mode, tuple(q.shape), k.stride(), v.stride()))
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
    assert len(calls) == 2 * 3 and {c[0] for c in calls} == {"cross_t"}
    assert calls[0][1] == (b, 4, K * p, 16) and calls[-1][1] == (b, 4, K, 16)
    # the prefill passes the head-split views of the projected (B, L, D)
    # K/V as they are (no copy), strides the kernel's TMA loads take; the
    # steps pass the per-layer cache
    d = 4 * 16
    for _, _, ks, vs in calls[:2]:
        assert ks == vs == (L_ENC * d, 16, d, 1)
    for _, _, ks, vs in calls[2:]:
        assert ks == vs == (4 * L_ENC * 16, L_ENC * 16, 16, 1)
    for s, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=tol,
                                   rtol=0, err_msg=f"step {s}")
