"""Parity of the port's fused decode path (prismer_tpu_torch) with the JAX
package's, on the CPU.

On the CPU the port's `fused_decode_step` computes its plain version; the JAX
`fused_decode_step` runs its Pallas kernel in interpret mode, as the JAX
package's own tests run it. Inputs and weights come from numpy seeds.
Tolerances are the ones the JAX tests hold the TPU kernel to
(tests/test_fused_decode.py): 2e-4 in fp32 and 0.15 in bf16, where the TPU
kernel rounds its self-attention q*k products to bf16 before the head sum.
The beam reorder is a copy, so permuted caches must agree exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.models import roberta as jax_rb
from prismer_tpu.models.caption import build_generate_fn
from prismer_tpu.models.prismer import prepare_serving_variables
from prismer_tpu.models.roberta import RobertaCausalDecoder
from prismer_tpu.ops.fused_decode import \
    fused_decode_step as jax_fused_decode_step
from prismer_tpu_torch import config as port_config
from prismer_tpu_torch.convert.from_jax import load_jax_variables
from prismer_tpu_torch.models import roberta as port_rb
from prismer_tpu_torch.models.caption import \
    build_generate_fn as port_build_generate_fn
from prismer_tpu_torch.models.prismer import Prismer as PortPrismer
from prismer_tpu_torch.models.prismer import \
    prepare_serving_variables as port_prepare_serving
from prismer_tpu_torch.ops import fused_decode as fd
from prismer_tpu_torch.ops.fused_decode import (NEG_INF, fused_decode_step,
                                                layer_views,
                                                pack_decode_weights)
from tests.test_fused_decode import decoder_cfg
from tests.test_torch_model import (build_pair, instance_slots, prompt_batch,
                                    raw_batch, seeded_variables, task_config,
                                    to_jax, to_torch)

torch.set_num_threads(2)

B, K, P, T, L_ENC = 2, 3, 4, 12, 40
N = B * K
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    jax_rb.set_fused_decode("auto")
    port_rb.set_fused_decode("auto")


def decoder_pair(dtype, seed=0):
    """(jax decoder, numpy variables, port decoder) on one set of
    numpy-seeded weights (biases and LN parameters non-trivial)."""
    cfg = decoder_cfg()
    dec = RobertaCausalDecoder(cfg, dtype=dtype)
    ids = jnp.ones((B, P), jnp.int32)
    shapes = jax.eval_shape(dec.init, jax.random.key(0), ids, ids,
                            jnp.ones((B, L_ENC, cfg.vision_hidden_size)))
    variables = seeded_variables(shapes, seed)
    port_cfg = port_config.TextDecoderConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    port = port_rb.RobertaCausalDecoder(port_cfg, TORCH_DTYPES[dtype])
    load_jax_variables(port, variables)
    return dec, variables, port.eval()


def test_packed_layout_holds_every_weight():
    """pack_decode_weights lays each Dense as (out, in) and each bias / LN
    parameter at its `layer_layout` offset; the output layer has no cross
    slots."""
    _, _, port = decoder_pair(jnp.float32)
    w_all, b_all = pack_decode_weights(port, torch.float32)
    d, f = 64, 128
    views = layer_views(w_all, b_all, d, f, 2)
    assert len(views) == 3 and "w_cross_q" not in views[2]
    l1 = port.layers_1
    torch.testing.assert_close(views[1]["w_qkv"][d:2 * d],
                               l1.self_attn.key.weight, rtol=0, atol=0)
    torch.testing.assert_close(views[1]["w_mlp_out"], l1.mlp.out.dense.weight,
                               rtol=0, atol=0)
    torch.testing.assert_close(views[1]["b_ln_ad"][d:],
                               l1.adaptor.adaptor_ln.bias, rtol=0, atol=0)
    torch.testing.assert_close(views[2]["b_ln3"][:d],
                               port.output_layer.mlp.out.ln.weight, rtol=0,
                               atol=0)


def _jax_cross_layout(k_nat, v_nat, heads):
    """Natural (NLc, B, L, D) K/V -> the JAX kernel's (NLc, B, Dh, H*Lp)
    K^T and (NLc, B, Lp, D) V, L zero-padded to 128 lanes."""
    nlc, b, l_enc, d = k_nat.shape
    dh, lp = d // heads, 128
    k4 = np.zeros((nlc, b, lp, heads, dh), k_nat.dtype)
    k4[:, :, :l_enc] = k_nat.reshape(nlc, b, l_enc, heads, dh)
    kd = k4.transpose(0, 1, 4, 3, 2).reshape(nlc, b, dh, heads * lp)
    vc = np.zeros((nlc, b, lp, d), v_nat.dtype)
    vc[:, :, :l_enc] = v_nat
    return kd, vc


@pytest.mark.parametrize("permute", [False, True])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-4),
                                       (jnp.bfloat16, 0.15)])
def test_fused_step_matches_jax(dtype, tol, permute):
    dec, variables, port = decoder_pair(dtype)
    cfg = decoder_cfg()
    d, heads, nl = cfg.hidden_size, cfg.num_attention_heads, 3
    rng = np.random.default_rng(1)
    f32 = np.float32
    hidden0 = rng.standard_normal((N, d)).astype(f32)
    self_k = rng.standard_normal((nl, T, N, d)).astype(f32)
    self_v = rng.standard_normal((nl, T, N, d)).astype(f32)
    cross_k = rng.standard_normal((nl - 1, B, L_ENC, d)).astype(f32)
    cross_v = rng.standard_normal((nl - 1, B, L_ENC, d)).astype(f32)
    index = P + 2
    key_mask = np.zeros((N, T), np.int32)
    key_mask[:, :index + 1] = 1
    key_mask[K:2 * K, 2] = 0                         # a pad hole in sample 1
    flat_beam = (rng.integers(0, K, (B, K)) + np.arange(B)[:, None] * K
                 ).reshape(-1).astype(np.int32)

    # JAX: packed weights, lane-padded cross layout, the stale column at
    # `index` masked through bias_tn
    jd = lambda x: jnp.asarray(x).astype(dtype)  # noqa: E731
    packed = jax_rb.pack_decode_collection(variables["params"], cfg, dtype)
    kd, vc = _jax_cross_layout(cross_k, cross_v, heads)
    excl = np.arange(T)[:, None] != index
    bias_tn = np.where((key_mask.T > 0) & excl, 0.0, NEG_INF).astype(f32)
    step = jax.jit(functools.partial(jax_fused_decode_step, heads=heads,
                                     beams=K, valid_len=L_ENC))
    want = step(jd(hidden0), packed["w_head"], packed["w_tail"],
                packed["b_all"], jd(self_k), jd(self_v), jnp.asarray(bias_tn),
                jd(kd), jd(vc),
                flat_beam=jnp.asarray(flat_beam) if permute else None)
    want = [np.asarray(x.astype(jnp.float32)) for x in want]

    tdt = TORCH_DTYPES[dtype]
    td = lambda x: torch.from_numpy(x).to(tdt)  # noqa: E731
    w_all, b_all = pack_decode_weights(port, tdt)
    sk, sv = td(self_k), td(self_v)
    sk0 = sk.clone()
    got = fused_decode_step(
        td(hidden0), w_all, b_all, sk, sv, torch.from_numpy(key_mask),
        td(cross_k), td(cross_v), index,
        torch.from_numpy(flat_beam) if permute else None, heads=heads,
        eps=cfg.layer_norm_eps)
    hidden_out, k_new, v_new, ck, cv = (x.float().numpy() for x in got)
    for name, g, w in (("hidden_out", hidden_out, want[0]),
                       ("k_new", k_new, want[1]), ("v_new", v_new, want[2])):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)

    # the caches: every column but `index` is an exact copy (permuted or
    # not), and column `index` holds this step's k_new / v_new exactly
    others = np.arange(T) != index
    if permute:
        np.testing.assert_array_equal(ck[:, others], want[3][:, others])
        np.testing.assert_array_equal(cv[:, others], want[4][:, others])
        np.testing.assert_array_equal(
            ck[:, others], sk0.float().numpy()[:, others][:, :, flat_beam])
        assert got[3] is not sk
    else:
        assert got[3] is sk and got[4] is sv    # written in place
        np.testing.assert_array_equal(ck[:, others],
                                      sk0.float().numpy()[:, others])
    np.testing.assert_array_equal(ck[:, index], k_new)
    np.testing.assert_array_equal(cv[:, index], v_new)


def test_fused_step_rejects_bad_buffers():
    """The reorder cannot run in place, and shapes that do not fit the
    packed weights are refused."""
    _, _, port = decoder_pair(jnp.float32)
    w_all, b_all = pack_decode_weights(port, torch.float32)
    h0 = torch.zeros(N, 64)
    sk, sv = torch.zeros(3, T, N, 64), torch.zeros(3, T, N, 64)
    ck = torch.zeros(2, B, L_ENC, 64)
    km = torch.ones(N, T, dtype=torch.int32)
    fb = torch.arange(N, dtype=torch.int32)
    with pytest.raises(ValueError, match="in place"):
        fused_decode_step(h0, w_all, b_all, sk, sv, km, ck, ck, 0, fb, sk,
                          sv, heads=4)
    with pytest.raises(ValueError):
        fused_decode_step(h0, w_all[:-1], b_all, sk, sv, km, ck, ck, 0,
                          heads=4)
    with pytest.raises(ValueError):
        fused_decode_step(h0, w_all, b_all, sk, sv, km, ck, ck, T, heads=4)


@pytest.mark.parametrize("model", ["prismer_base", "prismer_large",
                                   "prismer_huge"])
def test_dense_plan_fits_every_registry_decoder(model):
    """The bf16 projection's launch shape (`dense_plan`, the C entry's
    plan mirrored) for every decoder matrix of the registry models at the
    served row counts: clusters of at most 8 blocks whose K slices cover K
    exactly once, shared memory within the budget that keeps one block of
    the next launch resident beside one of the running launch, and the
    step's launch count."""
    cfg = port_config.build_prismer_config(
        {"experts": port_config.CAPTION_EXPERTS, "image_resolution": 480,
         "prismer_model": model}).decoder
    d, f = cfg.hidden_size, cfg.intermediate_size
    assert (d, f) == {"prismer_base": (768, 3072)}.get(model, (1024, 4096))
    for m, k in ((3 * d, d), (d, d), (f, d), (d, f)):
        for n in (3, 15, 24, 48):
            plan = fd.dense_plan(m, k, n)
            assert 1 <= plan.split <= fd.PROJ_MAX_SPLIT
            assert plan.col_tiles * fd.PROJ_TILE >= m
            assert plan.rows >= min(n, 64) and plan.rows % 8 == 0
            assert plan.rows * plan.row_tiles >= n
            slices = [range(r * plan.k_tiles // plan.split,
                            (r + 1) * plan.k_tiles // plan.split)
                      for r in range(plan.split)]
            assert [t for sl in slices for t in sl] == list(
                range(plan.k_tiles))
            assert all(0 < len(sl) <= plan.slice for sl in slices)
            assert plan.k_tiles * fd.PROJ_TILE >= k
            assert 2 <= plan.stages <= min(plan.slice, fd.PROJ_MAX_STAGES) \
                or plan.stages == plan.slice == 1
            assert plan.smem_bytes <= fd.PROJ_SMEM_BUDGET
            assert 2 * (plan.smem_bytes + 1024) <= fd.SM_SMEM
    assert fd.step_launches(cfg.num_hidden_layers) == {
        "prismer_base": 126}.get(model, 246)
    if model == "prismer_base":
        # N 24: the D x D projections take 12 column tiles in clusters of
        # 8 (1 or 2 of the 12 k tiles a block, both in flight), the qkv 36
        # in clusters of 4, W1 48, W2 12 in clusters of 8 (6 k tiles a
        # block, all in flight); each block's ring, input slice (24 rows),
        # partials, bias and LN parameters, LN statistics, barriers and
        # alignment slack
        assert fd.dense_plan(d, d, 24) == (12, 24, 1, 12, 8, 2, 2, 31184)
        assert fd.dense_plan(3 * d, d, 24) == (36, 24, 1, 12, 4, 3, 3,
                                               42968)
        assert fd.dense_plan(f, d, 24) == (48, 24, 1, 12, 4, 3, 3, 42968)
        assert fd.dense_plan(d, f, 24) == (12, 24, 1, 48, 8, 6, 6, 78320)
        assert fd.dense_plan(d, d, 24).smem_bytes == (
            2 * 8192 + 2 * 24 * 128 + 64 * 24 * 4 + 64 * 4 + 2 * 2 * 64 * 4
            + 24 * 8 + 2 * 8 + 1024)
        # past 64 rows, row tiles of 64
        assert fd.dense_plan(d, d, 96)[1:3] == (64, 2)


def _port_run_steps(port, enc, ids_tiled, mask_tiled, prompt_mask,
                    n_steps=4, seed=7):
    """tests/test_fused_decode.py _run_steps on the port."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        logits, cache = port.init_cache(
            torch.from_numpy(ids_tiled), torch.from_numpy(mask_tiled),
            torch.from_numpy(enc), T, K)
    outs = [logits.numpy()]
    nonpad = prompt_mask.sum(1)
    positions = np.arange(T)[None, :]
    for s in range(n_steps):
        index = P + s
        tokens = rng.integers(4, 120, (N,)).astype(np.int32)
        pos = np.repeat(nonpad + s + 2, K).astype(np.int32)
        key_mask_b = np.where(positions < P,
                              np.pad(prompt_mask, ((0, 0), (0, T - P))),
                              (positions <= index).astype(np.int32))
        key_mask = np.repeat(key_mask_b, K, axis=0)
        with torch.no_grad():
            logits, cache = port.decode_step(
                torch.from_numpy(tokens), index, torch.from_numpy(pos),
                torch.from_numpy(key_mask), cache, K)
        outs.append(logits.numpy())
    return outs, cache


def test_fused_cache_and_steps_match_jax_and_per_layer_path():
    """init_cache + 4 decode steps, prompt with a pad hole, fp32: the port's
    fused path against JAX's fused path and against the port's per-layer
    path, logits to 2e-4."""
    from tests.test_fused_decode import _run_steps
    dec, variables, port = decoder_pair(jnp.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 120, (B, P)).astype(np.int32)
    enc = rng.standard_normal((B, L_ENC, 48)).astype(np.float32)
    prompt_mask = np.ones((B, P), np.int32)
    prompt_mask[1, 2] = 0
    ids_tiled, mask_tiled = np.repeat(ids, K, 0), np.repeat(prompt_mask, K, 0)

    jax_rb.set_fused_decode("on")
    want, jcache = _run_steps(dec, to_jax(variables), jnp.asarray(enc),
                              jnp.asarray(ids_tiled), jnp.asarray(mask_tiled),
                              jnp.asarray(prompt_mask))
    assert "w_head" in jcache
    port_rb.set_fused_decode("on")
    fused, cache = _port_run_steps(port, enc, ids_tiled, mask_tiled,
                                   prompt_mask)
    assert "w_all" in cache and cache["self_k_tn"].shape == (3, T, N, 64)
    assert cache["cross_k"].shape == (2, B, L_ENC, 64)  # per sample
    port_rb.set_fused_decode("off")
    per_layer, cache = _port_run_steps(port, enc, ids_tiled, mask_tiled,
                                       prompt_mask)
    assert "self_kt" not in cache and "w_all" not in cache
    for s, (w, f, p) in enumerate(zip(want, fused, per_layer)):
        np.testing.assert_allclose(f, np.asarray(w), atol=2e-4, rtol=0,
                                   err_msg=f"step {s} vs JAX")
        np.testing.assert_allclose(f, p, atol=2e-4, rtol=0,
                                   err_msg=f"step {s} vs per-layer")


def test_fused_decode_mode_switch():
    """'auto' is on for CUDA and off on the CPU; 'on'/'off' force it;
    serving state is built only where fused decode is in use."""
    assert port_rb.use_fused_decode(torch.device("cuda"))
    assert not port_rb.use_fused_decode(torch.device("cpu"))
    port = PortPrismer(port_config.build_prismer_config(task_config()))
    assert port_prepare_serving(port) is None
    port_rb.set_fused_decode("on")
    assert port_rb.use_fused_decode("cpu")
    serving = port_prepare_serving(port)
    assert set(serving) == {"w_all", "b_all", "emb", "lm_bias"}
    assert serving["emb"].shape == (512, 64)
    assert serving["lm_bias"].dtype == torch.float32
    port_rb.set_fused_decode("off")
    assert not port_rb.use_fused_decode("cuda")
    with pytest.raises(ValueError):
        port_rb.set_fused_decode("yes")


# ---------------------------------------------------------------------------
# the slice: build_generate_fn with fused decode and lm_topk on both sides
# ---------------------------------------------------------------------------

SEEDS = (11, 12, 13)


@pytest.fixture(scope="module")
def fused_pair():
    jax_rb.set_fused_decode("on")
    port_rb.set_fused_decode("on")
    model, variables, port = build_pair()
    yield model, variables, port, build_generate_fn(model)
    jax_rb.set_fused_decode("auto")
    port_rb.set_fused_decode("auto")


def _generate_both(fused_pair, variables, port, seed):
    model, _, _, jax_generate = fused_pair
    jax_rb.set_fused_decode("on")
    port_rb.set_fused_decode("on")
    serving = prepare_serving_variables(model, variables)
    assert "emb_tp" in serving["packed_decode"]["text_decoder"]
    raw = raw_batch(seed)
    ids, mask = prompt_batch(seed)
    want = np.asarray(jax_generate(serving, to_jax(raw), ids, mask))
    got = port_build_generate_fn(port)(
        to_torch(raw), torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(instance_slots()))
    return want, got


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_generate_matches_jax_exactly(fused_pair, seed, monkeypatch):
    from prismer_tpu_torch.ops import fused_decode, lm_topk
    calls = {"fused": 0, "lm_topk": 0}
    real_step, real_topk = fused_decode.fused_decode_step_reference, \
        lm_topk.lm_topk_reference

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fused_decode, "fused_decode_step_reference",
                        count("fused", real_step))
    monkeypatch.setattr(lm_topk, "lm_topk_reference",
                        count("lm_topk", real_topk))
    _, variables, port, _ = fused_pair
    want, got = _generate_both(fused_pair, variables, port, seed)
    assert got.dtype == torch.int64 and got.shape == (2, 20)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port really took the fused path with lm_topk
    assert calls["fused"] > 0 and calls["lm_topk"] == calls["fused"]


def test_fused_generate_with_eos_matches_jax(fused_pair):
    """A raised EOS bias retires beams at different steps per sample."""
    _, variables, _, _ = fused_pair
    params = jax.tree.map(np.array, variables)
    params["params"]["text_decoder"]["lm_head"]["bias"][2] += 0.6
    port = PortPrismer(port_config.build_prismer_config(task_config()))
    load_jax_variables(port, params)
    want, got = _generate_both(fused_pair, to_jax(params), port.eval(),
                               SEEDS[0])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 2).sum() == 2 and want[0, -1] == want[1, -1] == 1
