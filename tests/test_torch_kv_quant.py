"""Parity of the port's int8 cross-KV fused decode (kernel 4b,
`models.roberta.set_kv_quant("int8")`) with the JAX package's, on the CPU.

On the CPU the port's `fused_decode_step` computes its plain version; JAX's
runs its Pallas kernel in interpret mode with `quant=True`. The quantizer
must be bit-exact: the same int8 values and fp32 scales as JAX's
`quantize_kv_nat`, round half to even included. The step is held to JAX's
on the same int8 inputs by the tolerances of tests/test_torch_fused_decode
(2e-4 fp32, 0.15 bf16). Over init_cache + 2 steps each side quantizes its
own cross K/V: the fp32 projections differ at the last bit, which can move
a value across a rounding boundary and change one int8 step (1/127 of its
head's range), so the fp32 logits are held to 1e-3 there; bf16 to 0.15.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.models import roberta as jax_rb
from prismer_tpu.ops.fused_decode import _scale_lanes
from prismer_tpu.ops.fused_decode import \
    fused_decode_step as jax_fused_decode_step
from prismer_tpu.ops.fused_decode import quantize_kv_nat
from prismer_tpu_torch.models import roberta as port_rb
from prismer_tpu_torch.models.caption import \
    build_generate_fn as port_build_generate_fn
from prismer_tpu_torch.models.generation import beam_search
from prismer_tpu_torch.models.prismer import build_random_prismer
from prismer_tpu_torch.ops.fused_decode import (NEG_INF, fused_decode_step,
                                                pack_decode_weights,
                                                quantize_kv)
from prismer_tpu_torch import config as port_config
from tests.test_fused_decode import _run_steps, decoder_cfg
from tests.test_torch_fused_decode import (B, K, L_ENC, N, P, T,
                                           _jax_cross_layout, _port_run_steps,
                                           decoder_pair)
from tests.test_torch_model import (prompt_batch, raw_batch, task_config,
                                    to_jax, to_torch)

torch.set_num_threads(2)

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(autouse=True)
def _reset_modes():
    try:
        yield
    finally:
        jax_rb.set_fused_decode("auto")
        jax_rb.set_kv_quant("off")
        port_rb.set_fused_decode("auto")
        port_rb.set_kv_quant("off")


def _half_steps(seed, b=2, l=40, heads=4, dh=16):
    """(B, L, H*Dh) fp32 values whose head amax is 127 / 8, so the scale is
    exactly 1/8, and whose other values sit on k/8 + 1/16: x / scale lands
    on exact .5 steps (both signs), which round half to even."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-120, 120, (b, l, heads, dh))
    x = (k / 8.0 + np.where(rng.random(k.shape) < 0.5, 1, -1) / 16.0)
    x[:, 0, :, 0] = 127 / 8.0
    return x.reshape(b, l, heads * dh).astype(np.float32)


@pytest.mark.parametrize("case", ["half_steps", "random", "bf16"])
def test_quantizer_bit_exact_against_jax(case):
    heads = 4
    if case == "half_steps":
        x = _half_steps(0)
    else:
        x = (np.random.default_rng(1).standard_normal((2, 40, 64)) * 3
             ).astype(np.float32)
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if case == "bf16":
        jx = jx.astype(jnp.bfloat16)
        tx = tx.to(torch.bfloat16)
    b, l, d = x.shape
    jq, js = quantize_kv_nat(jx.reshape(b, l, heads, d // heads))
    q, s = quantize_kv(tx, heads)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (b, heads)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).reshape(b, l, d))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if case == "half_steps":
        assert (s.numpy() == 1 / 8).all()
        halves = np.abs(x * 8 - np.round(x * 8)) == 0.5
        assert halves.mean() > 0.9
        # round half to even: every .5 step went to the even neighbour
        assert (q.numpy()[halves] % 2 == 0).all()


@pytest.mark.parametrize("permute", [False, True])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-4),
                                       (jnp.bfloat16, 0.15)])
def test_int8_step_matches_jax_kernel(dtype, tol, permute):
    """One step on the same int8 cross K/V and scales: the port's plain
    int8 step against JAX's interpret-mode kernel with quant=True."""
    dec, variables, port = decoder_pair(dtype)
    cfg = decoder_cfg()
    d, heads, nl = cfg.hidden_size, cfg.num_attention_heads, 3
    rng = np.random.default_rng(2)
    f32 = np.float32
    hidden0 = rng.standard_normal((N, d)).astype(f32)
    self_k = rng.standard_normal((nl, T, N, d)).astype(f32)
    self_v = rng.standard_normal((nl, T, N, d)).astype(f32)
    cross = {n: rng.standard_normal((nl - 1, B, L_ENC, d)).astype(f32)
             for n in ("k", "v")}
    index = P + 2
    key_mask = np.zeros((N, T), np.int32)
    key_mask[:, :index + 1] = 1
    key_mask[K:2 * K, 2] = 0
    flat_beam = (rng.integers(0, K, (B, K)) + np.arange(B)[:, None] * K
                 ).reshape(-1).astype(np.int32)
    tdt = TORCH_DTYPES[dtype]
    q8, scales = {}, {}
    for n, x in cross.items():
        pairs = [quantize_kv(torch.from_numpy(x[i]).to(tdt), heads)
                 for i in range(nl - 1)]
        q8[n] = torch.stack([q for q, _ in pairs])
        scales[n] = torch.stack([s for _, s in pairs])

    jd = lambda x: jnp.asarray(x).astype(dtype)  # noqa: E731
    packed = jax_rb.pack_decode_collection(variables["params"], cfg, dtype)
    kd, vc = _jax_cross_layout(q8["k"].numpy(), q8["v"].numpy(), heads)
    lanes = [jnp.stack([_scale_lanes(jnp.asarray(s[i].numpy()))
                        for i in range(nl - 1)]) for s in (scales["k"],
                                                           scales["v"])]
    excl = np.arange(T)[:, None] != index
    bias_tn = np.where((key_mask.T > 0) & excl, 0.0, NEG_INF).astype(f32)
    step = jax.jit(functools.partial(jax_fused_decode_step, heads=heads,
                                     beams=K, valid_len=L_ENC))
    want = step(jd(hidden0), packed["w_head"], packed["w_tail"],
                packed["b_all"], jd(self_k), jd(self_v), jnp.asarray(bias_tn),
                jnp.asarray(kd), jnp.asarray(vc), *lanes,
                flat_beam=jnp.asarray(flat_beam) if permute else None)
    want = [np.asarray(x.astype(jnp.float32)) for x in want]

    td = lambda x: torch.from_numpy(x).to(tdt)  # noqa: E731
    w_all, b_all = pack_decode_weights(port, tdt)
    got = fused_decode_step(
        td(hidden0), w_all, b_all, td(self_k), td(self_v),
        torch.from_numpy(key_mask), q8["k"], q8["v"], index,
        torch.from_numpy(flat_beam) if permute else None, heads=heads,
        eps=cfg.layer_norm_eps, cross_ks=scales["k"], cross_vs=scales["v"])
    for name, g, w in zip(("hidden_out", "k_new", "v_new"), got[:3], want):
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol, rtol=tol,
                                   err_msg=name)
    # the scales take part: the same step on unit scales differs
    ones = torch.ones_like(scales["k"])
    other = fused_decode_step(
        td(hidden0), w_all, b_all, td(self_k), td(self_v),
        torch.from_numpy(key_mask), q8["k"], q8["v"], index, heads=heads,
        eps=cfg.layer_norm_eps, cross_ks=ones, cross_vs=ones)
    assert not torch.equal(other[0], got[0])


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-3),
                                       (jnp.bfloat16, 0.15)])
def test_int8_decoder_steps_match_jax(dtype, tol):
    """init_cache + 2 fused decode steps with int8 cross K/V on both sides
    (set_fused_decode("on") + set_kv_quant("int8")): the logits, and the
    port's cache holds int8 (NLc, B, L, D) values and (NLc, B, H) scales."""
    dec, variables, port = decoder_pair(dtype)
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 120, (B, P)).astype(np.int32)
    enc = rng.standard_normal((B, L_ENC, 48)).astype(np.float32)
    prompt_mask = np.ones((B, P), np.int32)
    prompt_mask[1, 2] = 0
    ids_tiled, mask_tiled = np.repeat(ids, K, 0), np.repeat(prompt_mask, K, 0)
    jax_rb.set_fused_decode("on")
    jax_rb.set_kv_quant("int8")
    port_rb.set_fused_decode("on")
    port_rb.set_kv_quant("int8")
    want, jcache = _run_steps(dec, to_jax(variables), jnp.asarray(enc),
                              jnp.asarray(ids_tiled), jnp.asarray(mask_tiled),
                              jnp.asarray(prompt_mask), n_steps=2)
    got, cache = _port_run_steps(port, enc, ids_tiled, mask_tiled,
                                 prompt_mask, n_steps=2)
    assert jcache["cross_kd"].dtype == jnp.int8
    assert cache["cross_k"].dtype == torch.int8
    assert cache["cross_k"].shape == (2, B, L_ENC, 64)
    assert cache["cross_vs"].shape == (2, B, 4)
    # the scales: one bf16 ulp of the head's amax apart at most, where the
    # two packages round the bf16 projections at other points
    np.testing.assert_allclose(
        cache["cross_ks"].numpy(), np.asarray(jcache["cross_ks"])[:, :, 0, :4],
        rtol=0 if dtype == jnp.float32 else 2 ** -7, atol=0)
    for s, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=tol,
                                   rtol=0, err_msg=f"step {s}")


def test_kv_quant_needs_the_fused_path():
    assert port_rb._KV_QUANT == "off"
    port_rb.set_kv_quant("int8")
    port_rb.set_fused_decode("off")
    assert not port_rb.use_kv_quant("cpu")
    port_rb.set_fused_decode("on")
    assert port_rb.use_kv_quant("cpu")
    with pytest.raises(ValueError):
        port_rb.set_kv_quant("fp8")


def test_wrapper_refuses_int8_without_scales_and_scales_without_int8():
    _, _, port = decoder_pair(jnp.float32)
    w_all, b_all = pack_decode_weights(port, torch.float32)
    h0 = torch.zeros(N, 64)
    sk, sv = torch.zeros(3, T, N, 64), torch.zeros(3, T, N, 64)
    km = torch.ones(N, T, dtype=torch.int32)
    c8 = torch.zeros(2, B, L_ENC, 64, dtype=torch.int8)
    scales = torch.ones(2, B, 4)
    with pytest.raises(ValueError, match="int8 cross K/V need"):
        fused_decode_step(h0, w_all, b_all, sk, sv, km, c8, c8, 0, heads=4)
    with pytest.raises(ValueError, match="int8 cross K/V need"):
        fused_decode_step(h0, w_all, b_all, sk, sv, km, c8, c8, 0, heads=4,
                          cross_ks=scales, cross_vs=scales[:, :1])
    with pytest.raises(ValueError, match="scales given"):
        fused_decode_step(h0, w_all, b_all, sk, sv, km, c8.float(),
                          c8.float(), 0, heads=4, cross_ks=scales,
                          cross_vs=scales)


def test_int8_beam_search_smoke(monkeypatch):
    """Captioning through build_generate_fn with int8 cross K/V on the
    tiny model: every step runs the int8 plain step, the ids are valid and
    the prompts kept, and the beam scores are finite."""
    from prismer_tpu_torch.ops import fused_decode
    port = build_random_prismer(
        port_config.build_prismer_config(task_config()), 3, "cpu")
    scales_seen = []
    real = fused_decode.fused_decode_step_reference

    def recording(*a, **kw):
        scales_seen.append(kw["cross_ks"] is not None and a[6].dtype)
        return real(*a, **kw)

    monkeypatch.setattr(fused_decode, "fused_decode_step_reference",
                        recording)
    port_rb.set_fused_decode("on")
    port_rb.set_kv_quant("int8")
    raw = to_torch(raw_batch(4))
    ids, mask = prompt_batch(4)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    seqs = port_build_generate_fn(port)(raw, ids, mask)
    assert seqs.shape == (2, 20) and torch.equal(seqs[:, :4].int()[mask > 0],
                                                 ids[mask > 0])
    assert ((seqs >= 0) & (seqs < 512)).all()
    assert scales_seen and set(scales_seen) == {torch.int8}
    from prismer_tpu_torch.data.device import materialize_experts
    with torch.no_grad():
        enc = port.encode(materialize_experts(raw, torch.float32))
    _, scores = beam_search(port, enc, ids, mask, num_beams=3, max_length=12,
                            min_length=4)
    assert torch.isfinite(scores).all()
