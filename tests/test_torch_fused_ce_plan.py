"""The bf16 fused-CE kernels' plan and rounding, on the CPU.

`ops.fused_ce.ce_plan` mirrors `make_plan` in csrc/fused_ce.cu: it is
pinned at the caption fine-tune's row counts (N 1, 37, 116, 464) and both
registry decoder widths (D 768, 1024) at V 50265. Then a test-local torch
emulation of the kernels' arithmetic (statistics per 128-row vocab tile
combined per row, dx in fp32 rounded once to bf16 for dh and demb, dbias
summed from the fp32 dx per row tile, dh summed over the plan's vocab
split in order) is held against the JAX package's
`fused_label_smoothed_loss` gradients (Pallas in interpret mode) on bf16
inputs: rel L2 <= 5e-3 for dh, demb and dbias (the bf16 rounding of dx,
and of dh and demb on the way out, is about 2^-9 of each element), the
loss within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.ops import fused_ce as jfc
from prismer_tpu_torch.ops import fused_ce as pfc

torch.set_num_threads(2)

V_REAL = 50265
SMEM_MAX = 227 * 1024
TOL_REL_L2 = 5e-3
TOL_LOSS = 1e-5


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("d", [768, 1024])
@pytest.mark.parametrize("n", [1, 37, 116, 464])
def test_ce_plan_fits_the_card(n, d):
    p = pfc.ce_plan(n, d, V_REAL)
    wg = p["stats"]["wg"]
    assert wg == (1 if n <= 64 else 2 if n <= 128 else 4)
    assert p["vtiles"] == 393 and p["vp"] == 393 * 128
    for name in ("stats", "dx"):
        k = p[name]
        assert k["grid"] == (_cdiv(n, 64 * wg), 393, 1)
        assert k["threads"] == 128 * wg
        assert 2 <= k["stages"] <= 4 and k["chunks"] == d // 64
    assert p["dx"]["smem"] == p["stats"]["smem"] + wg * 4 * 128 * 4
    dh = p["dh"]
    rows = 64 if n <= 64 else 128 if n <= 128 else 256
    assert dh["rows"] == rows and dh["wg"] == (2 if rows == 256 else 4)
    chunks = p["vp"] // 64
    row_tiles, dslices, ksplit = dh["grid"]
    assert row_tiles == _cdiv(n, rows) and dslices == _cdiv(d, 64 * dh["wg"])
    # the split covers every 64-row vocab chunk once, none empty, one wave
    assert (ksplit - 1) * dh["per"] < chunks <= ksplit * dh["per"]
    assert row_tiles * dslices * ksplit <= pfc.H100_SMS
    demb = p["demb"]
    assert demb["grid"] == (pfc.H100_SMS, 1, 1)
    assert demb["dslices"] == d // 128 and demb["chunks"] == _cdiv(n, 64)
    for name in ("stats", "dx", "dh", "demb"):
        assert p[name]["smem"] <= SMEM_MAX, name
    assert p["scratch"] == {"dx": n * p["vp"] * 2,
                            "dbias": _cdiv(n, 64 * wg) * p["vp"] * 4,
                            "dh": ksplit * n * d * 4}
    assert p["scratch_bytes"] == sum(p["scratch"].values())


@pytest.mark.parametrize("n, d, want", [
    (116, 768, {"ksplit": 44, "per": 18, "scratch": 27551232,
                "smem_dx": 103984, "smem_dh": 197696}),
    (464, 768, {"ksplit": 11, "per": 72, "scratch": 62764032,
                "smem_dx": 206400, "smem_dh": 197696}),
    (116, 1024, {"ksplit": 33, "per": 24, "scratch": 27551232,
                 "smem_dx": 103984, "smem_dh": 197696}),
])
def test_ce_plan_pinned(n, d, want):
    """The numbers PERF.md quotes: the dx scratch is 11.7 MB at N 116 and
    46.7 MB at N 464."""
    p = pfc.ce_plan(n, d, V_REAL)
    got = {"ksplit": p["dh"]["ksplit"], "per": p["dh"]["per"],
           "scratch": p["scratch_bytes"], "smem_dx": p["dx"]["smem"],
           "smem_dh": p["dh"]["smem"]}
    assert got == want


def test_wrapper_takes_bf16_widths_of_64_only():
    h = torch.zeros(4, 96, dtype=torch.bfloat16)
    emb = torch.zeros(300, 96, dtype=torch.bfloat16)
    bias, lab = torch.zeros(300), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 64"):
        pfc._check("ce_stats", h, emb, bias, lab)


def _emulate(h2, emb, bias, lab, gv, smoothing):
    """The bf16 kernels' arithmetic in torch: (loss terms, dh, demb, dbias).
    h2 (N, D), emb (V, D) bf16; bias, gv (N,) fp32; lab (N,) int."""
    n, d = h2.shape
    v = emb.shape[0]
    plan = pfc.ce_plan(n, d, v)
    x = h2.float() @ emb.float().t() + bias[None, :]
    # statistics per 128-row vocab tile, combined per row
    tiles = [x[:, t:t + 128] for t in range(0, v, 128)]
    pmax = torch.stack([t.max(1).values for t in tiles], 1)
    psum = torch.stack([torch.exp(t - m[:, None]).sum(1)
                        for t, m in zip(tiles, pmax.t())], 1)
    m = pmax.max(1).values
    lse = m + torch.log((psum * torch.exp(pmax - m[:, None])).sum(1))
    xlab = x.gather(1, lab.long()[:, None])[:, 0]
    per_tok = ((1 - smoothing) * (lse - xlab)
               + smoothing * (lse - x.sum(1) / v))
    # dx in fp32; dbias from it per row tile of 64 x wg rows, in order
    dx = gv[:, None] * (torch.exp(x - lse[:, None]) - smoothing / v)
    dx[torch.arange(n), lab.long()] -= (1 - smoothing) * gv
    rows = 64 * plan["dx"]["wg"]
    dbias = torch.zeros(v)
    for r in range(0, n, rows):
        dbias = dbias + dx[r:r + rows].sum(0)
    # dx rounded once to bf16 for both products
    dxb = dx.to(torch.bfloat16).float()
    dh = torch.zeros(n, d)
    step = 64 * plan["dh"]["per"]
    for k in range(0, v, step):
        dh = dh + dxb[:, k:k + step] @ emb[k:k + step].float()
    demb = dxb.t() @ h2.float()
    return per_tok, dh.to(torch.bfloat16), demb.to(torch.bfloat16), dbias


def _case(name, seed):
    rng = np.random.default_rng(seed)
    b, l, d, v = {"labels_0_and_last": (2, 9, 64, 300),
                  "ragged_last_tile": (3, 7, 128, 300),
                  "rows_with_gv_0": (2, 9, 64, 257),
                  "one_row": (1, 2, 64, 300)}[name]
    h = rng.standard_normal((b, l, d)).astype(np.float32)
    emb = (0.3 * rng.standard_normal((v, d))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(v)).astype(np.float32)
    labels = rng.integers(0, v, (b, l)).astype(np.int32)
    g = np.ones(b, np.float32)
    if name == "labels_0_and_last":
        labels[0, 1:5] = [0, v - 1, 0, v - 1]
        labels[1, 3] = v - 1
    elif name == "ragged_last_tile":      # 300 = 2 x 128 + 44
        labels[:, 2:] = rng.integers(256, v, (b, l - 2))
    elif name == "rows_with_gv_0":
        labels[0, 1:4] = -100             # ignored targets: valid 0
        g[1] = 0.0                         # a sample whose loss is not used
    else:
        labels[0, 1] = v - 1
    return h, emb, bias, labels, g


@pytest.mark.parametrize("name", ["labels_0_and_last", "ragged_last_tile",
                                  "rows_with_gv_0", "one_row"])
def test_kernel_rounding_matches_jax(name):
    h, emb, bias, labels, g = _case(name, 5)
    hb = jnp.asarray(h, jnp.bfloat16)
    eb = jnp.asarray(emb, jnp.bfloat16)

    def f(h_, e_, b_):
        return jfc.fused_label_smoothed_loss(h_, e_, b_, jnp.asarray(labels),
                                             interpret=True)

    loss, vjp = jax.vjp(f, hb, eb, jnp.asarray(bias))
    want = [np.asarray(t.astype(jnp.float32))
            for t in vjp(jnp.asarray(g))]

    b, l, d = h.shape
    h2 = torch.from_numpy(np.array(hb.astype(jnp.float32)))[:, :-1]
    h2 = h2.reshape(-1, d).to(torch.bfloat16)
    embt = torch.from_numpy(np.array(eb.astype(jnp.float32))).to(
        torch.bfloat16)
    lab2 = torch.from_numpy(labels[:, 1:].reshape(-1).copy())
    valid = (lab2 != -100).float()
    lab_safe = torch.where(lab2 != -100, lab2, 0).to(torch.int32)
    gv = torch.from_numpy(np.repeat(g, l - 1)) * valid
    per_tok, dh, demb, dbias = _emulate(h2, embt, torch.from_numpy(bias),
                                        lab_safe, gv, 0.1)
    got_loss = (valid * per_tok).reshape(b, l - 1).sum(1)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(loss),
                               rtol=0, atol=TOL_LOSS)
    dh_full = torch.zeros(b, l, d)
    dh_full[:, :-1] = dh.float().reshape(b, l - 1, d)
    for what, got, w in (("dh", dh_full, want[0]), ("demb", demb, want[1]),
                         ("dbias", dbias, want[2])):
        got = got.double().numpy()
        rel = np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= TOL_REL_L2, (what, rel)
        assert np.all(np.isfinite(got)), what
