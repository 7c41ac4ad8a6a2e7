"""The decode loop's tail on the CPU: the launch plan of the `lm_topk`
kernel's logits phase, its exact tile filter, and the `beam_update`
kernel's warp selection, each against the JAX package.

* `lm_topk_plan` mirrors the C `logits_plan` (csrc/lm_topk.cu); it is
  pinned at every registry decoder width and served row count.
* `tile_filter_top` below emulates the selection kernel's filter in torch:
  tau is the kk-th best of one candidate per selection thread, its best
  64-row tile maximum (the EOS tile left out while the EOS lane is
  masked), and only tiles whose maximum clears tau (or, for the EOS tile,
  whose masked lane does) are scanned. It takes the row statistics of `lazy_top_candidates`, so its
  values are the plain version's bit for bit and the test holds the filter
  alone: every output must equal `lazy_top_candidates` exactly, and the
  JAX kernel (interpret mode) in its indices, its values to the 2e-5
  relative + 2e-5 absolute of tests/test_lm_topk.py. The logits are set
  exactly through one-hot features (h = I, emb = logits^T, bias 0).
* `warp_beam_select` emulates the beam_update kernel's two selections (a
  lane per candidate, merged entries two per lane, K rounds of a (value
  desc, index asc) arg-max); the port's `beam_update` and the JAX Pallas
  kernel are compared bit for bit at B 1, 16, 33 and K up to the kernel's 16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.models.generation import beam_bookkeeping
from prismer_tpu.ops.beam_update import beam_update as jax_beam_update
from prismer_tpu.ops.lm_topk import lm_topk as jax_lm_topk
from prismer_tpu.ops.lm_topk import pad_embedding
from prismer_tpu_torch import config as port_config
from prismer_tpu_torch.models.generation import lazy_top_candidates
from prismer_tpu_torch.ops import lm_topk as lt
from prismer_tpu_torch.ops.beam_update import MAX_BEAMS, NEG_INF, beam_update
from tests.test_torch_beam_update import EOS as B_EOS
from tests.test_torch_beam_update import NAMES, PAD, _random_case

torch.set_num_threads(2)

EOS = 2
TILE = lt.TILE_V


# ---------------------------------------------------------------------------
# the logits launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["prismer_base", "prismer_large",
                                   "prismer_huge"])
def test_lm_topk_plan_fits_every_registry_decoder(model):
    """Every registry decoder's tied LM head at the served row counts (batch
    5, 8, 16 at beam 3): one row tile, 64-row vocab tiles covering V once
    (786 at 50265, the last 25 rows), about one block per SM, the feature
    rows as whole 64-column chunks, and the ring and rows within a block's
    shared memory."""
    cfg = port_config.build_prismer_config(
        {"experts": port_config.CAPTION_EXPERTS, "image_resolution": 480,
         "prismer_model": model}).decoder
    d, v = cfg.hidden_size, cfg.vocab_size
    assert (d, v) == ({"prismer_base": 768}.get(model, 1024), 50265)
    for n in (15, 24, 48):
        p = lt.lm_topk_plan(n, d, v)
        assert p.rows == {15: 16, 24: 24, 48: 48}[n]
        assert p.row_tiles == 1 and p.rows * p.row_tiles >= n
        assert p.tiles == 786 and (p.tiles - 1) * lt.TILE_V < v <= \
            p.tiles * lt.TILE_V and v - (p.tiles - 1) * lt.TILE_V == 25
        walked = sorted(t for x in range(p.blocks)
                        for t in range(x, p.tiles, p.blocks))
        assert walked == list(range(p.tiles))
        assert p.blocks == lt.H100_SMS
        assert p.chunks * lt.CHUNK == d
        assert 2 <= p.stages <= lt.MAX_STAGES
        assert p.smem_bytes <= lt.SMEM_LIMIT
    # BASE N 24: two rings of 8 boxes of 8 KB, 12 chunks x 24 rows x 128
    # bytes, each warpgroup's cross-warp max and sum, 32 barriers, 1 KB of
    # alignment slack; D 1024 N 48: the rows take 96 KB, the rings 7 stages
    assert lt.lm_topk_plan(24, 768, 50265) == (24, 1, 12, 786, 132, 8,
                                               170752)
    assert lt.lm_topk_plan(48, 1024, 50265) == (48, 1, 16, 786, 132, 7,
                                                217312)


def test_lm_topk_plan_edges():
    """More than 64 rows take row tiles that share the SMs; a short vocab
    takes one block per tile and no deeper ring than it streams; a width
    whose rows cannot fit is reported over the limit (the wrapper raises)."""
    p = lt.lm_topk_plan(72, 768, 50265)
    assert (p.rows, p.row_tiles, p.blocks) == (64, 2, 66)
    p = lt.lm_topk_plan(6, 64, 100)
    assert (p.rows, p.tiles, p.blocks, p.chunks, p.stages) == (8, 2, 2, 1, 1)
    assert lt.lm_topk_plan(64, 4096, 50265).smem_bytes > lt.SMEM_LIMIT


# ---------------------------------------------------------------------------
# the exact tile filter
# ---------------------------------------------------------------------------

def tile_filter_top(logits, alive, kk, eos, mask_eos):
    """The selection kernel's filter over (B, K, V) fp32 logits: returns
    (vals, beam, token) and the count of (row, tile) pairs scanned. tau is
    the kk-th best of one candidate per selection thread: thread t's best
    tile maximum over the tiles t, t + SELECT_THREADS, ... of every row."""
    b, k, v = logits.shape
    m = logits.amax(dim=-1, keepdim=True)
    ls = torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True))
    a = alive[:, :, None]
    tiles = -(-v // TILE)
    pad = torch.full((b, k, tiles * TILE - v), -torch.inf)
    tmax = torch.cat([logits, pad], dim=-1).view(b, k, tiles, TILE).amax(-1)
    tile_f = a + ((tmax - m) - ls)                        # (B, K, tiles)
    eos_tile = eos // TILE if mask_eos else -1
    threads = lt.SELECT_THREADS
    out_v = torch.empty(b, kk)
    out_i = torch.empty(b, kk, dtype=torch.int64)
    scanned = 0
    for s in range(b):
        cand = tile_f[s].clone()
        if eos_tile >= 0:
            cand[:, eos_tile] = -torch.inf
        per_thread = torch.full((threads,), -torch.inf)
        for j in range(tiles):
            per_thread[j % threads] = torch.maximum(per_thread[j % threads],
                                                    cand[:, j].max())
        flat = torch.sort(per_thread, descending=True).values
        tau = flat[kk - 1].item()
        picked = []
        for r in range(k):
            masked = (alive[s, r] + NEG_INF).item()
            for j in range(tiles):
                hit = tile_f[s, r, j].item() >= tau or (
                    j == eos_tile and masked >= tau)
                if not hit:
                    continue
                scanned += 1
                for vi in range(j * TILE, min(v, (j + 1) * TILE)):
                    f = (alive[s, r] + ((logits[s, r, vi] - m[s, r, 0])
                                        - ls[s, r, 0])).item()
                    if mask_eos and vi == eos:
                        f = masked
                    if f >= tau:
                        picked.append((-f, r * v + vi))
        picked.sort()
        assert len(picked) >= kk
        out_v[s] = torch.tensor([-f for f, _ in picked[:kk]])
        out_i[s] = torch.tensor([i for _, i in picked[:kk]])
    return (out_v, (out_i // v).to(torch.int32), (out_i % v).to(torch.int32),
            scanned)


def _jax_top(logits, alive, kk, mask_eos):
    """JAX's lm_topk kernel (interpret mode) on logits set exactly: h the
    identity rows, emb the logits transposed, bias 0."""
    b, k, v = logits.shape
    n = b * k
    d = max(8, -(-n // 8) * 8)
    h = np.eye(n, d, dtype=np.float32)
    emb = np.zeros((v, d), np.float32)
    emb[:, :n] = logits.reshape(n, v).numpy().T
    emb_tp, bias_p = pad_embedding(jnp.asarray(emb.T),
                                   jnp.zeros((v,), jnp.float32), v)
    out = jax_lm_topk(jnp.asarray(h), emb_tp, bias_p,
                      jnp.asarray(alive.numpy()), jnp.asarray(mask_eos),
                      vocab=v, beams=k, kk=kk, eos_token_id=EOS)
    return [np.asarray(x) for x in out]


def _case(name):
    """(logits (B, K, V), alive (B, K), kk, mask_eos) of each edge."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "f_rounds_equal":
        # distinct logits in five tiles whose candidates all round to one
        # f at alive 1000 (ulp 6e-5): the lowest raw maximum (v 5) ranks
        # first by flat index, so a filter on raw logits would lose it
        v = 300
        x = np.full((1, 2, v), -5.0, np.float32)
        for i, vi in enumerate((5, 70, 140, 210, 280)):
            x[0, 0, vi] = 0.3 + 1e-7 * i
        x[0, 1] = rng.standard_normal(v).astype(np.float32)
        alive = np.array([[1000.0, NEG_INF]], np.float32)
        return x, alive, 4, False
    if name == "masked_eos_is_max":
        v = 500
        x = rng.standard_normal((2, 3, v)).astype(np.float32)
        x[:, :, EOS] = 50.0
        alive = rng.standard_normal((2, 3)).astype(np.float32)
        return x, alive, 6, True
    if name == "tile_maxima_tied":
        v = 640
        x = rng.random((2, 3, v)).astype(np.float32) * 0.5
        x[:, :, ::TILE] = 1.0           # every tile's maximum is 1.0
        x[0, 1:] = x[0, 0]              # in rows alike: every f ties
        x[1] = 0.25                     # sample 1: every logit equal
        alive = np.zeros((2, 3), np.float32)
        return x, alive, 6, False
    if name == "vocab_below_64kk":
        v = 100                         # two tiles a row, one the EOS tile
        x = rng.standard_normal((2, 3, v)).astype(np.float32)
        alive = rng.standard_normal((2, 3)).astype(np.float32)
        return x, alive, 6, True
    if name == "one_tile_rows":
        v = 40                          # one tile a row: 3 maxima, kk 6
        x = rng.standard_normal((1, 3, v)).astype(np.float32)
        alive = np.zeros((1, 3), np.float32)
        return x, alive, 6, True
    assert name == "neg_inf_rows"       # the first step: beams 1, 2 dead
    v = 1000
    x = rng.standard_normal((2, 3, v)).astype(np.float32) * 2.0
    alive = np.array([[0.0, NEG_INF, NEG_INF], [-1.5, NEG_INF, 0.5]],
                     np.float32)
    return x, alive, 6, True


@pytest.mark.parametrize("name", ["f_rounds_equal", "masked_eos_is_max",
                                  "tile_maxima_tied", "vocab_below_64kk",
                                  "one_tile_rows", "neg_inf_rows"])
def test_tile_filter_matches_lazy_and_jax(name):
    x, alive, kk, mask_eos = _case(name)
    logits, alive_t = torch.from_numpy(x), torch.from_numpy(alive)
    *got, scanned = tile_filter_top(logits, alive_t, kk, EOS, mask_eos)
    want = lazy_top_candidates(logits, alive_t, kk, EOS, mask_eos)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    jax_out = _jax_top(logits, alive_t, kk, mask_eos)
    np.testing.assert_array_equal(got[1].numpy(), jax_out[1])
    np.testing.assert_array_equal(got[2].numpy(), jax_out[2])
    np.testing.assert_allclose(got[0].numpy(), jax_out[0], rtol=2e-5,
                               atol=2e-5)
    b, k, v = x.shape
    tiles = -(-v // TILE)
    if name == "f_rounds_equal":
        # all five tied tiles are scanned, the lowest flat index first
        assert got[2][0].tolist() == [5, 70, 140, 210]
    if name == "masked_eos_is_max":
        assert EOS not in got[2].flatten().tolist()
        # the masked EOS tile's raw maximum is every row's maximum, so it
        # is scanned (6 rows) beside the tiles that clear tau
        assert scanned < b * k * tiles
    if name in ("vocab_below_64kk", "one_tile_rows", "tile_maxima_tied"):
        assert scanned == b * k * tiles   # tau is -inf or every tile ties
    if name == "neg_inf_rows":
        assert scanned <= b * (kk + 2)    # the filter does filter


# ---------------------------------------------------------------------------
# beam_update: the kernel's warp selection and parity with the JAX kernel
# ---------------------------------------------------------------------------

def warp_beam_select(vals, beam, tok, fscore, ascore, pen, eos):
    """One sample as beam_update_kernel selects it: lane j holds candidate
    j (j < 2K), merged entry q lies in lane q % 32, slot q // 32; K rounds of
    the (value desc, index asc) arg-max over the entries not yet taken.
    Returns (done, fin_src, fin_score, new_score, new_beam, new_tok)."""
    k = fscore.shape[0]
    f32 = np.float32
    done = fscore.min() >= ascore.max() / f32(pen)
    merged = {}
    for q in range(3 * k):
        if q < k:
            merged[q] = fscore[q]
        else:
            j = q - k
            fin = tok[j] == eos and j < k and not done
            merged[q] = vals[j] / f32(pen) if fin else f32(NEG_INF)

    def rounds(entries):
        taken, out = set(), []
        for _ in range(k):
            offers = []
            for lane in range(32):     # each lane offers its best slot
                best = None
                for q in (lane, lane + 32):
                    if q in entries and q not in taken and (
                            best is None or entries[q] > entries[best]):
                        best = q
                if best is not None:
                    offers.append((-entries[best], best))
            _, q = min(offers)          # the butterfly's (value, index) order
            taken.add(q)
            out.append(q)
        return out

    fin_src = rounds(merged)
    cont = {j: (f32(NEG_INF) if tok[j] == eos else vals[j])
            for j in range(2 * k)}
    cont_idx = rounds(cont)
    return (done, fin_src, [merged[q] for q in fin_src],
            [cont[j] for j in cont_idx], [beam[j] for j in cont_idx],
            [tok[j] for j in cont_idx])


@pytest.mark.parametrize("b,k", [(1, 3), (16, 3), (33, 3), (4, 9), (3, 16)])
def test_beam_update_matches_jax_kernel_at_batch_and_beam_edges(b, k):
    """The port (plain on the CPU) and the JAX kernel bit for bit, and the
    kernel's warp selection emulated per sample, at B 1, 16, 33 (several
    samples a block, a partial last block) and K 9 and 16 (3K merged
    entries past one warp's lanes)."""
    assert k <= MAX_BEAMS
    t = 12
    index = 7
    rng = np.random.default_rng(b * 31 + k)
    n_eos, n_neg, n_done = min(b * k, 7), min(b * k, 5), min(b, 2)
    case = _random_case(rng, b, k, t, index, 1.0, n_eos, n_neg, n_done)
    vals, beam, tok, aseq, ascore, fseq, fscore, pen = case
    flat = (vals, beam, tok, aseq.reshape(b * k, t), ascore,
            fseq.reshape(b * k, t), fscore)
    want = jax_beam_update(*map(jnp.asarray, flat),
                           jnp.asarray(index, jnp.int32), jnp.asarray(pen),
                           eos_token_id=B_EOS, pad_token_id=PAD,
                           interpret=True)
    want_spec = beam_bookkeeping(
        *map(jnp.asarray, (vals, beam, tok, aseq, ascore, fseq, fscore)),
        jnp.asarray(index, jnp.int32), jnp.asarray(pen), eos_token_id=B_EOS,
        pad_token_id=PAD)
    got = beam_update(*map(torch.from_numpy, flat), index, float(pen),
                      eos_token_id=B_EOS, pad_token_id=PAD)
    for name, w, g in zip(NAMES, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    new_ascore, new_fscore = np.asarray(want[1]), np.asarray(want[3])
    np.testing.assert_array_equal(new_fscore, np.asarray(want_spec[3]))
    for s in range(b):
        done, src, fsc, nsc, nbeam, ntok = warp_beam_select(
            vals[s], beam[s], tok[s], fscore[s], ascore[s], pen, B_EOS)
        if done:
            np.testing.assert_array_equal(new_ascore[s], ascore[s])
            continue
        np.testing.assert_array_equal(new_fscore[s], np.float32(fsc))
        np.testing.assert_array_equal(new_ascore[s], np.float32(nsc))
        np.testing.assert_array_equal(np.asarray(want[5])[s],
                                      np.asarray(nbeam) + s * k)
        np.testing.assert_array_equal(np.asarray(want[4])[s], ntok)
        np.testing.assert_array_equal(
            np.asarray(want[2]).reshape(b, k, t)[s],
            [fseq[s, q] if q < k else np.where(
                np.arange(t) == index, B_EOS, aseq[s, beam[s, q - k]])
             for q in src])

