"""Bit parity of the PyTorch port's beam bookkeeping
(prismer_tpu_torch.ops.beam_update) with the JAX package on the CPU.

On the CPU `beam_update` computes its plain version; it must equal JAX
`beam_bookkeeping` and the JAX Pallas `beam_update` (interpret mode) bit
for bit, on the cases of tests/test_beam_update.py (copied here): NEG_INF
ties, done-sample freezes, min-length EOS candidates and negative length
penalties. The CUDA kernel is held to the same plain version on the card
by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.models.generation import beam_bookkeeping
from prismer_tpu.ops.beam_update import beam_update as jax_beam_update
from prismer_tpu_torch.ops.beam_update import (NEG_INF, beam_update,
                                               stable_top_k)

torch.set_num_threads(2)

EOS, PAD, V = 2, 1, 50
NAMES = ["alive_seqs", "alive_scores", "fin_seqs", "fin_scores", "tokens",
         "flat_beam"]


def _random_case(rng, b, k, t, index, lp, n_eos, n_neg, n_done):
    kk = 2 * k
    vals = rng.standard_normal((b, kk)).astype(np.float32) * 3.0
    vals[:, 1] = vals[:, 0]  # exact ties inside rows
    if n_neg:
        flat = rng.choice(b * kk, size=n_neg, replace=False)
        vals.reshape(-1)[flat] = NEG_INF
    beam = rng.integers(0, k, size=(b, kk)).astype(np.int32)
    tok = rng.integers(3, V, size=(b, kk)).astype(np.int32)
    if n_eos:
        flat = rng.choice(b * kk, size=n_eos, replace=False)
        tok.reshape(-1)[flat] = EOS
    alive_seqs = rng.integers(0, V, size=(b, k, t)).astype(np.int32)
    fin_seqs = rng.integers(0, V, size=(b, k, t)).astype(np.int32)
    alive_scores = rng.standard_normal((b, k)).astype(np.float32)
    fin_scores = rng.standard_normal((b, k)).astype(np.float32) - 1.0
    fin_scores[:, -1] = NEG_INF  # empty finished slots tie with masked cands
    if n_done:  # force the done rule true for the first n_done samples
        fin_scores[:n_done, :] = 100.0
    pen = np.float32(float(index) ** lp)
    return (vals, beam, tok, alive_seqs, alive_scores, fin_seqs, fin_scores,
            pen)


@pytest.mark.parametrize("b,k,t,lp,n_eos,n_neg,n_done", [
    (2, 3, 12, 1.0, 3, 2, 0),
    (4, 2, 10, -1.0, 5, 4, 1),
    (3, 4, 16, 2.0, 8, 6, 2),
    (8, 3, 20, 1.0, 0, 0, 0),    # no EOS candidates at all
    (2, 2, 8, 1.0, 8, 0, 2),     # everything EOS, all done
])
def test_beam_update_matches_jax_bitwise(b, k, t, lp, n_eos, n_neg, n_done):
    rng = np.random.default_rng(b * 100 + k * 10 + int(lp * 2) + n_eos)
    index = t // 2
    (vals, beam, tok, aseq, ascore, fseq, fscore, pen) = _random_case(
        rng, b, k, t, index, lp, n_eos, n_neg, n_done)

    want = beam_bookkeeping(
        *map(jnp.asarray, (vals, beam, tok, aseq, ascore, fseq, fscore)),
        jnp.asarray(index, jnp.int32), jnp.asarray(pen), eos_token_id=EOS,
        pad_token_id=PAD)
    want = (want[0].reshape(b * k, t), want[1], want[2].reshape(b * k, t),
            want[3], want[4], want[5])
    want_kernel = jax_beam_update(
        *map(jnp.asarray, (vals, beam, tok, aseq.reshape(b * k, t), ascore,
                           fseq.reshape(b * k, t), fscore)),
        jnp.asarray(index, jnp.int32), jnp.asarray(pen), eos_token_id=EOS,
        pad_token_id=PAD, interpret=True)
    got = beam_update(
        *map(torch.from_numpy, (vals, beam, tok, aseq.reshape(b * k, t),
                                ascore, fseq.reshape(b * k, t), fscore)),
        index, float(pen), eos_token_id=EOS, pad_token_id=PAD)
    for name, w, wk, g in zip(NAMES, want, want_kernel, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(wk),
                                      err_msg=name)
        assert g.dtype == torch.from_numpy(np.array(w)).dtype, name


def test_stable_top_k_ties_lowest_index_first():
    """torch.topk promises no tie order; the port's top-k must give lax.top_k
    order (equal values, lower index first) with both sentinels present."""
    import jax
    x = np.asarray([[1.0, 3.0, 3.0, NEG_INF, 3.0, NEG_INF, -1e9, 2.0]],
                   np.float32)
    vals, idx = stable_top_k(torch.from_numpy(x), 6)
    wvals, widx = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wvals))
    assert idx.tolist() == [[1, 2, 4, 7, 0, 3]]
