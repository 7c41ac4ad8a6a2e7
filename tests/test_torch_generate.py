"""Generation parity of the PyTorch port with the JAX package on the CPU.

`build_generate_fn` of the port must give exactly the token sequences of
the JAX `build_generate_fn` (run with fused decode off, the configuration
the port implements) on the tiny six-expert model, over three seeds; beam
scores agree to 1e-4. `lazy_top_candidates` must pick the JAX indices
exactly, exact-tie rows included, with values to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.models import roberta
from prismer_tpu.models.caption import build_generate_fn
from prismer_tpu.models.generation import beam_search
from prismer_tpu.models.generation import \
    lazy_top_candidates as jax_lazy_top_candidates
from prismer_tpu_torch import config as port_config
from prismer_tpu_torch.convert.from_jax import load_jax_variables
from prismer_tpu_torch.models.caption import \
    build_generate_fn as port_build_generate_fn
from prismer_tpu_torch.models.generation import (beam_search as port_beam_search,
                                                 lazy_top_candidates)
from prismer_tpu_torch.models.prismer import Prismer as PortPrismer
from prismer_tpu_torch.ops.beam_update import NEG_INF
from tests.test_torch_model import (build_pair, instance_slots, prompt_batch,
                                    raw_batch, task_config, to_jax, to_torch)

torch.set_num_threads(2)

SEEDS = (11, 12, 13)


@pytest.fixture(scope="module")
def fused_off():
    roberta.set_fused_decode("off")
    yield
    roberta.set_fused_decode("auto")


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def jax_generate(pair, fused_off):
    model = pair[0]
    return build_generate_fn(model)


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_matches_jax_exactly(pair, jax_generate, seed):
    model, variables, port = pair
    raw = raw_batch(seed)
    ids, mask = prompt_batch(seed)
    want = np.asarray(jax_generate(variables, to_jax(raw), ids, mask))
    got = port_build_generate_fn(port)(
        to_torch(raw), torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(instance_slots()))
    assert got.dtype == torch.int64 and got.shape == (2, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_with_eos_matches_jax(pair, jax_generate):
    """A raised EOS bias makes beams retire at different steps per sample:
    the EOS retirement, done rule and final pick run end to end."""
    model, variables, _ = pair
    params = jax.tree.map(np.array, variables)
    params["params"]["text_decoder"]["lm_head"]["bias"][2] += 0.6
    port = PortPrismer(port_config.build_prismer_config(task_config()))
    load_jax_variables(port, params)
    raw = raw_batch(SEEDS[0])
    ids, mask = prompt_batch(SEEDS[0])
    want = np.asarray(jax_generate(to_jax(params), to_jax(raw), ids, mask))
    got = port_build_generate_fn(port.eval())(
        to_torch(raw), torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(instance_slots()))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 2).sum() == 2 and want[0, -1] == want[1, -1] == 1


def test_beam_scores_match_jax(pair, fused_off):
    model, variables, port = pair
    rng = np.random.default_rng(21)
    enc = rng.standard_normal((2, 80, 64)).astype(np.float32)
    ids, mask = prompt_batch(21)
    kw = dict(num_beams=3, max_length=12, min_length=6, length_penalty=1.0,
              eos_token_id=2, pad_token_id=1)
    want_seqs, want_scores = jax.jit(lambda v, e, i, m: beam_search(
        model, v, e, i, m, **kw))(variables, enc, ids, mask)
    got_seqs, got_scores = port_beam_search(
        port, torch.from_numpy(enc), torch.from_numpy(ids),
        torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(got_seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("mask_eos", [False, True])
def test_lazy_top_candidates_matches_jax(mask_eos):
    rng = np.random.default_rng(7)
    b, k, v, kk = 4, 3, 300, 6
    logits = rng.standard_normal((b, k, v)).astype(np.float32) * 3
    alive = rng.standard_normal((b, k)).astype(np.float32)
    # exact ties: duplicated lanes within a beam, and two identical beams
    logits[0, 0, 10] = logits[0, 0, 250] = 20.0
    logits[1, 2] = logits[1, 1]
    alive[1, 2] = alive[1, 1]
    alive[2, 1:] = NEG_INF
    logits[3, :, 2] = 30.0  # EOS lane on top unless masked
    want = jax_lazy_top_candidates(jnp.asarray(logits), jnp.asarray(alive),
                                   kk, 2, jnp.asarray(mask_eos), block=64)
    got = lazy_top_candidates(torch.from_numpy(logits),
                              torch.from_numpy(alive), kk, 2, mask_eos)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=0)
    # the tie rows really tie, lowest flat index first
    assert got[2][0, :2].tolist() == [10, 250]
    assert got[1][1, 0].item() == 1 and got[1][1, 1].item() == 2
