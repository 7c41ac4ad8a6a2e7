"""Parity of the PyTorch port's Prismer (prismer_tpu_torch) with the JAX
package on the CPU: prismer_tiny with all six experts at 64 px.

Weights come from a numpy seed laid out in the JAX variable tree (its shape
tree from `jax.eval_shape(model.init)`) and go into the port through
`load_jax_variables`. Inputs come from numpy with a seed. Both sides get the
same instance slots: `draw_instance_slots(jax.random.key(0), 256, 128)`,
which is what JAX uses without an 'instance' RNG. Comparisons run in fp32
(atol 1e-4) unless noted.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.config import build_prismer_config, tiny_test_config
from prismer_tpu.data.device import materialize_experts
from prismer_tpu.models.prismer import Prismer
from prismer_tpu.models.vit import draw_instance_slots
from prismer_tpu_torch import config as port_config
from prismer_tpu_torch.convert.from_jax import load_jax_variables
from prismer_tpu_torch.data.device import \
    materialize_experts as port_materialize
from prismer_tpu_torch.models.prismer import Prismer as PortPrismer

torch.set_num_threads(2)

EXPERTS = ["depth", "normal", "seg_coco", "edge", "obj_detection",
           "ocr_detection"]
RES = 64
BATCH = 2
PROMPT = 4
BEAMS = 3
MAX_LEN = 12


def task_config(dtype="float32"):
    return dict(tiny_test_config(EXPERTS, RES), dtype=dtype)


def raw_batch(seed, batch=BATCH, label_res=224):
    """Raw expert batch as materialize_experts takes it (numpy)."""
    rng = np.random.default_rng(seed)
    raw = {"rgb": rng.integers(0, 256, (batch, RES, RES, 3)).astype(np.uint8)}
    for exp, ch in (("depth", 1), ("normal", 3), ("edge", 1)):
        raw[exp] = rng.uniform(-1, 1, (batch, label_res, label_res, ch)
                               ).astype(np.float32)
    for exp in ("seg_coco", "obj_detection", "ocr_detection"):
        raw[exp] = {
            "ids": rng.integers(0, 256, (batch, label_res, label_res)
                                ).astype(np.uint8),
            "table": rng.uniform(-1, 1, (batch, 256, 64)).astype(np.float32)}
    raw["obj_detection"]["instance"] = rng.integers(
        0, 256, (batch, label_res, label_res)).astype(np.uint8)
    return raw


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def seeded_variables(shapes, seed):
    """Numpy values for every leaf of a flax variable shape tree."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = str(path[-1].key)
        shape = sd.shape
        if name == "kernel":
            fan_in = math.prod(shape[:-1])
            x = rng.standard_normal(shape) / math.sqrt(fan_in)
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "mean"):
            x = 0.05 * rng.standard_normal(shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("embeddings"):
            x = 0.02 * rng.standard_normal(shape)
        else:  # positional_embedding, latents, instance_embedding
            x = rng.standard_normal(shape) * shape[-1] ** -0.5
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def instance_slots():
    return np.array(draw_instance_slots(jax.random.key(0), 256, 128))


def prompt_batch(seed, batch=BATCH, vocab=512):
    """4-token prompts; the last row right-padded by one token."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (batch, PROMPT)).astype(np.int32)
    mask = np.ones((batch, PROMPT), np.int32)
    ids[-1, -1], mask[-1, -1] = 1, 0
    return ids, mask


def build_pair(dtype="float32", seed=0):
    """(jax model, jax variables, port model) sharing one set of weights."""
    cfg = build_prismer_config(task_config(dtype))
    model = Prismer(cfg)
    ex = materialize_experts(to_jax(raw_batch(0, batch=1)))
    ones = jnp.ones((1, PROMPT), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), ex, ones, ones)
    variables = seeded_variables(shapes, seed)
    port = PortPrismer(port_config.build_prismer_config(task_config(dtype)))
    load_jax_variables(port, variables)
    return model, to_jax(variables), port.eval()


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def encoded(pair):
    model, variables, port = pair
    raw = raw_batch(1)
    enc_fn = jax.jit(lambda v, r: model.apply(
        v, materialize_experts(r), method=Prismer.encode))
    want = np.array(enc_fn(variables, to_jax(raw)))
    with torch.no_grad():
        got = port.encode(port_materialize(to_torch(raw)),
                          torch.from_numpy(instance_slots())).numpy()
    return want, got


def test_materialize_experts_matches_jax():
    raw = raw_batch(2)
    want = materialize_experts(to_jax(raw))
    got = port_materialize(to_torch(raw))
    assert sorted(want) == sorted(got)
    for name in want:
        w, g = want[name], got[name]
        if name == "obj_detection":
            np.testing.assert_array_equal(np.asarray(w["instance"]),
                                          g["instance"].numpy())
            w, g = w["label"], g["label"]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_encode_matches_jax(encoded):
    want, got = encoded
    assert got.shape == want.shape == (BATCH, 16 + 64, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_init_cache_logits_match_jax(pair, encoded):
    model, variables, port = pair
    enc = encoded[0]
    ids, mask = prompt_batch(3)
    ids_t, mask_t = np.repeat(ids, BEAMS, 0), np.repeat(mask, BEAMS, 0)
    fn = jax.jit(lambda v, i, m, e: model.apply(
        v, i, m, e, MAX_LEN, BEAMS, method=Prismer.init_cache)[0])
    want = np.asarray(fn(variables, ids_t, mask_t, enc))
    with torch.no_grad():
        got, cache = port.init_cache(torch.from_numpy(ids_t),
                                     torch.from_numpy(mask_t),
                                     torch.from_numpy(enc), MAX_LEN, BEAMS)
    assert got.dtype == torch.float32 and got.shape == (BATCH * BEAMS, 512)
    assert cache["cross_k"].shape[1] == BATCH  # per sample, not per beam
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_decode_steps_match_jax(pair, encoded):
    """Two cached decode steps after the prefill (beams=1)."""
    model, variables, port = pair
    enc = encoded[0]
    ids, mask = prompt_batch(4)
    init = jax.jit(lambda v, i, m, e: model.apply(
        v, i, m, e, MAX_LEN, method=Prismer.init_cache))
    step = jax.jit(lambda v, tok, idx, pos, km, c: model.apply(
        v, tok, idx, pos, km, c, method=Prismer.decode_step))
    _, jcache = init(variables, ids, mask, enc)
    with torch.no_grad():
        _, tcache = port.init_cache(torch.from_numpy(ids),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(enc), MAX_LEN)
    nonpad = mask.sum(1)
    for index, tok in ((PROMPT, [7, 300]), (PROMPT + 1, [9, 41])):
        tok = np.asarray(tok, np.int32)
        pos = (nonpad + (index - PROMPT) + 1 + 1).astype(np.int32)
        key_mask = np.zeros((BATCH, MAX_LEN), np.int32)
        key_mask[:, :PROMPT] = mask
        key_mask[:, PROMPT:index + 1] = 1
        want, jcache = step(variables, tok, jnp.asarray(index, jnp.int32),
                            pos, key_mask, jcache)
        with torch.no_grad():
            got, tcache = port.decode_step(
                torch.from_numpy(tok), index, torch.from_numpy(pos),
                torch.from_numpy(key_mask), tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0, err_msg=f"index {index}")


def test_decode_logits_match_jax(pair, encoded):
    model, variables, port = pair
    enc = encoded[0]
    rng = np.random.default_rng(5)
    ids = rng.integers(4, 512, (BATCH, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    fn = jax.jit(lambda v, i, m, e: model.apply(
        v, i, m, e, method=Prismer.decode_logits))
    want = np.asarray(fn(variables, ids, mask, enc))
    with torch.no_grad():
        got = port.decode_logits(torch.from_numpy(ids),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(enc)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bf16_encode_close_to_jax():
    """bf16 compute: the two frameworks round at different places, so the
    check is relative L2 <= 2e-2 against the JAX bf16 encoder."""
    model, variables, port = build_pair("bfloat16")
    raw = raw_batch(6)
    want = jax.jit(lambda v, r: model.apply(
        v, materialize_experts(r, jnp.bfloat16), method=Prismer.encode))(
        variables, to_jax(raw))
    want = np.asarray(want.astype(jnp.float32))
    with torch.no_grad():
        got = port.encode(port_materialize(to_torch(raw), torch.bfloat16),
                          torch.from_numpy(instance_slots()))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 2e-2, rel
