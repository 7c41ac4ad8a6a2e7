"""The edge expert of the PyTorch port (prismer_tpu_torch.experts.edge:
DexiNed) against the JAX package on the CPU.

The JAX module takes no widths, so the model is the expert's own, at 64 px;
blocks run at a few pixels. Weights are numpy-seeded values in the JAX
variable tree, loaded into the port with `load_jax_variables`. The
transposed convolution's leaf is pinned three ways: the port against the
JAX module, and both against torch.nn.ConvTranspose2d through the
converter. Tolerances, relative L2: 1e-5 for blocks, 1e-4 for each of the
seven maps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth_sd as synth
from prismer_tpu.convert import experts as jax_convert
from prismer_tpu.experts.edge import model as je
from prismer_tpu_torch.convert import experts as port_convert
from prismer_tpu_torch.convert.from_jax import (load_jax_variables,
                                                to_jax_variables)
from prismer_tpu_torch.experts import model_bank as port_bank
from prismer_tpu_torch.experts.edge import model as pe
from prismer_tpu_torch.experts.layers import ConvTranspose2d, max_pool
from torch_expert_util import assert_trees_equal, rel_l2, run_both, t

torch.set_num_threads(2)

RES = 64
BLOCK = 1e-5
MODEL = 1e-4


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CASES = {
    "double_conv_s2": (lambda: je.DoubleConvBlock(8, 16, stride=2),
                       lambda: pe.DoubleConvBlock(3, 8, 16, stride=2),
                       (2, 9, 9, 3)),
    "double_conv_no_act": (lambda: je.DoubleConvBlock(16, use_act=False),
                           lambda: pe.DoubleConvBlock(8, 16, use_act=False),
                           (2, 6, 6, 8)),
    "single_conv_s2": (lambda: je.SingleConvBlock(16, 2),
                       lambda: pe.SingleConvBlock(8, 16, 2), (2, 7, 7, 8)),
    "single_conv_no_bn": (lambda: je.SingleConvBlock(1, 1, use_bn=False),
                          lambda: pe.SingleConvBlock(6, 1, use_bn=False),
                          (2, 5, 5, 6)),
    "up_conv_1": (lambda: je.UpConvBlock(1), lambda: pe.UpConvBlock(8, 1),
                  (2, 5, 6, 8)),
    "up_conv_4": (lambda: je.UpConvBlock(4), lambda: pe.UpConvBlock(8, 4),
                  (1, 3, 2, 8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    jax_mod, port_mod, shape = CASES[name]
    want, got = run_both(jax_mod(), port_mod(), _x(shape), seed=3)
    assert rel_l2(got, want) < BLOCK


def test_dense_block_matches_jax():
    want, got = run_both(je.DenseBlock(3, 16), pe.DenseBlock(3, 8, 16),
                         _x((2, 6, 6, 8)), _x((2, 6, 6, 16), 1), seed=4)
    assert rel_l2(got, want) < BLOCK


@pytest.mark.parametrize("k,pad", [(2, 0), (4, 1), (8, 3), (16, 7)])
def test_conv_transpose_leaf_maps_as_torch_lays_it(k, pad):
    """torch ConvTranspose2d (in, out, k, k) -> the JAX converter's (k, k,
    out, in) kernel -> `load_jax_variables`' ordinary kernel permutation ->
    the port's (in, out, k, k): all three compute the same map."""
    torch.manual_seed(k)
    ref = torch.nn.ConvTranspose2d(5, 3, k, stride=2, padding=pad)
    sd = {f"up.{n}": v.detach() for n, v in ref.state_dict().items()}
    kernel = jax_convert.conv_transpose(sd, "up")
    np.testing.assert_array_equal(port_convert.conv_transpose(sd, "up")[
        "kernel"], kernel["kernel"])
    port = ConvTranspose2d(5, 3, k, 2, pad)
    load_jax_variables(port, {"params": kernel})
    torch.testing.assert_close(port.weight, ref.weight, rtol=0, atol=0)
    x = _x((2, 4, 5, 5), k)
    with torch.no_grad():
        want = ref(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = port(t(x))
    jax_out = je.ConvTranspose(3, k, 2, pad).apply(
        {"params": jax.tree.map(jnp.asarray, kernel)}, jnp.asarray(x))
    assert rel_l2(got, want.numpy()) < 1e-6
    assert rel_l2(np.asarray(jax_out), want.numpy()) < 1e-6


def test_max_pool_pads_with_minus_inf():
    x = -np.abs(_x((1, 7, 6, 2), 5)) - 1.0
    want = np.asarray(je._maxpool(jnp.asarray(x)))
    np.testing.assert_array_equal(max_pool(t(x), 3, 2, 1).numpy(), want)


def test_dexined_matches_jax():
    want, got = run_both(je.DexiNed(), pe.DexiNed(device="cpu"),
                         _x((2, RES, RES, 3)), seed=7)
    assert len(want) == 7 and all(w.shape == (2, RES, RES, 1) for w in want)
    for g, w in zip(got, want):
        assert rel_l2(g, w) < MODEL


def synth_dexined_sd(variables):
    """Inverse of `convert_dexined`: a DexiNed-layout state dict."""
    P, S = variables["params"], variables["batch_stats"]
    sd = {}
    for name in ("block_1", "block_2"):
        for c, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            synth.synth_conv(sd, f"{name}.{c}", P[name][c])
            synth.synth_bn(sd, f"{name}.{bn}", P[name][bn], S[name][bn])
    for name in ("dblock_3", "dblock_4", "dblock_5", "dblock_6"):
        for layer, lp in P[name].items():
            q = f"{name}.denselayer{int(layer.split('_')[1]) + 1}"
            ls = S[name][layer]
            for c, bn, theirs in (("conv1", "bn1", "norm1"),
                                  ("conv2", "bn2", "norm2")):
                synth.synth_conv(sd, f"{q}.{c}", lp[c])
                synth.synth_bn(sd, f"{q}.{theirs}", lp[bn], ls[bn])
    for name in ("side_1", "side_2", "side_3", "side_4", "pre_dense_2",
                 "pre_dense_3", "pre_dense_4", "pre_dense_5", "pre_dense_6"):
        synth.synth_conv(sd, f"{name}.conv", P[name]["conv"])
        synth.synth_bn(sd, f"{name}.bn", P[name]["bn"], S[name]["bn"])
    for i in range(1, 7):
        name = f"up_block_{i}"
        for j in range(len(P[name]) // 2):
            synth.synth_conv(sd, f"{name}.features.{3 * j}",
                             P[name][f"conv_{j}"])
            synth.synth_conv(sd, f"{name}.features.{3 * j + 2}",
                             P[name][f"deconv_{j}"])
    synth.synth_conv(sd, "block_cat.conv", P["block_cat"]["conv"])
    return sd


def test_converter_equals_jax_and_load_expert_model_reads_it(tmp_path,
                                                             monkeypatch):
    shapes = jax.eval_shape(je.DexiNed().init, jax.random.key(0),
                            jnp.zeros((1, RES, RES, 3)))
    sd = synth_dexined_sd(shapes)
    tree = port_convert.convert_dexined(sd)
    assert_trees_equal(tree, jax_convert.convert_dexined(sd))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()},
               tmp_path / port_bank.WEIGHTS["edge"])
    monkeypatch.setenv("PRISMER_EXPERT_WEIGHTS", str(tmp_path))
    model, preprocess = port_bank.load_expert_model("edge", RES, "cpu")
    assert_trees_equal(to_jax_variables(model.state_dict()), tree)
    img = np.zeros((4, 4, 3), np.uint8)
    np.testing.assert_allclose(preprocess(img)[0, 0],
                               -port_bank.IMAGENET_MEAN, rtol=1e-6)


def test_full_width_tree_loads_into_a_meta_port_model():
    shapes = jax.eval_shape(je.DexiNed().init, jax.random.key(0),
                            jnp.zeros((1, 480, 480, 3)))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                         shapes)
    port = pe.DexiNed(device="meta")
    load_jax_variables(port, zeros)
    assert len(port.state_dict()) == len(jax.tree.leaves(shapes))
