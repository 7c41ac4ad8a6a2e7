"""The surface-normal expert of the PyTorch port
(prismer_tpu_torch.experts.normal: NNET on EfficientNet-B5) against the JAX
package on the CPU.

The JAX module takes no widths, so the model is the expert's own, at 64 px
(the JAX package's own tests run it so); blocks run at a few pixels. Weights
are numpy-seeded values in the JAX variable tree, loaded into the port with
`load_jax_variables`. Tolerances, relative L2: 1e-5 for single blocks, 1e-4
for the encoder's taps and each of the four predictions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth_sd as synth
from prismer_tpu.convert import experts as jax_convert
from prismer_tpu.experts.normal import model as jn
from prismer_tpu_torch.convert import experts as port_convert
from prismer_tpu_torch.convert.from_jax import (load_jax_variables,
                                                to_jax_variables)
from prismer_tpu_torch.experts import model_bank as port_bank
from prismer_tpu_torch.experts.normal import model as pn
from torch_expert_util import assert_trees_equal, rel_l2, run_both, t

torch.set_num_threads(2)

RES = 64
BLOCK = 1e-5
MODEL = 1e-4


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CASES = {
    "squeeze_excite": (lambda: jn.SqueezeExcite(4),
                       lambda: pn.SqueezeExcite(16, 4), (2, 5, 5, 16)),
    "depthwise_s2_same_odd": (lambda: jn.DepthwiseConv(5, 2),
                              lambda: pn.DepthwiseConv(8, 5, 2),
                              (2, 9, 11, 8)),
    "depthwise_s2_same_even": (lambda: jn.DepthwiseConv(3, 2),
                               lambda: pn.DepthwiseConv(8, 3, 2),
                               (2, 8, 10, 8)),
    "ds_conv_block": (lambda: jn.DSConvBlock(16, 3, 1, 4),
                      lambda: pn.DSConvBlock(16, 16, 3, 1, 4),
                      (2, 6, 6, 16)),
    "mbconv_residual": (lambda: jn.MBConvBlock(16, 3, 1, 6, 4),
                        lambda: pn.MBConvBlock(16, 16, 3, 1, 6, 4),
                        (2, 6, 6, 16)),
    "mbconv_s2": (lambda: jn.MBConvBlock(24, 5, 2, 6, 4),
                  lambda: pn.MBConvBlock(16, 24, 5, 2, 6, 4),
                  (2, 7, 7, 16)),
    "point_mlp": (lambda: jn.PointMLP(), lambda: pn.PointMLP(20),
                  (2, 3, 4, 20)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    jax_mod, port_mod, shape = CASES[name]
    want, got = run_both(jax_mod(), port_mod(), _x(shape), seed=3)
    assert rel_l2(got, want) < BLOCK


def test_upsample_bn_matches_jax():
    want, got = run_both(jn.UpSampleBN(32), pn.UpSampleBN(16 + 8, 32),
                         _x((2, 3, 4, 16)), _x((2, 6, 8, 8), 1), seed=4)
    assert rel_l2(got, want) < BLOCK


def test_norm_normalize_matches_jax():
    x = _x((2, 5, 5, 4), 5)
    want = np.asarray(jn.norm_normalize(jnp.asarray(x)))
    assert rel_l2(pn.norm_normalize(t(x)), want) < 1e-6


def test_efficientnet_taps_match_jax():
    want, got = run_both(jn.EfficientNetB5(), pn.EfficientNetB5(),
                         _x((1, 32, 32, 3)), seed=6)
    assert [w.shape[-1] for w in want] == [24, 40, 64, 176, 2048]
    for g, w in zip(got, want):
        assert rel_l2(g, w) < MODEL


def test_nnet_matches_jax():
    want, got = run_both(jn.NNET(), pn.NNET(device="cpu"),
                         _x((2, RES, RES, 3)), seed=7)
    assert [w.shape for w in want] == [(2, 8, 8, 4), (2, 16, 16, 4),
                                       (2, 32, 32, 4), (2, 64, 64, 4)]
    for g, w in zip(got, want):
        assert rel_l2(g, w) < MODEL


def synth_nnet_sd(variables):
    """Inverse of `convert_nnet`: a scannet.pt-layout state dict."""
    P, S = variables["params"], variables["batch_stats"]
    sd = {}
    enc = "encoder.original_model"
    E, ES = P["encoder"], S["encoder"]
    synth.synth_conv(sd, f"{enc}.conv_stem", E["conv_stem"])
    synth.synth_bn(sd, f"{enc}.bn1", E["bn1"], ES["bn1"])
    for s, (reps, *_rest) in enumerate(jn.B5_STAGES):
        for r in range(reps):
            q, blk, st = (f"{enc}.blocks.{s}.{r}", E[f"blocks_{s}_{r}"],
                          ES[f"blocks_{s}_{r}"])
            synth.synth_conv(sd, f"{q}.conv_dw", blk["conv_dw"]["conv"])
            synth.synth_conv(sd, f"{q}.se.conv_reduce",
                             blk["se"]["conv_reduce"])
            synth.synth_conv(sd, f"{q}.se.conv_expand",
                             blk["se"]["conv_expand"])
            for c in ("conv_pw", "conv_pwl"):
                if c in blk:
                    synth.synth_conv(sd, f"{q}.{c}", blk[c])
            for bn in ("bn1", "bn2", "bn3"):
                if bn in blk:
                    synth.synth_bn(sd, f"{q}.{bn}", blk[bn], st[bn])
    synth.synth_conv(sd, f"{enc}.conv_head", E["conv_head"])
    synth.synth_conv(sd, "decoder.conv2", P["conv2"])
    for i in range(1, 5):
        q, up, st = f"decoder.up{i}._net", P[f"up{i}"], S[f"up{i}"]
        synth.synth_conv(sd, f"{q}.0", up["conv1"])
        synth.synth_bn(sd, f"{q}.1", up["bn1"], st["bn1"])
        synth.synth_conv(sd, f"{q}.3", up["conv2"])
        synth.synth_bn(sd, f"{q}.4", up["bn2"], st["bn2"])
    synth.synth_conv(sd, "decoder.out_conv_res8", P["out_conv_res8"])
    for res in (4, 2, 1):
        for k, j in ((0, 0), (1, 2), (2, 4), (3, 6)):
            q, fc = f"decoder.out_conv_res{res}.{j}", P[
                f"out_conv_res{res}"][f"fc{k}"]
            sd[f"{q}.weight"] = synth._rand(fc["kernel"].shape).T[:, :, None]
            sd[f"{q}.bias"] = synth._rand(fc["bias"].shape)
    return {f"module.{k}": v for k, v in sd.items()}


def test_converter_equals_jax_and_load_expert_model_reads_it(tmp_path,
                                                             monkeypatch):
    shapes = jax.eval_shape(jn.NNET().init, jax.random.key(0),
                            jnp.zeros((1, RES, RES, 3)))
    sd = synth_nnet_sd(shapes)
    tree = port_convert.convert_nnet(sd)
    assert_trees_equal(tree, jax_convert.convert_nnet(sd))
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}},
               tmp_path / port_bank.WEIGHTS["normal"])
    monkeypatch.setenv("PRISMER_EXPERT_WEIGHTS", str(tmp_path))
    # the file covers every tensor, so the seed's values (slow to draw at
    # this width on the CPU) would all be overwritten
    monkeypatch.setattr(port_bank, "_build", lambda task, device: pn.NNET(
        device="meta").to_empty(device=device))
    model, preprocess = port_bank.load_expert_model("normal", RES, "cpu")
    assert_trees_equal(to_jax_variables(model.state_dict()), tree)
    img = np.full((5, 7, 3), 255, np.uint8)
    np.testing.assert_allclose(preprocess(img)[0, 0],
                               (1 - port_bank.IMAGENET_MEAN)
                               / port_bank.IMAGENET_STD, rtol=1e-6)
    n_jax = sum(math.prod(s.shape) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for b in model.buffers()) == n_jax


def test_full_width_tree_loads_into_a_meta_port_model():
    shapes = jax.eval_shape(jn.NNET().init, jax.random.key(0),
                            jnp.zeros((1, 480, 480, 3)))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                         shapes)
    port = pn.NNET(device="meta")
    load_jax_variables(port, zeros)
    assert len(port.state_dict()) == len(jax.tree.leaves(shapes))
