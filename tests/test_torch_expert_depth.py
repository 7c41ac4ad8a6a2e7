"""The depth expert of the PyTorch port (prismer_tpu_torch.experts.depth:
DPT-hybrid) against the JAX package on the CPU.

Every module is run on numpy-seeded weights laid into the JAX variable tree
(its shape tree from `jax.eval_shape`) and loaded into the port with
`load_jax_variables`; inputs are seeded numpy arrays. The ResNetV2 front is
the expert's own (it takes no width); the ViT is 64 wide, 4 blocks deep
(12 for the converter) at 64 px. Tolerances, relative L2: 1e-5 for single
blocks, 1e-4 for the backbone and the whole model (fp32 sums in another
order, flax's one-pass GroupNorm variance against the port's two-pass).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth_sd as synth
from prismer_tpu.convert import experts as jax_convert
from prismer_tpu.experts.depth import model as jd
from prismer_tpu_torch.convert import experts as port_convert
from prismer_tpu_torch.convert.from_jax import (load_jax_variables,
                                                to_jax_variables)
from prismer_tpu_torch.experts import model_bank as port_bank
from prismer_tpu_torch.experts.depth import model as pd
from prismer_tpu_torch.experts.layers import build_random
from torch_expert_util import assert_trees_equal, rel_l2, run_both, t

torch.set_num_threads(2)

TINY = dict(features=32, vit_dim=64, vit_layers=4, vit_heads=2, hooks=(1, 3))
RES = 64
BLOCK = 1e-5
MODEL = 1e-4


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CASES = {
    "std_conv_3x3_s2": (lambda: jd.StdConv(16, (3, 3), (2, 2),
                                           padding=((1, 1), (1, 1))),
                        lambda: pd.StdConv(8, 16, 3, 2, 1), (2, 12, 12, 8)),
    "std_conv_1x1_s2": (lambda: jd.StdConv(16, (1, 1), (2, 2)),
                        lambda: pd.StdConv(8, 16, 1, 2), (2, 9, 9, 8)),
    "group_norm32": (lambda: jd.GroupNorm32(), lambda: pd.GroupNorm32(64),
                     (2, 5, 7, 64)),
    "preact_bottleneck": (
        lambda: jd.PreActBottleneck(mid=32, out=64, stride=2,
                                    downsample=True),
        lambda: pd.PreActBottleneck(32, 32, 64, 2, True), (2, 10, 10, 32)),
    "resnetv2_stage": (lambda: jd.ResNetV2Stage(2, 32, 64, 2),
                       lambda: pd.ResNetV2Stage(2, 64, 32, 64, 2),
                       (1, 8, 8, 64)),
    "vit_block": (lambda: jd.ViTBlock(heads=4), lambda: pd.ViTBlock(64, 4),
                  (2, 17, 64)),
    "residual_conv_unit": (lambda: jd.ResidualConvUnit(),
                           lambda: pd.ResidualConvUnit(32), (2, 6, 5, 32)),
    "fusion_no_skip": (lambda: jd.FeatureFusionBlock(),
                       lambda: pd.FeatureFusionBlock(32, False),
                       (2, 4, 5, 32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    jax_mod, port_mod, shape = CASES[name]
    want, got = run_both(jax_mod(), port_mod(), _x(shape), seed=3)
    assert rel_l2(got, want) < BLOCK


def test_fusion_block_with_skip_matches_jax():
    want, got = run_both(jd.FeatureFusionBlock(),
                         pd.FeatureFusionBlock(32, True),
                         _x((2, 4, 5, 32)), _x((2, 4, 5, 32), 1), seed=4)
    assert rel_l2(got, want) < BLOCK


def test_hybrid_backbone_matches_jax():
    want, got = run_both(jd.HybridBackbone(), pd.HybridBackbone(),
                         _x((1, 32, 32, 3)), seed=5)
    assert [w.shape for w in want] == [(1, 8, 8, 256), (1, 4, 4, 512),
                                       (1, 2, 2, 1024)]
    for g, w in zip(got, want):
        assert rel_l2(g, w) < MODEL


@pytest.mark.parametrize("grid", [(30, 30), (4, 4), (24, 24), (2, 5)])
def test_pos_embed_resize_matches_jax(grid):
    pos = _x((24 * 24, 16), 6)
    want = np.asarray(jd.resize_pos_embed_bilinear(jnp.asarray(pos), *grid))
    got = pd.resize_pos_embed_bilinear(t(pos), *grid)
    assert rel_l2(got, want) < 1e-6


def test_dpt_matches_jax():
    want, got = run_both(jd.DPTDepthModel(**TINY),
                         pd.DPTDepthModel(device="cpu", **TINY),
                         _x((2, RES, RES, 3)), seed=7)
    assert want.shape == (2, RES, RES)
    assert rel_l2(got, want) < MODEL


def _dpt12_shapes():
    model = jd.DPTDepthModel(**dict(TINY, vit_layers=12, hooks=(8, 11)))
    return model, jax.eval_shape(model.init, jax.random.key(0),
                                 jnp.zeros((1, RES, RES, 3)))


def synth_dpt_sd(params):
    """Inverse of `convert_dpt`: a MiDaS-layout state dict for `params`."""
    sd = {}
    pm = "pretrained.model"
    bb = params["backbone"]
    synth.synth_conv(sd, f"{pm}.patch_embed.backbone.stem.conv",
                     bb["stem_conv"])
    synth.synth_ln(sd, f"{pm}.patch_embed.backbone.stem.norm",
                   bb["stem_norm"]["GroupNorm_0"])
    for s in range(3):
        for b, blk in bb[f"stage_{s}"].items():
            q = (f"{pm}.patch_embed.backbone.stages.{s}.blocks."
                 f"{b.split('_')[1]}")
            for n in ("norm1", "norm2", "norm3"):
                synth.synth_ln(sd, f"{q}.{n}", blk[n]["GroupNorm_0"])
            for c in ("conv1", "conv2", "conv3"):
                synth.synth_conv(sd, f"{q}.{c}", blk[c])
            if "downsample_conv" in blk:
                synth.synth_conv(sd, f"{q}.downsample.conv",
                                 blk["downsample_conv"])
    synth.synth_conv(sd, f"{pm}.patch_embed.proj", params["patch_proj"])
    sd[f"{pm}.cls_token"] = synth._rand(params["cls_token"].shape)
    sd[f"{pm}.pos_embed"] = synth._rand((1,) + params["pos_embed"].shape)
    for i in range(12):
        q, p = f"{pm}.blocks.{i}", params[f"vit_block_{i}"]
        synth.synth_ln(sd, f"{q}.norm1", p["norm1"])
        synth.synth_ln(sd, f"{q}.norm2", p["norm2"])
        synth.synth_linear(sd, f"{q}.attn.qkv", p["qkv"])
        synth.synth_linear(sd, f"{q}.attn.proj", p["proj"])
        synth.synth_linear(sd, f"{q}.mlp.fc1", p["fc1"])
        synth.synth_linear(sd, f"{q}.mlp.fc2", p["fc2"])
    for n in (3, 4):
        synth.synth_linear(sd, f"pretrained.act_postprocess{n}.0.project.0",
                           params[f"post{n}_readout"])
        synth.synth_conv(sd, f"pretrained.act_postprocess{n}.3",
                         params[f"post{n}_proj"])
    synth.synth_conv(sd, "pretrained.act_postprocess4.4",
                     params["post4_down"])
    for i in range(1, 5):
        synth.synth_conv(sd, f"scratch.layer{i}_rn", params[f"layer{i}_rn"])
        q, p = f"scratch.refinenet{i}", params[f"refinenet{i}"]
        for ours, theirs in (("rcu1", "resConfUnit1"),
                             ("rcu2", "resConfUnit2")):
            if ours in p:
                for c in ("conv1", "conv2"):
                    synth.synth_conv(sd, f"{q}.{theirs}.{c}", p[ours][c])
        synth.synth_conv(sd, f"{q}.out_conv", p["out_conv"])
    for i, n in ((0, 1), (2, 2), (4, 3)):
        synth.synth_conv(sd, f"scratch.output_conv.{i}",
                         params[f"head_conv{n}"])
    return sd


def test_converter_equals_jax_and_load_expert_model_reads_it(tmp_path,
                                                             monkeypatch):
    """A synthetic MiDaS-layout `.pt` file: the port's `convert_dpt` gives
    the JAX converter's tree, and `load_expert_model('depth')` (built at
    the test's widths) loads exactly that tree through `weights_only`
    torch.load and the coverage gate."""
    _, shapes = _dpt12_shapes()
    sd = synth_dpt_sd(shapes["params"])
    tree = port_convert.convert_dpt(sd)
    assert_trees_equal(tree, jax_convert.convert_dpt(sd))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()},
               tmp_path / port_bank.WEIGHTS["depth"])
    monkeypatch.setenv("PRISMER_EXPERT_WEIGHTS", str(tmp_path))
    monkeypatch.setattr(port_bank, "_build", lambda task, device: build_random(
        pd.DPTDepthModel, 0, device,
        pd.RAW_INIT, **dict(TINY, vit_layers=12, hooks=(8, 11))))
    model, _ = port_bank.load_expert_model("depth", RES, "cpu")
    assert_trees_equal(to_jax_variables(model.state_dict()), tree)


def test_full_width_tree_loads_into_a_meta_port_model():
    shapes = jax.eval_shape(jd.DPTDepthModel().init, jax.random.key(0),
                            jnp.zeros((1, 384, 384, 3)))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                         shapes)
    port = pd.DPTDepthModel(device="meta")
    load_jax_variables(port, zeros)
    n_jax = sum(math.prod(s.shape) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in port.parameters()) == n_jax
    assert len(port.state_dict()) == len(jax.tree.leaves(shapes))


def test_random_init_is_seeded_with_flax_distributions():
    a = build_random(pd.DPTDepthModel, 3, "cpu", pd.RAW_INIT, **TINY)
    b = build_random(pd.DPTDepthModel, 3, "cpu", pd.RAW_INIT, **TINY)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    w = a.backbone.stage_1.block_0.conv2.weight      # fan_in 128 * 9
    assert w.abs().max() <= 2.0 / math.sqrt(1152) / 0.87962566103423978
    assert 0.9 < w.std().item() * math.sqrt(1152) < 1.1
    assert torch.equal(a.cls_token, torch.zeros(1, 1, 64))
    assert 0.017 < a.pos_embed.std() < 0.023
    assert torch.equal(a.backbone.stem_norm.GroupNorm_0.weight,
                       torch.ones(64))
    with torch.no_grad():
        out = a(torch.zeros(1, RES, RES, 3))
    assert out.shape == (1, RES, RES) and bool(torch.isfinite(out).all())
