"""The segmentation expert in the PyTorch port
(prismer_tpu_torch.experts.segmentation: Swin + Mask2Former) against the JAX
package on the CPU.

Weights are numpy-seeded values laid into the JAX variable tree (its shape
tree from `jax.eval_shape`) and loaded into the port with
`load_jax_variables`. The tiny model keeps Swin-L's depths (2, 2, 18, 2) at
embed 8, window 4 and 80 px, whose 5x5 stage exercises PatchMerging's pad;
its pixel decoder has conv 32 and 2 encoder layers, its decoder 10 queries
and 3 layers. The JAX side is composed from its parts, as
tests/test_model_bank_weights.py composes it, and run once with
`capture_intermediates`, so each stage is compared on the JAX stage's own
inputs. Tolerances: 1e-5 for single blocks, 1e-4 rel L2 for whole stages
and the model (fp32 sums in another order), argmax equal wherever the top-2
gap of the semantic logits exceeds 1e-4.
"""

import inspect
import math
import os
import pickle

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth_sd as synth
from prismer_tpu.convert import experts as jax_convert
from prismer_tpu.experts.segmentation import mask2former as jm
from prismer_tpu.experts.segmentation import swin as js
from prismer_tpu_torch.convert import experts as port_convert
from prismer_tpu_torch.convert.from_jax import load_jax_variables
from prismer_tpu_torch.experts import model_bank as port_bank
from prismer_tpu_torch.experts.segmentation import mask2former as pm
from prismer_tpu_torch.experts.segmentation import swin as ps

torch.set_num_threads(2)

RES = 80
TINY = dict(embed_dim=8, swin_heads=(1, 2, 4, 8), window=4, conv_dim=32,
            mask_dim=32, enc_layers=2, dec_heads=4, dec_layers=3,
            num_queries=10)
# the converter's layer counts (6 encoder, 9 decoder layers) at tiny widths
TINY_FULL_DEPTH = dict(TINY, enc_layers=6, dec_layers=9)
REL = 1e-4
GAP = 1e-4
BUILD = pm.build_random_maskformer   # the bank's builder, before patching


class TinyMaskFormer(nn.Module):
    """The JAX MaskFormer at the widths of `widths` (port argument names),
    returning the semantic logits as MaskFormer does."""
    widths: dict

    @nn.compact
    def __call__(self, x):
        w = self.widths
        feats = js.SwinTransformer(embed_dim=w["embed_dim"],
                                   heads=w["swin_heads"], window=w["window"],
                                   name="backbone")(x)
        mask_features, ms = jm.PixelDecoder(
            conv_dim=w["conv_dim"], mask_dim=w["mask_dim"],
            enc_layers=w["enc_layers"], name="pixel_decoder")(feats)
        classes, masks = jm.MaskedTransformerDecoder(
            num_queries=w["num_queries"], hidden_dim=w["conv_dim"],
            heads=w["dec_heads"], dec_layers=w["dec_layers"],
            mask_dim=w["mask_dim"], name="predictor")(ms, mask_features)
        cls_prob = jax.nn.softmax(classes, axis=-1)[..., :-1]
        return jnp.einsum("bqc,bqhw->bchw", cls_prob, jax.nn.sigmoid(masks))


def seeded(shapes, seed):
    """Numpy values for every leaf of a flax variable shape tree."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name, shape = str(path[-1].key), sd.shape
        if name == "kernel":
            x = rng.standard_normal(shape) / math.sqrt(math.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            x = 0.05 * rng.standard_normal(shape)
        elif name == "rel_pos_bias":
            x = 0.02 * rng.standard_normal(shape)
        else:  # level_embed, query_feat, query_embed
            x = rng.standard_normal(shape)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flax_pair(module, *args, seed=0):
    """(numpy variables, port-style torch args) for a flax module."""
    shapes = jax.eval_shape(module.init, jax.random.key(0),
                            *(jnp.asarray(a) for a in args))
    return seeded(shapes, seed)


def t(x):
    return torch.from_numpy(np.array(x))


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def tiny():
    """JAX tiny model's output and stage outputs, and the port model with
    the same weights."""
    model = TinyMaskFormer(TINY)
    x = np.random.default_rng(1).standard_normal((2, RES, RES, 3)).astype(
        np.float32)
    variables = flax_pair(model, x)
    fn = jax.jit(lambda v, x: model.apply(v, x, capture_intermediates=True,
                                          mutable=["intermediates"]))
    out, state = fn(jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    inter = jax.tree.map(np.asarray, state["intermediates"])
    port = pm.MaskFormer(device="cpu", **TINY).eval()
    load_jax_variables(port, variables)
    return dict(x=x, out=np.asarray(out), inter=inter, port=port)


# ---------------------------------------------------------------------------
# Swin pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,win", [(8, 12, 4), (12, 12, 12), (6, 9, 3)])
def test_window_partition_round_trip(h, w, win):
    x = np.random.default_rng(0).standard_normal((2, h, w, 5)).astype(
        np.float32)
    got = ps.window_partition(t(x), win)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        js.window_partition(jnp.asarray(x), win)))
    np.testing.assert_array_equal(
        ps.window_unpartition(got, win, h, w).numpy(), x)


@pytest.mark.parametrize("w", [3, 4, 12])
def test_relative_position_index_matches_jax(w):
    np.testing.assert_array_equal(ps.relative_position_index(w),
                                  js.relative_position_index(w))


@pytest.mark.parametrize("hp,wp,win,shift", [(8, 8, 4, 2), (12, 16, 4, 2),
                                             (24, 24, 12, 6)])
def test_shift_attn_mask_matches_jax(hp, wp, win, shift):
    np.testing.assert_array_equal(ps.shift_attn_mask(hp, wp, win, shift),
                                  js.shift_attn_mask(hp, wp, win, shift))


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_with_padding_matches_jax(shift):
    """10 x 9 tokens pad to 12 x 12 after norm1 (zeros, unmasked); the
    shifted block rolls by -2 before and +2 after, with the mask built on
    the padded size."""
    x = np.random.default_rng(2).standard_normal((2, 10, 9, 16)).astype(
        np.float32)
    block = js.SwinBlock(heads=2, window=4, shift=shift)
    variables = flax_pair(block, x, seed=3)
    want = block.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    port = ps.SwinBlock(16, 2, 4, shift, device="cpu")
    load_jax_variables(port, variables)
    with torch.no_grad():
        got = port(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_patch_merging_odd_size_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 5, 7, 8)).astype(
        np.float32)
    merge = js.PatchMerging()
    variables = flax_pair(merge, x, seed=5)
    want = merge.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    port = ps.PatchMerging(8, device="cpu")
    load_jax_variables(port, variables)
    with torch.no_grad():
        got = port(t(x))
    assert got.shape == (2, 3, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_swin_transformer_matches_jax(tiny):
    want = tiny["inter"]["backbone"]["__call__"][0]
    with torch.no_grad():
        got = tiny["port"].backbone(t(tiny["x"]))
    assert [tuple(got[k].shape) for k in sorted(got)] == [
        (2, 20, 20, 8), (2, 10, 10, 16), (2, 5, 5, 32), (2, 3, 3, 64)]
    for k in ("res2", "res3", "res4", "res5"):
        assert rel_l2(got[k].numpy(), want[k]) <= REL, k


# ---------------------------------------------------------------------------
# Mask2Former pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((120, 120), (15, 15)),
                                     ((120, 120), (30, 30)),
                                     ((120, 120), (60, 60)),
                                     ((30, 30), (120, 120)),
                                     ((7, 9), (20, 4))])
def test_bilinear_resize_matches_half_pixel_matrix(src, dst):
    """F.interpolate(bilinear, align_corners=False, no antialias) computes
    the JAX package's half-pixel matrices, downsampling included (the
    attention masks go from 120 to 15, 30 and 60)."""
    x = np.random.default_rng(6).standard_normal((2, *src, 3)).astype(
        np.float32)
    want = jm._resize_bilinear_half(jnp.asarray(x), *dst)
    got = pm.resize_bilinear_half(t(x).permute(0, 3, 1, 2), *dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=2e-6)


def test_position_embedding_and_reference_points_match_jax():
    np.testing.assert_array_equal(pm.sine_position_embedding(5, 7, 32),
                                  jm.sine_position_embedding(5, 7, 32))
    shapes = [(3, 3), (5, 6), (10, 10)]
    np.testing.assert_array_equal(pm.encoder_reference_points(shapes),
                                  jm.encoder_reference_points(shapes))


def test_ms_deform_attn_layer_matches_jax():
    """Locations ref + offset / (W_l, H_l), x first; softmax over L*P."""
    shapes = [(3, 3), (5, 6), (10, 10)]
    s = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(7)
    query = rng.standard_normal((2, s, 32)).astype(np.float32)
    value = rng.standard_normal((2, s, 32)).astype(np.float32)
    ref = np.broadcast_to(jm.encoder_reference_points(shapes)[None],
                          (2, s, 3, 2)).copy()
    layer = jm.MSDeformAttnLayer()
    shape_tree = jax.eval_shape(
        lambda k: layer.init(k, jnp.asarray(query), jnp.asarray(ref),
                             jnp.asarray(value), shapes), jax.random.key(0))
    variables = seeded(shape_tree, 8)
    # offsets of several pixels, so samples leave the maps
    variables["params"]["sampling_offsets"]["kernel"] *= 8.0
    want = layer.apply(jax.tree.map(jnp.asarray, variables),
                       jnp.asarray(query), jnp.asarray(ref),
                       jnp.asarray(value), shapes)
    port = pm.MSDeformAttnLayer(32, device="cpu")
    load_jax_variables(port, variables)
    with torch.no_grad():
        got = port(t(query), t(ref), t(value), shapes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mha_with_mask_bias_matches_jax():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 6, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 11, 16)).astype(np.float32)
    bias = np.where(rng.uniform(size=(2, 1, 6, 11)) < 0.5, -1e9,
                    0.0).astype(np.float32)
    bias[0, 0, 0] = -1e9     # a fully blocked row stays finite (uniform)
    mha = jm.MHA(heads=4)
    variables = flax_pair(mha, q, kv, kv, bias, seed=10)
    want = mha.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(q),
                     jnp.asarray(kv), jnp.asarray(kv), jnp.asarray(bias))
    port = pm.MHA(16, 4, device="cpu")
    load_jax_variables(port, variables)
    with torch.no_grad():
        got = port(t(q), t(kv), t(kv), t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pixel_decoder_matches_jax(tiny):
    inter = tiny["inter"]
    feats = {k: t(v) for k, v in inter["backbone"]["__call__"][0].items()}
    want_mf, want_ms = inter["pixel_decoder"]["__call__"][0]
    with torch.no_grad():
        got_mf, got_ms = tiny["port"].pixel_decoder(feats)
    assert rel_l2(got_mf.numpy(), want_mf) <= REL
    assert len(got_ms) == 3
    for g, w in zip(got_ms, want_ms):
        assert rel_l2(g.numpy(), w) <= REL


def test_masked_transformer_decoder_matches_jax(tiny):
    """Cross-attention first, masks blocked where sigmoid < 0.5 at
    sizes[(i + 1) % 3], empty rows unblocked, -1e9 bias."""
    inter = tiny["inter"]
    mf, ms = inter["pixel_decoder"]["__call__"][0]
    want_cls, want_masks = inter["predictor"]["__call__"][0]
    with torch.no_grad():
        got_cls, got_masks = tiny["port"].predictor([t(m) for m in ms], t(mf))
    assert rel_l2(got_cls.numpy(), want_cls) <= REL
    assert rel_l2(got_masks.numpy(), want_masks) <= REL


def test_whole_tiny_model_matches_jax(tiny):
    with torch.no_grad():
        got = tiny["port"](t(tiny["x"])).numpy()
    want = tiny["out"]
    assert got.shape == want.shape == (2, 133, RES // 4, RES // 4)
    assert rel_l2(got, want) <= REL
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > GAP
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(1)[clear], want.argmax(1)[clear])


def test_full_width_tree_loads_strictly_into_default_model():
    """Every leaf of the real MaskFormer(num_classes=133) (shapes from
    jax.eval_shape; they do not depend on the input size) has its place in
    the port's default model, and the port has no other parameter."""
    shapes = jax.eval_shape(jm.MaskFormer(num_classes=133).init,
                            jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                         shapes)
    port = pm.MaskFormer(device="meta")
    load_jax_variables(port, zeros)
    n_jax = sum(math.prod(s.shape) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in port.parameters()) == n_jax
    assert len(port.state_dict()) == len(jax.tree.leaves(shapes)) == 697


def test_random_init_is_seeded_with_flax_distributions():
    a = pm.build_random_maskformer(3, "cpu", **TINY)
    b = pm.build_random_maskformer(3, "cpu", **TINY)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    assert inspect.signature(pm.build_random_maskformer).parameters[
        "device"].default == "cuda"
    fc1 = a.backbone.stage2_block5.fc1.weight      # (128, 32): fan_in 32
    assert fc1.shape == (128, 32)
    assert fc1.abs().max() <= 2.0 / math.sqrt(32) / 0.87962566103423978
    assert 0.9 < fc1.std().item() * math.sqrt(32) < 1.1
    assert torch.equal(a.backbone.out_norm3.weight, torch.ones(64))
    assert torch.equal(a.pixel_decoder.input_norm_0.bias, torch.zeros(32))
    assert 0.015 < a.backbone.stage0_block0.attn.rel_pos_bias.std() < 0.025
    assert 0.7 < a.predictor.query_feat.std() < 1.3


# ---------------------------------------------------------------------------
# the published checkpoint route (.pkl)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synthetic_sd():
    shapes = jax.eval_shape(TinyMaskFormer(TINY_FULL_DEPTH).init,
                            jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    return synth.synth_mask2former_sd(shapes["params"])


@pytest.fixture()
def tiny_bank(tmp_path, monkeypatch):
    """PRISMER_EXPERT_WEIGHTS at a tmp dir; the bank builds the tiny model
    at the converter's layer counts."""
    monkeypatch.setenv("PRISMER_EXPERT_WEIGHTS", str(tmp_path))
    monkeypatch.setattr(pm, "build_random_maskformer",
                        lambda seed, device, num_classes: BUILD(
                            seed, device, num_classes=num_classes,
                            **TINY_FULL_DEPTH))
    return tmp_path


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_converter_copy_equals_jax_converter(synthetic_sd):
    want = dict(_leaves(jax_convert.convert_mask2former(synthetic_sd)))
    got = dict(_leaves(port_convert.convert_mask2former(synthetic_sd)))
    assert got.keys() == want.keys() and len(got) > 600
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_pkl_checkpoint_loads_converted_values(tiny_bank, synthetic_sd):
    with open(tiny_bank / "model_final_f07440.pkl", "wb") as f:
        pickle.dump({"model": synthetic_sd, "__author__": "synthetic"}, f)
    model, _ = port_bank.load_expert_model("seg_coco", 64, "cpu")
    want = pm.MaskFormer(device="cpu", **TINY_FULL_DEPTH)
    load_jax_variables(want, jax_convert.convert_mask2former(synthetic_sd))
    for (k, a), b in zip(model.state_dict().items(),
                         want.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    np.testing.assert_array_equal(
        model.predictor.cross_8.out_proj.weight.numpy(),
        synthetic_sd["sem_seg_head.predictor.transformer_cross_attention_"
                     "layers.8.multihead_attn.out_proj.weight"])


def test_pruned_checkpoint_is_refused(tiny_bank, synthetic_sd):
    """A file that leaves over 1 % of the leaves uncovered (here the
    decoder's last layer) is a key-layout drift, not a partial load."""
    pruned = {k: v for k, v in synthetic_sd.items()
              if "layers.8." not in k}
    with open(tiny_bank / "model_final_f07440.pkl", "wb") as f:
        pickle.dump({"model": pruned}, f)
    with pytest.raises(KeyError):
        port_bank.load_expert_model("seg_coco", 64, "cpu")
    covered = port_convert.convert_mask2former(synthetic_sd)
    del covered["params"]["predictor"]["cross_8"]
    del covered["params"]["predictor"]["self_8"]
    model = BUILD(0, "cpu", **TINY_FULL_DEPTH)
    with pytest.raises(ValueError, match="covers only"):
        port_bank.merge_converted(model, covered, "seg_coco")
    one = port_convert.convert_mask2former(synthetic_sd)
    del one["params"]["predictor"]["cross_8"]["out_proj"]["bias"]
    with pytest.warns(UserWarning, match="kept random init"):
        port_bank.merge_converted(model, one, "seg_coco")


def test_pkl_with_foreign_globals_is_refused(tiny_bank):
    with open(tiny_bank / "model_final_e0c58e.pkl", "wb") as f:
        pickle.dump({"model": {"x": os.getcwd}}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix|os"):
        port_bank.load_expert_model("seg_ade", 64, "cpu")


def test_missing_checkpoint_warns_and_uses_seeded_weights(tiny_bank):
    with pytest.warns(UserWarning, match="RANDOM weights"):
        model, _ = port_bank.load_expert_model("seg_ade", 64, "cpu")
    assert model.predictor.class_embed.weight.shape == (151, 32)
    want = BUILD(port_bank.RANDOM_SEED, "cpu", num_classes=150,
                 **TINY_FULL_DEPTH)
    torch.testing.assert_close(model.state_dict(), want.state_dict(),
                               rtol=0, atol=0)
