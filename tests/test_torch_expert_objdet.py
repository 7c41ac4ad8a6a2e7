"""The object-detection expert of the PyTorch port
(prismer_tpu_torch.experts.obj_detection: UniDet on ResNeSt) against the
JAX package on the CPU.

The tiny UniDet is the JAX tests' (tests/test_unidet_converter.py): a
ResNeSt of one block a stage with an 8-wide stem (the stages keep their
published widths, as do FPN and the box heads), at 64 px. Its variables
are the union of the three separately initialised JAX trees (features,
RPN, cascade heads), numpy-seeded, loaded into the one port module.
Tolerances, relative L2: 1e-5 for blocks, 1e-4 for P3-P7, the RPN's
top-k scores and boxes and each cascade stage's scores and boxes (the
stages fed the same boxes). The host stages (NMS, the class-wise loop,
the occlusion mask) are held bit-equal on the same numpy arrays.
"""

import json
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import synth_sd as synth
from prismer_tpu.convert import experts as jax_convert
from prismer_tpu.experts import generate as jax_gen
from prismer_tpu.experts import model_bank as jax_bank
from prismer_tpu.experts import objdet_postprocess as jax_post
from prismer_tpu.experts.obj_detection import rcnn as jr
from prismer_tpu.experts.obj_detection import resnest as jrs
from prismer_tpu_torch.convert import experts as port_convert
from prismer_tpu_torch.convert.from_jax import (load_jax_variables,
                                                to_jax_variables)
from prismer_tpu_torch.data import png
from prismer_tpu_torch.experts import generate as port_gen
from prismer_tpu_torch.experts import model_bank as port_bank
from prismer_tpu_torch.experts import objdet_postprocess as port_post
from prismer_tpu_torch.experts.layers import avg_pool
from prismer_tpu_torch.experts.obj_detection import rcnn as pr
from prismer_tpu_torch.experts.obj_detection import resnest as prs
from test_torch_expert_generate import (EXPERT_RES, IMAGES, _expert_args,
                                        _port_loader, _read_label,
                                        image_root)
from torch_expert_util import (assert_trees_equal, rel_l2, run_both, seeded,
                               t)

torch.set_num_threads(2)

BLOCKS = (1, 1, 1, 1)
STEM = 8
RES = 64
BLOCK = 1e-5
MODEL = 1e-4


class TinyUniDet(jr.UniDet):
    def setup(self):
        self.backbone = jrs.ResNeSt(blocks=BLOCKS, stem_width=STEM,
                                    dtype=self.dtype)
        self.fpn = jr.FPN(dtype=self.dtype)
        self.rpn = jr.RPNHead(dtype=self.dtype)
        self.box_heads = [jr.CascadeBoxHead(dtype=self.dtype,
                                            name=f"box_head_{i}")
                          for i in range(3)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def unidet_shapes(model, res):
    """The shape tree of the three JAX inits, merged (model_bank's
    `_init_unidet`)."""
    img = jnp.zeros((1, res, res, 3))
    v1 = jax.eval_shape(lambda x: model.init(jax.random.key(0), x,
                                             method=jr.UniDet.features), img)
    sizes = [res // 8, res // 16, res // 32]
    sizes += [-(-sizes[-1] // 2), -(-sizes[-1] // 4)]      # P6, P7
    feats = [jax.ShapeDtypeStruct((1, n, n, 256), jnp.float32)
             for n in sizes]
    v2 = jax.eval_shape(lambda f: model.init(
        jax.random.key(1), f, method=jr.UniDet.rpn_proposals), feats)
    params, stats = dict(v1["params"]), dict(v1["batch_stats"])
    params.update(v2["params"])
    for stage in range(3):
        v3 = jax.eval_shape(lambda f, b: model.init(
            jax.random.key(2), f, b, stage, method=jr.UniDet.cascade_stage),
            feats, jnp.zeros((8, 4)))
        params.update(v3["params"])
        stats.update(v3["batch_stats"])
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its seeded variables, the port model loaded with them,
    a seeded image)."""
    model = TinyUniDet()
    variables = seeded(unidet_shapes(model, RES), 11)
    port = pr.UniDet(BLOCKS, STEM, device="cpu").eval()
    load_jax_variables(port, variables)
    return model, jax.tree.map(jnp.asarray, variables), port, _x(
        (1, RES, RES, 3), 12)


def test_avg_pool_matches_jax():
    x = _x((2, 9, 7, 3))
    for k, s, p in ((3, 2, 1), (2, 2, 0)):
        want = np.asarray(jrs.avg_pool_torch(jnp.asarray(x), k, s, p))
        assert rel_l2(avg_pool(t(x), k, s, p), want) < 1e-6


CASES = {
    "splat": (lambda: jrs.SplAtConv(16), lambda: prs.SplAtConv(16, 16),
              (2, 6, 6, 16)),
    "bottleneck_s2": (lambda: jrs.Bottleneck(16, 64, stride=2),
                      lambda: prs.Bottleneck(32, 16, 64, 2),
                      (2, 10, 10, 32)),
    "bottleneck_s1": (lambda: jrs.Bottleneck(16, 64, stride=1),
                      lambda: prs.Bottleneck(64, 16, 64, 1), (2, 6, 6, 64)),
    "box_head": (lambda: jr.CascadeBoxHead(), lambda: pr.CascadeBoxHead(),
                 (3, 7, 7, 256)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    jax_mod, port_mod, shape = CASES[name]
    want, got = run_both(jax_mod(), port_mod(), _x(shape), seed=3)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert rel_l2(g, w) < BLOCK


def test_resnest_matches_jax():
    want, got = run_both(jrs.ResNeSt(blocks=BLOCKS, stem_width=STEM),
                         prs.ResNeSt(BLOCKS, STEM), _x((1, RES, RES, 3)),
                         seed=4)
    assert sorted(got) == sorted(want) == ["res3", "res4", "res5"]
    for k in want:
        assert rel_l2(got[k], want[k]) < MODEL


def test_anchors_boxes_levels_and_roi_align_match_jax():
    for args in ((3, 5, 8, 32), (2, 2, 128, 512)):
        np.testing.assert_array_equal(pr.level_anchors(*args),
                                      jr.level_anchors(*args))
    rng = np.random.default_rng(5)
    boxes = np.sort(rng.uniform(-10, 70, (40, 2, 2)), axis=1).reshape(40, 4)
    boxes = boxes[:, [0, 2, 1, 3]].astype(np.float32)
    deltas = rng.standard_normal((40, 4)).astype(np.float32) * 3
    for w in ((1., 1., 1., 1.), jr.CASCADE_WEIGHTS[1]):
        want = np.asarray(jr.decode_boxes(jnp.asarray(boxes),
                                          jnp.asarray(deltas), w))
        assert rel_l2(pr.decode_boxes(t(boxes), t(deltas), w), want) < 1e-6
    big = boxes * np.float32(20)
    np.testing.assert_array_equal(pr.assign_levels(t(big)).numpy(),
                                  np.asarray(jr.assign_levels(big)))
    feat = _x((9, 11, 16), 6)
    want = np.asarray(jr.roi_align(jnp.asarray(feat), jnp.asarray(boxes), 8))
    assert rel_l2(pr.roi_align(t(feat), t(boxes), 8), want) < 1e-6


def _jit(model, method):
    return jax.jit(lambda v, *a: model.apply(v, *a, method=method),
                   static_argnums=(3,) if method is jr.UniDet.cascade_stage
                   else ())


def test_features_rpn_and_cascade_match_jax(tiny):
    model, variables, port, img = tiny
    feats = _jit(model, jr.UniDet.features)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = port.features(t(img))
    assert [f.shape for f in feats] == [(1, 8, 8, 256), (1, 4, 4, 256),
                                        (1, 2, 2, 256), (1, 1, 1, 256),
                                        (1, 1, 1, 256)]
    for g, f in zip(got, feats):
        assert rel_l2(g, f) < MODEL
    # the RPN on the JAX features: top-k scores (ties ordered as top_k)
    jf = [t(f) for f in feats]
    boxes, scores = _jit(model, jr.UniDet.rpn_proposals)(variables, feats)
    with torch.no_grad():
        pb, ps = port.rpn_proposals(jf)
    assert rel_l2(ps, scores) < MODEL and rel_l2(pb, boxes) < MODEL
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 40, (30, 2))
    cand = np.concatenate([xy, xy + rng.uniform(2, 30, (30, 2))], 1)
    cand = cand.astype(np.float32)
    cascade = _jit(model, jr.UniDet.cascade_stage)
    for stage in range(3):
        s_want, b_want = cascade(variables, feats, jnp.asarray(cand), stage)
        with torch.no_grad():
            s_got, b_got = port.cascade_stage(jf, t(cand), stage)
        assert rel_l2(s_got, s_want) < MODEL
        assert rel_l2(b_got, b_want) < MODEL


def test_level_topk_orders_ties_as_jax_top_k():
    logits = np.array([0.5, 0.7, 0.5, 0.7, 0.1, 0.5], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(logits), 4)
    got = torch.sort(t(logits), descending=True, stable=True)[1][:4]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _Stub:
    """Stands in for the device parts: returns fixed arrays, so both
    packages' host stages run on the same numpy inputs."""

    def __init__(self, p_boxes, p_scores, stages):
        self.p, self.stages, self.calls = (p_boxes, p_scores), stages, []

    def apply(self, variables, *args, method=None):       # the JAX side
        if method is jr.UniDet.features:
            return "feats"
        if method is jr.UniDet.rpn_proposals:
            return tuple(jnp.asarray(a) for a in self.p)
        self.calls.append(np.asarray(args[1]))
        s, b = self.stages[args[2]]
        return jnp.asarray(s), jnp.asarray(b)

    # the port side
    def features(self, image):
        return "feats"

    def rpn_proposals(self, feats):
        return tuple(t(a) for a in self.p)

    def cascade_stage(self, feats, boxes, stage):
        self.calls.append(boxes.numpy())
        s, b = self.stages[stage]
        return t(s), t(b)


def _host_case(seed, n_cls=722):
    rng = np.random.default_rng(seed)
    n = 2600
    xy = rng.uniform(-50, 500, (n, 2))
    p_boxes = np.concatenate([xy, xy + rng.uniform(1, 200, (n, 2))], 1)
    p_scores = rng.standard_normal(n)
    p_scores[::7] = p_scores[3]          # ties
    stages = []
    for _ in range(3):
        xy = rng.uniform(-20, 490, (1000, 2))
        b = np.concatenate([xy, xy + rng.uniform(0, 150, (1000, 2))], 1)
        # about 8 % of the scores pass DET_SCORE_THRESH
        s = 1 / (1 + np.exp(-(rng.standard_normal((1000, n_cls)) * 2 - 12)))
        stages.append((s.astype(np.float32), b.astype(np.float32)))
    return (p_boxes.astype(np.float32), p_scores.astype(np.float32), stages)


@pytest.mark.parametrize("seed", [0])
def test_detect_single_host_stages_are_bit_equal(seed):
    p_boxes, p_scores, stages = _host_case(seed)
    want_stub, got_stub = (_Stub(p_boxes, p_scores, stages) for _ in "ab")
    want = jr.detect_single(want_stub, None, jnp.zeros(1), (480, 480))
    got = pr.detect_single(got_stub, torch.zeros(1), (480, 480))
    assert len(want[0]) > 50
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the proposals after the RPN's NMS, padded with zero rows
    np.testing.assert_array_equal(got_stub.calls[0], want_stub.calls[0])


def test_nms_is_bit_equal():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 100, (500, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (500, 2))], 1)
    scores = np.round(rng.uniform(0, 1, 500), 2)     # many ties
    for thr, k in ((0.5, 300), (0.7, 1000), (0.3, 10)):
        np.testing.assert_array_equal(pr.nms_xyxy(boxes, scores, thr, k),
                                      jr.nms_xyxy(boxes, scores, thr, k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occlusion_ordered_mask_is_bit_equal(seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0, 1, (90, 120)).astype(np.float32)
    xy = rng.uniform(-5, 110, (25, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (25, 2))], 1)
    boxes[5] = boxes[4] + 0.2                  # a near duplicate
    boxes[7] = [10, 10, 30, 30]
    boxes[8] = [12, 12, 20, 20]                # inside another
    classes = rng.integers(0, 722, 25)
    got = port_post.occlusion_ordered_mask(depth, boxes, classes)
    want = jax_post.occlusion_ordered_mask(depth, boxes, classes)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and len(got[1]) > 5


def test_converter_equals_jax_and_load_expert_model_reads_it(tmp_path,
                                                             monkeypatch):
    shapes = unidet_shapes(TinyUniDet(), RES)
    sd = synth.synth_unidet_sd(shapes["params"], shapes["batch_stats"],
                               BLOCKS)
    tree = port_convert.convert_unidet(sd, blocks=BLOCKS)
    assert_trees_equal(tree, jax_convert.convert_unidet(sd, blocks=BLOCKS))
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}, "iteration": 7},
               tmp_path / port_bank.WEIGHTS["obj_detection"])
    monkeypatch.setenv("PRISMER_EXPERT_WEIGHTS", str(tmp_path))
    # the file covers every tensor, so the seed's values would all be
    # overwritten
    monkeypatch.setattr(port_bank, "_build", lambda task, device: pr.UniDet(
        BLOCKS, STEM, device="meta").to_empty(device=device))
    convert = port_convert.convert_unidet
    monkeypatch.setattr(port_convert, "convert_unidet",
                        lambda sd: convert(sd, blocks=BLOCKS))
    model, preprocess = port_bank.load_expert_model("obj_detection", RES,
                                                    "cpu")
    assert_trees_equal(to_jax_variables(model.state_dict()), tree)
    np.testing.assert_allclose(
        preprocess(np.zeros((3, 3, 3), np.uint8))[0, 0],
        -port_bank.OBJDET_MEAN / port_bank.OBJDET_STD, rtol=1e-6)


def test_a_file_torch_cannot_read_safely_raises_with_its_path(tmp_path,
                                                              monkeypatch):
    import pickle

    class Evil:
        def __reduce__(self):
            return (print, ("ran",))

    path = tmp_path / port_bank.WEIGHTS["obj_detection"]
    torch.save({"model": Evil()}, path, pickle_module=pickle)
    monkeypatch.setenv("PRISMER_EXPERT_WEIGHTS", str(tmp_path))
    monkeypatch.setattr(port_bank, "_build", lambda task, device: None)
    with pytest.raises(ValueError, match=re.escape(str(path))):
        port_bank.load_expert_model("obj_detection", RES, "cpu")


def test_full_width_tree_loads_into_a_meta_port_model():
    shapes = unidet_shapes(jr.UniDet(), 480)
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                         shapes)
    port = pr.UniDet(device="meta")
    load_jax_variables(port, zeros)
    n_jax = sum(math.prod(s.shape) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in port.parameters()) + sum(
        b.numel() for b in port.buffers()) == n_jax
    assert len(port.state_dict()) == len(jax.tree.leaves(shapes))


# the generator task

class _JitUniDet:
    """The JAX UniDet with each device part jitted, as `detect_single`
    calls them."""

    def __init__(self, model):
        self.fns = {m: jax.jit(lambda v, *a, m=m: model.apply(v, *a,
                                                              method=m),
                               static_argnums=(3,) if m is
                               jr.UniDet.cascade_stage else ())
                    for m in (jr.UniDet.features, jr.UniDet.rpn_proposals,
                              jr.UniDet.cascade_stage)}

    def apply(self, variables, *args, method):
        return self.fns[method](variables, *args)


def test_objdet_labels_match_jax_generator(image_root, tmp_path,
                                           monkeypatch):
    """Both generators with the tiny UniDet's weights over the same images
    and depth labels (one image without, so its order uses zeros): equal
    instance masks and instance -> class JSON. The RPN keeps 64 proposals
    instead of 1,000 in both packages, so the three cascade heads run at a
    size the CPU takes in a second; two classes get larger weights, so a
    handful of boxes pass the 0.5 threshold."""
    variables = seeded(unidet_shapes(TinyUniDet(), EXPERT_RES), 21)
    for i in range(3):
        head = variables["params"][f"box_head_{i}"]["cls_score"]
        head["bias"][:] = -12.0
        head["bias"][[7, 300]] = -1.5
        head["kernel"][:, [7, 300]] *= 16
    port = pr.UniDet(BLOCKS, STEM, device="cpu").eval()
    load_jax_variables(port, variables)
    for mod in (jr, pr):
        monkeypatch.setattr(mod, "POST_NMS_TOPK", 64)
    monkeypatch.setattr(jax_gen, "load_expert_model", lambda task,
                        image_size: (_JitUniDet(TinyUniDet()), jax.tree.map(
                            jnp.asarray, variables), jax_bank._resize_norm(
                            image_size, *port_bank.PIXEL_STATS[task])))
    monkeypatch.setattr(port_gen, "load_expert_model",
                        _port_loader(port, "obj_detection"))
    rng = np.random.default_rng(9)
    for folder, name, _, (w, h) in IMAGES[:-1]:
        depth = rng.integers(0, 256, (h, w)).astype(np.uint8)
        for out in ("jax", "port"):
            d = tmp_path / out / "depth" / "data" / folder
            os.makedirs(d, exist_ok=True)
            Image.fromarray(depth, "L").save(d / name)
    jax_gen.run_objdet(_expert_args(image_root, tmp_path / "jax"))
    port_gen.run_objdet(_expert_args(image_root, tmp_path / "port"))
    kept = 0
    for folder, name, _, (w, h) in IMAGES:
        rel = os.path.join("obj_detection", "data", folder, name)
        want = _read_label(tmp_path / "jax" / rel)
        got = png.read_png(str(tmp_path / "port" / rel))
        assert got.shape == want.shape == (h, w)
        np.testing.assert_array_equal(got, want)
        js = rel.replace(".png", ".json")
        assert ((tmp_path / "port" / js).read_text()
                == (tmp_path / "jax" / js).read_text())
        kept += len(json.loads((tmp_path / "jax" / js).read_text()))
    assert 2 * len(IMAGES) <= kept <= 40 * len(IMAGES), kept


def test_occlusion_mask_keeps_the_first_256_instances():
    """Past 256 instances the JAX package raises (a uint8 map cannot hold
    id 256); the port stamps and lists the first 256, and its map equals
    JAX's stamping of those."""
    rng = np.random.default_rng(4)
    depth = rng.uniform(0, 1, (40, 60)).astype(np.float32)
    xy = np.stack(np.meshgrid(np.arange(0, 60, 3.0), np.arange(0, 40, 3.0)),
                  -1).reshape(-1, 2)[:270]
    boxes = np.concatenate([xy, xy + 2.0], 1)       # disjoint 2x2 boxes
    classes = rng.integers(0, 722, len(boxes))
    with pytest.raises(OverflowError):
        jax_post.occlusion_ordered_mask(depth, boxes, classes)
    got, table = port_post.occlusion_ordered_mask(depth, boxes, classes)
    want, want_table = jax_post.occlusion_ordered_mask(depth, boxes[:256],
                                                       classes[:256])
    np.testing.assert_array_equal(got, want)
    assert table == want_table and len(table) == 256
