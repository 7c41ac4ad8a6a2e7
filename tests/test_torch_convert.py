"""The port's checkpoint converter (prismer_tpu_torch.convert.torch_to_jax
and convert.cli) against the JAX package's, on state dicts synthesized in
the reference's key layout (prismer_tiny; a CLIP visual tower with a CLS
row; an HF RobertaForMaskedLM). Trees must be equal leaf for leaf
(np.array_equal; the bicubic re-interpolation to 1e-6), the two CLIs must
write the same .npz, and the port must load what its CLI writes.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from prismer_tpu.config import build_prismer_config as jax_build_config
from prismer_tpu.config import tiny_test_config
from prismer_tpu.convert import cli as jax_cli
from prismer_tpu.convert import torch_to_jax as jax_cv
from prismer_tpu_torch import config as port_config
from prismer_tpu_torch.convert import cli as port_cli
from prismer_tpu_torch.convert import torch_to_jax as port_cv
from prismer_tpu_torch.convert.from_jax import to_jax_variables
from prismer_tpu_torch.models.prismer import Prismer as PortPrismer
from tests.test_convert import _synthetic_clip_state_dict
from tests.test_full_checkpoint_convert import \
    build_synthetic_reference_checkpoint
from tests.test_torch_model import build_pair

torch.set_num_threads(2)

EXPERTS = ["depth", "seg_coco", "obj_detection"]


def _configs(res=64, experts=EXPERTS):
    task = tiny_test_config(experts, res)
    return (jax_build_config(dict(task, dtype="float32")),
            port_config.build_prismer_config(dict(task, dtype="float32")))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def assert_trees_equal(got, want, interpolated=()):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for key in w:
        assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype, key
        if key.endswith(interpolated):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-6,
                                       err_msg=key)
        else:
            assert np.array_equal(g[key], w[key]), key


def _mlm_state_dict(sd):
    """An HF RobertaForMaskedLM state dict from a Prismer checkpoint's
    decoder: layer i's '.0' triplet member becomes HF layer i."""
    out = {}
    for k, v in sd.items():
        if not k.startswith("text_decoder."):
            continue
        k = k[len("text_decoder."):]
        parts = k.split(".")
        if parts[:3] == ["roberta", "encoder", "layer"]:
            if parts[4] != "0":
                continue
            k = ".".join(parts[:4] + parts[5:])
        elif parts[:3] == ["roberta", "encoder", "output_layer"]:
            continue
        out[k] = v
    return out


@pytest.mark.parametrize("res", [64, 128])
def test_prismer_checkpoint_tree_matches_jax(res):
    """At 128 px the 64-px checkpoint's positional embedding is
    re-interpolated (16 -> 64 tokens)."""
    jcfg, pcfg = _configs(res)
    sd = build_synthetic_reference_checkpoint(_configs(64)[0],
                                              np.random.default_rng(11))
    want = jax_cv.convert_prismer_checkpoint(sd, jcfg)
    got = port_cv.convert_prismer_checkpoint(sd, pcfg)
    assert_trees_equal(got, want, interpolated=("positional_embedding",))
    pe = got["params"]["expert_encoder"]["positional_embedding"]
    assert pe.shape == (pcfg.vision.rgb_tokens, 64)
    assert got["batch_stats"]["expert_encoder"]["conv1_seg"]["bn_3"][
        "var"].shape == (64,)


def test_clip_vision_with_reinterpolation_matches_jax():
    jcfg, pcfg = _configs(64, ["depth"])
    sd = _synthetic_clip_state_dict(jcfg.vision, grid=7)   # CLS + 7x7
    want = jax_cv.convert_clip_vision(sd, jcfg)
    got = port_cv.convert_clip_vision(sd, pcfg)
    assert got["positional_embedding"].shape == (16, 64)
    assert_trees_equal(got, want, interpolated=("positional_embedding",))
    pe = np.random.default_rng(2).standard_normal((49, 5)).astype(np.float32)
    for n in (16, 49, 144):
        np.testing.assert_allclose(port_cv.interpolate_pos_embed_np(pe, n),
                                   jax_cv.interpolate_pos_embed_np(pe, n),
                                   rtol=0, atol=1e-6)


def test_hf_roberta_mlm_matches_jax():
    jcfg, _ = _configs()
    sd = _mlm_state_dict(build_synthetic_reference_checkpoint(
        jcfg, np.random.default_rng(5)))
    want = jax_cv.convert_hf_roberta_mlm(sd, 2)
    got = port_cv.convert_hf_roberta_mlm(sd, 2)
    assert_trees_equal(got, want)
    assert "cross_attn" not in got["layers_0"]


def test_uncovered_leaves_and_merge_params_match_jax():
    """Against the init trees of both packages (the same seeded values):
    a partial tree (CLIP + RoBERTa) leaves the same leaves uncovered and
    merges to the same tree; a full checkpoint covers everything."""
    model, variables, port = build_pair()
    jax_init = jax.tree.map(np.asarray, variables)
    port_init = to_jax_variables(port.state_dict())
    assert_trees_equal(port_init, jax_init)
    jcfg = jax_build_config(dict(tiny_test_config(
        port_config.CAPTION_EXPERTS, 64), dtype="float32"))
    pcfg = port.cfg
    sd = build_synthetic_reference_checkpoint(jcfg,
                                              np.random.default_rng(9))
    partial = {
        "expert_encoder": port_cv.convert_clip_vision(
            _synthetic_clip_state_dict(jcfg.vision, grid=4), pcfg),
        "text_decoder": port_cv.convert_hf_roberta_mlm(
            _mlm_state_dict(sd), 2)}
    for tree, n_missing in ((partial, None), (
            port_cv.convert_prismer_checkpoint(sd, pcfg)["params"], 0)):
        want = jax_cv.uncovered_leaves(jax_init["params"], tree)
        got = port_cv.uncovered_leaves(port_init["params"], tree)
        # the init trees list their keys in another order
        assert got[0] == want[0] == len(_flat(jax_init["params"]))
        assert sorted(got[1]) == sorted(want[1])
        if n_missing is not None:
            assert len(got[1]) == n_missing
        else:
            assert "/text_decoder/layers_0/cross_attn/key/kernel" in got[1]
        assert_trees_equal(port_cv.merge_params(port_init["params"], tree),
                           jax_cv.merge_params(jax_init["params"], tree))
    with pytest.raises(KeyError):
        port_cv.merge_params(port_init["params"], {"nope": np.zeros(1)})
    bad = {"text_decoder": {"lm_head": {"bias": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="shape mismatch"):
        port_cv.merge_params(port_init["params"], bad)


def _run_cli(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    main()


def test_cli_writes_the_jax_npz_and_the_port_loads_it(tmp_path,
                                                             monkeypatch):
    jcfg, pcfg = _configs()
    sd = build_synthetic_reference_checkpoint(jcfg, np.random.default_rng(3))
    src = tmp_path / "pytorch_model.bin"
    torch.save(sd, src)
    args = ["--kind", "prismer", "--src", str(src), "--prismer_model",
            "prismer_tiny", "--experts", ",".join(EXPERTS),
            "--image_resolution", "64"]
    _run_cli(jax_cli.main, args + ["--dst", str(tmp_path / "jax.npz")],
             monkeypatch)
    port_cli.main(args + ["--dst", str(tmp_path / "port.npz")])
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files)
    assert any(k.startswith("['batch_stats']") for k in got.files)
    for key in want.files:
        assert np.array_equal(got[key], want[key]), key
    # the port loads it: every leaf covered, each one the file's value
    port = PortPrismer(pcfg, device="meta").to_empty(device="cpu")
    total, missing = port_cli.load_npz_into(port, str(tmp_path / "port.npz"))
    assert missing == [] and total == len(got.files)
    loaded = _flat(to_jax_variables(port.state_dict()))
    for key in got.files:
        path = "/" + "/".join(key[2:-2].split("']['"))
        assert np.array_equal(loaded[path], got[key]), key


def test_cli_roberta_and_clip_kinds_match_jax(tmp_path, monkeypatch):
    jcfg, _ = _configs(64, ["depth"])
    files = {"roberta": _mlm_state_dict(build_synthetic_reference_checkpoint(
        jcfg, np.random.default_rng(6))),
             "clip_vision": {k: torch.from_numpy(v) for k, v in
                             _synthetic_clip_state_dict(jcfg.vision).items()}}
    for kind, sd in files.items():
        src = tmp_path / f"{kind}.bin"
        torch.save(sd, src)
        args = ["--kind", kind, "--src", str(src), "--prismer_model",
                "prismer_tiny", "--experts", "depth", "--image_resolution",
                "64"]
        _run_cli(jax_cli.main, args + ["--dst", str(tmp_path / "j.npz")],
                 monkeypatch)
        port_cli.main(args + ["--dst", str(tmp_path / "p.npz")])
        want, got = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
        assert sorted(got.files) == sorted(want.files) and got.files
        for key in want.files:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-6 if "positional" in key
                                       else 0, err_msg=key)


def _small(shapes):
    """A flax shape tree with every axis cut to at most 2: the converters
    only permute and rename, so the keys and ranks are what they read."""
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        tuple(min(d, 2) for d in s.shape), s.dtype), shapes)


def _expert_state_dict(kind):
    """A reference-layout state dict for each label-expert kind, its arrays
    cut to at most 2 along every axis."""
    import jax.numpy as jnp

    import synth_sd as synth
    img = jnp.zeros((1, 64, 64, 3))
    if kind == "dpt":
        from test_torch_expert_depth import _dpt12_shapes, synth_dpt_sd
        return synth_dpt_sd(_small(_dpt12_shapes()[1])["params"])
    if kind == "nnet":
        from prismer_tpu.experts.normal.model import NNET
        from test_torch_expert_normal import synth_nnet_sd
        return synth_nnet_sd(_small(jax.eval_shape(
            NNET().init, jax.random.key(0), img)))
    if kind == "dexined":
        from prismer_tpu.experts.edge.model import DexiNed
        from test_torch_expert_edge import synth_dexined_sd
        return synth_dexined_sd(_small(jax.eval_shape(
            DexiNed().init, jax.random.key(0), img)))
    if kind == "charnet":
        from prismer_tpu.experts.ocr_detection.model import CharNet
        return synth.synth_charnet_sd(_small(jax.eval_shape(
            CharNet().init, jax.random.key(0), img)))
    if kind == "unidet":
        from prismer_tpu.experts.obj_detection.rcnn import UniDet
        from prismer_tpu.experts.obj_detection.resnest import \
            RESNEST200_BLOCKS
        from test_torch_expert_objdet import unidet_shapes
        shapes = _small(unidet_shapes(UniDet(), 64))
        return synth.synth_unidet_sd(shapes["params"], shapes["batch_stats"],
                                     RESNEST200_BLOCKS)
    from test_torch_expert_ocr import _synth_clip_sd
    return _synth_clip_sd(60, 32, 3)


@pytest.mark.parametrize("kind", ["dpt", "nnet", "dexined", "charnet",
                                  "unidet", "clip_text"])
def test_expert_kinds_write_the_jax_npz(kind, tmp_path, monkeypatch):
    """Each label-expert kind: a reference-layout `.pt` through both CLIs
    gives the same .npz, leaf for leaf."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in _expert_state_dict(kind).items()}
    src = tmp_path / "expert.pt"
    torch.save(sd, src)
    args = ["--kind", kind, "--src", str(src)]
    _run_cli(jax_cli.main, args + ["--dst", str(tmp_path / "j.npz")],
             monkeypatch)
    port_cli.main(args + ["--dst", str(tmp_path / "p.npz")])
    want, got = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert sorted(got.files) == sorted(want.files) and len(got.files) > 20
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert set(port_cli.KINDS) == {"prismer", "clip_vision", "roberta",
                                   "mask2former", "dpt", "nnet", "dexined",
                                   "charnet", "unidet", "clip_text"}


def test_pkl_files_are_read_without_running_code(tmp_path):
    import pickle

    good = tmp_path / "good.pkl"
    with open(good, "wb") as f:
        pickle.dump({"model": {"w": np.arange(3.0)}}, f)
    assert np.array_equal(port_cli._load_sd(str(good))["w"], np.arange(3.0))

    class Evil:
        def __reduce__(self):
            return (print, ("ran",))

    bad = tmp_path / "bad.pkl"
    with open(bad, "wb") as f:
        pickle.dump({"model": {"w": Evil()}}, f)
    with pytest.raises(pickle.UnpicklingError):
        port_cli._load_sd(str(bad))


def test_torchscript_archives_are_read_as_state_dicts(tmp_path):
    """OpenAI's CLIP files are TorchScript archives, which
    torch.load(weights_only=True) refuses."""
    module = torch.jit.script(torch.nn.Linear(3, 2))
    module.save(str(tmp_path / "clip.pt"))
    sd = port_cli._load_sd(str(tmp_path / "clip.pt"))
    assert set(sd) == {"weight", "bias"}
    assert torch.equal(sd["weight"], module.weight)
