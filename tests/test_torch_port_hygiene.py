"""Hygiene of the PyTorch port (prismer_tpu_torch), on the CPU: it imports
without JAX and friends, its converter is strict, its configuration equals
the JAX package's, its random init is reproducible, and the numerical
hazards of the port are pinned (sentinels, fp32 logits from bf16 operands,
bf16 Dense bias, fp32 LayerNorm island, TF32 off in the smoke run)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from prismer_tpu import config as jax_config
from prismer_tpu.models import layers as jax_layers
from prismer_tpu.models import generation as jax_generation
from prismer_tpu_torch import config as port_config
from prismer_tpu_torch.convert.from_jax import load_jax_variables
from prismer_tpu_torch.models.layers import Dense, LayerNorm, fp32_layer_norm
from prismer_tpu_torch.models.prismer import (Prismer, build_random_prismer,
                                              init_random_)
from prismer_tpu_torch.ops import _build
from prismer_tpu_torch.ops import beam_update as port_beam
from prismer_tpu_torch.ops import flash_attention as port_fa

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "optax", "orbax", "yaml", "regex", "PIL", "cv2",
           "sklearn")


def test_package_imports_without_jax_flax_yaml_regex_pil():
    """Every module (train/, ops/fused_ce, ops/layer_norm, ops/ln_proj, the
    segmentation expert's experts/, convert/experts, data/png,
    data/pil_warp, the cli/ drivers, train/profiling, the label experts,
    parallel/ and convert/feature_tables among them) imports with jax,
    flax, optax, orbax, yaml, regex, PIL, cv2 and sklearn unimportable."""
    code = "\n".join([
        "import sys, importlib, pkgutil",
        f"for m in {BLOCKED!r}:",
        "    sys.modules[m] = None",
        "import prismer_tpu_torch",
        "names = [m.name for m in pkgutil.walk_packages(",
        "    prismer_tpu_torch.__path__, 'prismer_tpu_torch.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "bad = [m for m in sys.modules if m.split('.')[0] == 'prismer_tpu']",
        "assert not bad, bad",
        "assert len(names) >= 79, names",
        "assert {'prismer_tpu_torch.ops.fused_decode',",
        "        'prismer_tpu_torch.ops.lm_topk',",
        "        'prismer_tpu_torch.ops.fused_ce',",
        "        'prismer_tpu_torch.train.step',",
        "        'prismer_tpu_torch.train.state',",
        "        'prismer_tpu_torch.train.optim',",
        "        'prismer_tpu_torch.train.schedules',",
        "        'prismer_tpu_torch.train.checkpoint',",
        "        'prismer_tpu_torch.train.metrics',",
        "        'prismer_tpu_torch.experts',",
        "        'prismer_tpu_torch.experts.ops',",
        "        'prismer_tpu_torch.experts.ops.deform_attn',",
        "        'prismer_tpu_torch.experts.segmentation',",
        "        'prismer_tpu_torch.experts.segmentation.swin',",
        "        'prismer_tpu_torch.experts.segmentation.mask2former',",
        "        'prismer_tpu_torch.experts.model_bank',",
        "        'prismer_tpu_torch.experts.generate',",
        "        'prismer_tpu_torch.experts.layers',",
        "        'prismer_tpu_torch.experts.clip_text',",
        "        'prismer_tpu_torch.experts.objdet_postprocess',",
        "        'prismer_tpu_torch.experts.depth.model',",
        "        'prismer_tpu_torch.experts.normal.model',",
        "        'prismer_tpu_torch.experts.edge.model',",
        "        'prismer_tpu_torch.experts.obj_detection.resnest',",
        "        'prismer_tpu_torch.experts.obj_detection.rcnn',",
        "        'prismer_tpu_torch.experts.ocr_detection.model',",
        "        'prismer_tpu_torch.experts.ocr_detection.postprocess',",
        "        'prismer_tpu_torch.experts.ocr_detection.fill',",
        "        'prismer_tpu_torch.convert.experts',",
        "        'prismer_tpu_torch.data.png',",
        "        'prismer_tpu_torch.data.pil_warp',",
        "        'prismer_tpu_torch.ops.layer_norm',",
        "        'prismer_tpu_torch.ops.ln_proj',",
        "        'prismer_tpu_torch.cli',",
        "        'prismer_tpu_torch.cli.common',",
        "        'prismer_tpu_torch.cli.train_caption',",
        "        'prismer_tpu_torch.cli.train_vqa',",
        "        'prismer_tpu_torch.cli.train_classification',",
        "        'prismer_tpu_torch.cli.train_pretrain',",
        "        'prismer_tpu_torch.cli.demo',",
        "        'prismer_tpu_torch.cli.demo_vis',",
        "        'prismer_tpu_torch.train.profiling',",
        "        'prismer_tpu_torch.parallel',",
        "        'prismer_tpu_torch.parallel.mesh',",
        "        'prismer_tpu_torch.parallel.runtime',",
        "        'prismer_tpu_torch.parallel.zero',",
        "        'prismer_tpu_torch.parallel.tp',",
        "        'prismer_tpu_torch.parallel.dryrun',",
        "        'prismer_tpu_torch.convert.feature_tables'} <= set(names), names",
        "print(len(names))",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _tiny_port(dtype="float32"):
    cfg = port_config.build_prismer_config(dict(
        port_config.tiny_test_config(["depth", "obj_detection"], 32),
        dtype=dtype))
    return Prismer(cfg)


def _as_jax_tree(model):
    """The flax variable tree that would fill `model` (inverse renames)."""
    params, stats = {}, {}
    for key, t in model.state_dict().items():
        *mods, leaf = key.split(".")
        value = t.float().numpy()
        coll = params
        if leaf in ("running_mean", "running_var"):
            coll, leaf = stats, leaf.split("_")[1]
        elif leaf == "weight" and t.ndim == 2 and "embeddings" not in key:
            leaf, value = "kernel", value.T
        elif leaf == "weight" and t.ndim == 4:
            leaf, value = "kernel", value.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            leaf = "scale"
        node = coll
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value
    return {"params": params, "batch_stats": stats}


def test_converter_round_trip_and_strictness():
    src = build_random_prismer(_tiny_port().cfg, seed=3, device="cpu")
    tree = _as_jax_tree(src)
    dst = _tiny_port()
    load_jax_variables(dst, tree)
    for (k, a), b in zip(src.state_dict().items(),
                         dst.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)

    extra = _as_jax_tree(src)
    extra["params"]["text_decoder"]["lm_head"]["unused"] = np.zeros(3)
    with pytest.raises(KeyError, match="unused"):
        load_jax_variables(_tiny_port(), extra)

    missing = _as_jax_tree(src)
    del missing["batch_stats"]["expert_encoder"]["conv1_depth"]["bn_2"]
    with pytest.raises(KeyError, match="bn_2.running_mean"):
        load_jax_variables(_tiny_port(), missing)

    wrong = _as_jax_tree(src)
    wrong["params"]["expert_encoder"]["ln_pre"]["scale"] = np.zeros(5)
    with pytest.raises(ValueError, match="ln_pre.weight"):
        load_jax_variables(_tiny_port(), wrong)


@pytest.mark.parametrize("model", ["prismer_base", "prismer_tiny"])
def test_config_equals_jax_field_by_field(model):
    task = {"experts": port_config.CAPTION_EXPERTS, "image_resolution": 480,
            "prismer_model": model, "freeze": "freeze_vision",
            "dtype": "bfloat16"}
    want = jax_config.build_prismer_config(task)
    got = port_config.build_prismer_config(task)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vision.num_output_tokens == want.vision.num_output_tokens
    assert got.decoder.head_dim == want.decoder.head_dim
    assert port_config.VIT_GEOMETRY == jax_config.VIT_GEOMETRY
    assert port_config.EXPERT_CHANNELS == jax_config.EXPERT_CHANNELS
    assert port_config.tiny_test_config() == jax_config.tiny_test_config()


def test_random_init_reproducible_across_dtypes():
    cfg32 = _tiny_port().cfg
    a = build_random_prismer(cfg32, seed=5, device="cpu").state_dict()
    b = init_random_(_tiny_port(), 5).state_dict()
    bf = build_random_prismer(_tiny_port("bfloat16").cfg, seed=5,
                              device="cpu")
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
        want = a[k].to(bf.state_dict()[k].dtype)
        torch.testing.assert_close(bf.state_dict()[k], want, rtol=0, atol=0,
                                   msg=k)
    # Dense weights and biases in the compute dtype; LN and tables in fp32
    assert bf.text_decoder.layers_0.self_attn.query.bias.dtype == torch.bfloat16
    assert bf.text_decoder.embeddings.word_embeddings.dtype == torch.float32
    assert bf.expert_encoder.ln_pre.weight.dtype == torch.float32


def test_sentinels_match_jax():
    assert port_beam.NEG_INF == jax_generation.NEG_INF == -1.0e7
    assert port_fa.NEG_INF == jax_layers.NEG_INF == -1e9


def test_bf16_logits_accumulate_in_fp32():
    """The LM head takes bf16 operands and returns fp32 logits that are the
    fp32 sum of exact bf16 products, not bf16-rounded values."""
    model = build_random_prismer(_tiny_port("bfloat16").cfg, seed=1,
                                 device="cpu")
    head = model.text_decoder.lm_head
    emb = model.text_decoder.embeddings.word_embeddings
    h = torch.randn(3, 1, 64, generator=torch.Generator().manual_seed(0))
    logits = head(h.to(torch.bfloat16), emb)
    assert logits.dtype == torch.float32
    feats = head.features(h.to(torch.bfloat16)).double()
    want = feats @ emb.to(torch.bfloat16).double().t() + head.bias.double()
    torch.testing.assert_close(logits.double(), want, rtol=0, atol=1e-5)
    assert not torch.equal(logits, logits.to(torch.bfloat16).float())


def test_dense_and_layer_norm_dtype_islands():
    gen = torch.Generator().manual_seed(2)
    dense = Dense(8, 4, torch.bfloat16)
    x = torch.randn(2, 8, generator=gen)
    y = dense(x)  # fp32 input is cast to the compute dtype, as flax does
    assert y.dtype == torch.bfloat16
    ln = LayerNorm(8)
    xb = (torch.randn(2, 8, generator=gen) * 30 + 100).to(torch.bfloat16)
    out = ln(xb)
    assert out.dtype == torch.bfloat16
    want = fp32_layer_norm(xb.float(), ln.weight, ln.bias).to(torch.bfloat16)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_package_never_calls_sdpa():
    """PyTorch's fused attention is a yardstick that chip_smoke.py times
    beside the port's kernels, never a path of the port."""
    pkg = ROOT / "prismer_tpu_torch"
    hits = [str(p.relative_to(ROOT)) for p in sorted(pkg.rglob("*"))
            if p.suffix in (".py", ".cu", ".cuh")
            and "scaled_dot_product_attention" in p.read_text()]
    assert not hits, hits


def test_smoke_script_imports_no_jax_and_no_jax_package():
    """chip_smoke.py (the card's run, whose machine has none of them)
    imports nothing blocked above and nothing of prismer_tpu, at any
    depth of the script."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "prismer_tpu_torch" in roots and "torch" in roots
    assert not roots & (set(BLOCKED) | {"prismer_tpu"}), roots


def test_smoke_run_turns_tf32_off():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "torch.backends.cuda.matmul.allow_tf32 = False" in src
    assert "torch.backends.cudnn.allow_tf32 = False" in src


KERNEL_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
                  "beam_update.cu", "fused_decode.cu", "lm_topk.cu",
                  "fused_ce.cu", "ms_deform_attn.cu", "layer_norm.cu",
                  "ln_proj.cu", "decode_attention.cu", "common.cuh",
                  "layer_norm.cuh", "hopper.cuh")


def test_kernel_library_named_by_source_hash():
    path = _build.library_path()
    assert path.parent == ROOT / "build" / "kernels"
    assert path.name.startswith("libprismer_kernels_")
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        n for n in KERNEL_SOURCES if n.endswith(".cu")}
    assert {p.name for p in _build.CSRC.iterdir()} == set(KERNEL_SOURCES)


@pytest.mark.parametrize("name", KERNEL_SOURCES)
def test_kernel_library_hash_covers_every_source(name, tmp_path, monkeypatch):
    """Editing any kernel source or header renames the library, so a stale
    build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    with open(csrc / name, "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path() != before


def test_kernels_use_no_vendor_libraries():
    """The port's kernels are its own: no source includes or links cuBLAS,
    cuDNN or another vendor kernel library, and the build links none."""
    banned = ("cublas", "cudnn", "cutlass/gemm", "cusparse", "nccl")
    for src in _build.CSRC.iterdir():
        text = src.read_text().lower()
        for lib in banned:
            assert lib not in text, (src.name, lib)
    build_src = Path(_build.__file__).read_text().lower()
    assert "-l" + "cublas" not in build_src and "cudnn" not in build_src
    assert not any(f.startswith("-l") for f in _build.NVCC_FLAGS)


def test_build_runs_one_nvcc_per_source_then_links(tmp_path, monkeypatch):
    """The build compiles every .cu in its own nvcc process (started
    together), links the objects into the hash-named library and removes
    them; a failing compile raises with nvcc's output."""
    log = tmp_path / "calls.txt"
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text("\n".join([
        f"#!{sys.executable}",
        "import sys",
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')",
        "args = sys.argv[1:]",
        "if any('broken' in a for a in args):",
        "    sys.exit('error: broken source')",
        "open(args[args.index('-o') + 1], 'w').write('x')",
    ]))
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "common.cuh"):
        (csrc / name).write_text("// " + name)
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.build()
    assert lib == _build.library_path() and lib.exists()
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert len(compiles) == 2 and calls[-1].startswith("-shared")
    assert all("arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [lib.name]
    assert _build.build() == lib and len(log.read_text().splitlines()) == 3

    (csrc / "broken.cu").write_text("// broken")
    with pytest.raises(RuntimeError, match="broken source"):
        _build.build()
