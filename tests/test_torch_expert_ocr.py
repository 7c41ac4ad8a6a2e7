"""The OCR expert of the PyTorch port (prismer_tpu_torch.experts.
ocr_detection: CharNet on Hourglass-88, its host decode and cv2's polygon
fill), the CLIP text encoder its words are embedded with and
`CLIPTokenizer`, against the JAX package (and cv2) on the CPU.

CharNet takes no widths in the JAX module, so it is the expert's own at 64
px; blocks run at a few pixels. The CLIP text encoder is 64 wide and 2
blocks deep (768 wide where the PCA reads it). Weights are numpy-seeded
values in the JAX variable tree, loaded with `load_jax_variables`.
Tolerances, relative L2: 1e-5 for blocks and the text encoder, 1e-4 for
the six CharNet maps. The host decode, the polygon fill and the token ids
are held bit-equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth_sd as synth
from prismer_tpu import tokenizer as jax_tok
from prismer_tpu.convert import experts as jax_convert
from prismer_tpu.data.features import get_feature_tables as jax_tables
from prismer_tpu.experts import clip_text as jax_clip
from prismer_tpu.experts import generate as jax_gen
from prismer_tpu.experts.ocr_detection import model as jo
from prismer_tpu.experts.ocr_detection import postprocess as jax_post
from prismer_tpu.train.checkpoint import save_params_npz
from prismer_tpu_torch import tokenizer as port_tok
from prismer_tpu_torch.convert import experts as port_convert
from prismer_tpu_torch.convert.from_jax import (load_jax_variables,
                                                to_jax_variables)
from prismer_tpu_torch.data.features import get_feature_tables
from prismer_tpu_torch.data import png
from prismer_tpu_torch.experts import clip_text as port_clip
from prismer_tpu_torch.experts import generate as port_gen
from prismer_tpu_torch.experts import model_bank as port_bank
from prismer_tpu_torch.experts.ocr_detection import model as po
from prismer_tpu_torch.experts.ocr_detection import postprocess as port_post
from prismer_tpu_torch.experts.ocr_detection.fill import fill_poly
from test_torch_expert_generate import (IMAGES, _expert_args, _jax_loader,
                                        _port_loader, _read_label,
                                        image_root)
from torch_expert_util import assert_trees_equal, rel_l2, run_both, seeded

torch.set_num_threads(2)

RES = 64
BLOCK = 1e-5
MODEL = 1e-4


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CASES = {
    "conv_bn_relu_dilated": (lambda: jo.ConvBnRelu(16, dilation=2),
                             lambda: po.ConvBnRelu(8, 16, dilation=2),
                             (2, 9, 9, 8)),
    "residual_skip_s2": (lambda: jo.Residual(16, stride=2),
                         lambda: po.Residual(8, 16, 2), (2, 9, 9, 8)),
    "residual_identity": (lambda: jo.Residual(16),
                          lambda: po.Residual(16, 16), (2, 5, 5, 16)),
    "res_layer": (lambda: jo.ResLayer(16, 2), lambda: po.ResLayer(8, 16, 2),
                  (2, 5, 5, 8)),
    "res_layer_revr": (lambda: jo.ResLayer(8, 2, revr=True),
                       lambda: po.ResLayer(16, 8, 2, revr=True),
                       (2, 5, 5, 16)),
    "hourglass_n1": (lambda: jo.HourGlassBlock(1, (8, 16), (2, 2)),
                     lambda: po.HourGlassBlock(1, 8, (8, 16), (2, 2)),
                     (2, 8, 8, 8)),
    "hourglass_n2": (lambda: jo.HourGlassBlock(2, (8, 8, 16), (1, 1, 1)),
                     lambda: po.HourGlassBlock(2, 8, (8, 8, 16), (1, 1, 1)),
                     (1, 8, 8, 8)),
    "det_head_word": (lambda: jo.DetHead(True), lambda: po.DetHead(32, True),
                      (2, 6, 6, 32)),
    "det_head_char": (lambda: jo.DetHead(False),
                      lambda: po.DetHead(32, False), (2, 6, 6, 32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    jax_mod, port_mod, shape = CASES[name]
    want, got = run_both(jax_mod(), port_mod(), _x(shape), seed=3)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert rel_l2(g, w) < BLOCK


def test_charnet_matches_jax():
    want, got = run_both(jo.CharNet(), po.CharNet(device="cpu"),
                         _x((2, RES, RES, 3)), seed=7)
    assert sorted(got) == sorted(want)
    assert want["char_cls"].shape == (2, 16, 16, 68)
    for k in want:
        assert rel_l2(got[k], want[k]) < MODEL, k


def _word_maps(seed, h=24, w=32):
    """CharNet-like maps with two bright word regions, each holding 3x3
    clusters of char foreground every 4 columns with one peaked class a
    cluster, so the decode keeps words (the second region's classes are
    less sure, so the lexicon's correction runs on them)."""
    rng = np.random.default_rng(seed)
    fg = np.full((h, w), 0.05, np.float32)
    char_fg = np.full((h, w), 0.02, np.float32)
    logits = rng.normal(0, 1, (h, w, 68))
    for (y0, y1, x0, x1), p, peak in (((4, 9, 3, 20), 0.9, 12),
                                      ((14, 19, 8, 28), 0.8, 7)):
        fg[y0:y1, x0:x1] = p
        yc = (y0 + y1) // 2
        for xc in range(x0 + 1, x1 - 1, 4):
            char_fg[yc - 1:yc + 2, xc - 1:xc + 2] = 0.8
            logits[yc - 1:yc + 2, xc - 1:xc + 2, rng.integers(10, 36)] += peak
    fg += rng.uniform(0, 0.05, fg.shape).astype(np.float32)
    tblr = np.abs(rng.normal([2, 2, 4, 4], 0.3, (h, w, 4))).astype(
        np.float32)
    orient = rng.normal(0, 0.05, (h, w, 1)).astype(np.float32)
    cls = np.exp(logits - logits.max(-1, keepdims=True))
    cls = (cls / cls.sum(-1, keepdims=True)).astype(np.float32)
    return {"word_fg": np.stack([1 - fg, fg], -1),
            "word_tblr": tblr, "word_orient": orient,
            "char_fg": np.stack([1 - char_fg, char_fg], -1),
            "char_tblr": np.abs(rng.normal(2.5, 0.1, (h, w, 4))).astype(
                np.float32),
            "char_cls": cls}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lexicon", [None, ["STOP", "EXIT", "ABC"]])
def test_host_decode_is_bit_equal(seed, lexicon):
    maps = _word_maps(seed)
    kw = dict(scale_w=640 / 480, scale_h=480 / 480, W=640, H=480)
    want = jax_post.OrientedTextPostProcessing(lexicon=lexicon)(maps, **kw)
    got = port_post.OrientedTextPostProcessing(lexicon=lexicon)(maps, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.word_bbox, w.word_bbox)
        np.testing.assert_array_equal(g.char_scores, w.char_scores)
        assert (g.text, g.text_score, g.word_bbox_score, g.text_edst) == (
            w.text, w.text_score, w.word_bbox_score, w.text_edst)


def test_host_decode_keeps_words_on_these_maps():
    kw = dict(scale_w=1.0, scale_h=1.0, W=480, H=480)
    words = port_post.OrientedTextPostProcessing()(_word_maps(0), **kw)
    assert words and all(w.text for w in words)
    fixed = port_post.OrientedTextPostProcessing(lexicon=["STOP", "EXIT"])(
        _word_maps(0), **kw)
    assert 0 < len(fixed) < len(words)     # corrected, then refused


def _quads(rng, n):
    """Random int32 quads on random canvases: inside, past every border,
    rotated rectangles rounded, and degenerate (repeated points, lines)."""
    for i in range(n):
        h, w = (int(v) for v in rng.integers(1, 120, 2))
        kind = i % 4
        if kind == 0:
            pts = np.stack([rng.integers(0, w, 4), rng.integers(0, h, 4)], 1)
        elif kind == 1:
            m = int(rng.choice([3, 40, 300]))
            pts = np.stack([rng.integers(-m, w + m, 4),
                            rng.integers(-m, h + m, 4)], 1)
        elif kind == 2:
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            a, b, th = rng.uniform(0, 40), rng.uniform(0, 10), rng.uniform(
                0, np.pi)
            c, s = np.cos(th), np.sin(th)
            pts = np.array([[cx + c * x - s * y, cy + s * x + c * y]
                            for x, y in ((-a, -b), (a, -b), (a, b), (-a, b))]
                           ).round()
        else:
            p = np.stack([rng.integers(-5, w + 5, 2),
                          rng.integers(-5, h + 5, 2)], 1)
            pts = p[[0, 1, 1, 0]] if i % 8 == 3 else p[[0, 0, 1, 1]]
        yield h, w, pts.astype(np.int32)


def test_fill_poly_equals_cv2_fill_poly():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for h, w, pts in _quads(rng, 4000):
        want = np.full((h, w), 255, np.uint8)
        cv2.fillPoly(want, [pts], 3)
        got = np.full((h, w), 255, np.uint8)
        fill_poly(got, pts, 3)
        assert np.array_equal(got, want), (h, w, pts.tolist())


MIXED = ["Hello, World! 123", "&amp;lt;b&amp;gt;bold&amp;lt;/b&amp;gt; "
         "don't STOP", "naïve café — 東京タワー ’s ſt", "tab\tand\nnewline  ",
         "1,234.56 $%^ _under_score__", "the cat and the dog " * 40,
         "ｆｕｌｌｗｉｄｔｈ Ǆ ǅ ǆ ß ﬁ", "é ä ال"
         "عربية \U0001F600 ²Ⅳ", ""]


def test_clip_tokenizer_ids_equal_jax():
    want = jax_tok.synthetic_clip_tokenizer()(MIXED)
    got = port_tok.synthetic_clip_tokenizer()(MIXED)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (len(MIXED), 77)


def test_clip_split_pattern_equals_jax_on_every_code_point():
    seps = [" ", "a", "1", "_", "'s", "-", "́", "x9"]
    text = "".join(chr(c) + seps[c % len(seps)] for c in range(0x110000)
                   if not 0xD800 <= c <= 0xDFFF)
    assert port_tok._CLIP_PAT.findall(text) == jax_tok._CLIP_PAT.findall(
        text)


@pytest.mark.parametrize("gz", [False, True])
def test_clip_tokenizer_from_file_equals_jax(tmp_path, gz):
    import gzip
    merges = port_tok.CLIP_SYNTHETIC_MERGES
    path = tmp_path / ("vocab.txt.gz" if gz else "vocab.txt")
    body = "#version: synthetic\n" + "".join(f"{a} {b}\n" for a, b in merges)
    (gzip.open if gz else open)(path, "wt", encoding="utf-8").write(body)
    want = jax_tok.CLIPTokenizer.from_file(str(path))
    got = port_tok.CLIPTokenizer.from_file(str(path))
    assert got.encoder == want.encoder and got.vocab_size == want.vocab_size
    np.testing.assert_array_equal(got(MIXED), want(MIXED))


def _clip_ids(vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((n, 77), np.int32)
    for i in range(n):
        k = int(rng.integers(2, 20))
        ids[i, :k] = rng.integers(1, vocab - 1, k)
        ids[i, k] = vocab - 1                       # <|endoftext|>
    return ids


def test_clip_text_encoder_matches_jax():
    kw = dict(vocab_size=100, width=64, layers=2, heads=2)
    want, got = run_both(jax_clip.CLIPTextEncoder(**kw),
                         port_clip.CLIPTextEncoder(**kw),
                         _clip_ids(100), seed=5)
    assert want.shape == (4, 64)
    assert rel_l2(got, want) < BLOCK


def _synth_clip_sd(vocab, width, layers):
    sd = {"token_embedding.weight": synth._rand((vocab, width)),
          "positional_embedding": synth._rand((77, width)) * 0.01,
          "text_projection": synth._rand((width, width)) * 0.05,
          "ln_final.weight": synth._rand((width,)),
          "ln_final.bias": synth._rand((width,))}
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        for name, shape in (("attn.in_proj_weight", (3 * width, width)),
                            ("attn.in_proj_bias", (3 * width,)),
                            ("attn.out_proj.weight", (width, width)),
                            ("attn.out_proj.bias", (width,)),
                            ("ln_1.weight", (width,)), ("ln_1.bias", (width,)),
                            ("ln_2.weight", (width,)), ("ln_2.bias", (width,)),
                            ("mlp.c_fc.weight", (4 * width, width)),
                            ("mlp.c_fc.bias", (4 * width,)),
                            ("mlp.c_proj.weight", (width, 4 * width)),
                            ("mlp.c_proj.bias", (width,))):
            sd[f"{p}.{name}"] = synth._rand(shape) / np.float32(
                np.sqrt(shape[-1]))
    return sd


def test_clip_converter_equals_jax():
    sd = _synth_clip_sd(60, 32, 3)
    assert_trees_equal(port_clip.convert_clip_text(sd),
                       jax_clip.convert_clip_text(sd))


def test_embed_words_equals_jax(tmp_path, monkeypatch):
    """The weights and vocabulary files under PRISMER_EXPERT_WEIGHTS, read
    by both packages' `load_clip_text`: the same (N, 64) word features."""
    vocab = tmp_path / "bpe_simple_vocab_16e6.txt"
    vocab.write_text("#version: synthetic\n" + "".join(
        f"{a} {b}\n" for a, b in port_tok.CLIP_SYNTHETIC_MERGES))
    n_vocab = port_tok.synthetic_clip_tokenizer().vocab_size
    sd = _synth_clip_sd(n_vocab, 768, 2)
    tree = port_clip.convert_clip_text(sd)
    save_params_npz(str(tmp_path / port_clip.CLIP_TEXT_WEIGHTS), tree)
    monkeypatch.setenv("PRISMER_EXPERT_WEIGHTS", str(tmp_path))
    assert port_clip.load_clip_text(str(tmp_path / "absent"), "cpu") is None
    words = ["stop", "THE", "cat", "dog and the cat", "x"]
    want = jax_clip.embed_words(words, jax_clip.load_clip_text(),
                                jax_tables())
    ctx = port_clip.load_clip_text(device="cpu")
    got = port_clip.embed_words(words, ctx, get_feature_tables())
    assert got.shape == (5, 64) and got.dtype == np.float32
    assert rel_l2(got, want) < BLOCK


def test_clip_vit_l14_text_tree_loads_into_a_meta_port_model():
    shapes = jax.eval_shape(jax_clip.CLIPTextEncoder().init,
                            jax.random.key(0), jnp.zeros((1, 77), jnp.int32))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                         shapes)
    port = port_clip.CLIPTextEncoder(device="meta")
    load_jax_variables(port, zeros)
    assert len(port.state_dict()) == len(jax.tree.leaves(shapes))
    assert port_clip.text_encoder_shape(zeros["params"]) == dict(
        vocab_size=49408, width=768, layers=12, heads=12, context=77)


def test_converter_equals_jax_and_load_expert_model_reads_it(tmp_path,
                                                             monkeypatch):
    shapes = jax.eval_shape(jo.CharNet().init, jax.random.key(0),
                            jnp.zeros((1, RES, RES, 3)))
    sd = synth.synth_charnet_sd(shapes)
    tree = port_convert.convert_charnet(sd)
    assert_trees_equal(tree, jax_convert.convert_charnet(sd))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()},
               tmp_path / port_bank.WEIGHTS["ocr_detection"])
    monkeypatch.setenv("PRISMER_EXPERT_WEIGHTS", str(tmp_path))
    monkeypatch.setattr(port_bank, "_build", lambda task, device: po.CharNet(
        device="meta").to_empty(device=device))
    model, _ = port_bank.load_expert_model("ocr_detection", RES, "cpu")
    assert_trees_equal(to_jax_variables(model.state_dict()), tree)


def test_full_width_tree_loads_into_a_meta_port_model():
    shapes = jax.eval_shape(jo.CharNet().init, jax.random.key(0),
                            jnp.zeros((1, 480, 480, 3)))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                         shapes)
    port = po.CharNet(device="meta")
    load_jax_variables(port, zeros)
    assert len(port.state_dict()) == len(jax.tree.leaves(shapes))


# the generator task

def _write_clip_assets(weights_dir):
    """A BPE vocabulary file (the synthetic merges, with the header line)
    and converted CLIP text weights (768 wide, as the PCA reads them)."""
    (weights_dir / "bpe_simple_vocab_16e6.txt").write_text(
        "#version: synthetic\n" + "".join(
            f"{a} {b}\n" for a, b in port_tok.CLIP_SYNTHETIC_MERGES))
    n_vocab = port_tok.synthetic_clip_tokenizer().vocab_size
    save_params_npz(str(weights_dir / port_clip.CLIP_TEXT_WEIGHTS),
                    port_clip.convert_clip_text(_synth_clip_sd(n_vocab, 768,
                                                               1)))


def _sidecar(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_ocr_labels_match_jax_generator(image_root, tmp_path, monkeypatch):
    """Both generators with the same CharNet weights (words made likely by
    larger foreground biases, boxes of a few cells and one dominant char
    class) at 32 px, with
    CLIP text weights and a vocabulary under PRISMER_EXPERT_WEIGHTS: equal
    id masks (the JAX side fills with cv2), sidecars with the same words
    and their features within 1e-5 (relative L2)."""
    res = 32
    variables = seeded(jax.eval_shape(jo.CharNet().init, jax.random.key(0),
                                      jnp.zeros((1, res, res, 3))), 31)
    p = variables["params"]
    for head in ("word_detector", "char_detector"):
        p[head]["fg_pred"]["bias"][:] = [-2.0, 2.0]
        p[head]["tblr_pred"]["kernel"] *= 0.1
        p[head]["tblr_pred"]["bias"][:] = 0.8
    p["recog_cls"]["bias"][20] += 12.0
    port = po.CharNet(device="cpu").eval()
    load_jax_variables(port, variables)
    weights = tmp_path / "weights"
    weights.mkdir()
    _write_clip_assets(weights)
    monkeypatch.setenv("PRISMER_EXPERT_WEIGHTS", str(weights))
    monkeypatch.setattr(jax_gen, "load_expert_model", _jax_loader(
        jax.jit(jo.CharNet().apply), variables, "ocr_detection"))
    monkeypatch.setattr(port_gen, "load_expert_model",
                        _port_loader(port, "ocr_detection"))
    for out, gen in (("jax", jax_gen), ("port", port_gen)):
        gen.run_ocr(_expert_args(image_root, tmp_path / out,
                                 image_size=res))
    words = 0
    for folder, name, _, (w, h) in IMAGES:
        rel = os.path.join("ocr_detection", "data", folder, name)
        assert ((tmp_path / "jax" / rel).exists()
                == (tmp_path / "port" / rel).exists())
        if not (tmp_path / "jax" / rel).exists():
            continue
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "port"
                                                       / rel)),
                                      _read_label(tmp_path / "jax" / rel))
        side = rel.replace(".png", ".pt")
        want = _sidecar(tmp_path / "jax" / side)
        got = _sidecar(tmp_path / "port" / side)
        assert sorted(got) == sorted(want)
        for k in want:
            if k.startswith("text_"):
                assert str(got[k]) == str(want[k])
            else:
                assert got[k].dtype == np.float32 and got[k].shape == (64,)
                assert rel_l2(got[k], want[k]) < 1e-5
        words += len(want) // 2
    assert words >= 1, words
