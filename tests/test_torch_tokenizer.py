"""The port's BPE tokenizer (prismer_tpu_torch.tokenizer) against the JAX
package's (prismer_tpu.tokenizer), which splits text with the `regex`
package. Ids, tokens, strings and padded arrays must be equal, on the
synthetic vocabulary and on a vocabulary written here that merges non-ASCII
pieces, over a Unicode corpus and random text; the pre-tokenizer must split
every code point as `regex` does; the committed class table must be what
`regex` gives today.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from prismer_tpu import tokenizer as jax_tok
from prismer_tpu_torch import tokenizer as port_tok
from prismer_tpu_torch import unicode_classes

ROOT = Path(__file__).resolve().parents[1]

CORPUS = [
    "A picture of a cat sitting on the mat",
    "",
    " ",
    "don't stop: it's what we'll do, they've said, I'm sure, you'd 're",
    "DON'T 'S 'll'll''s",
    "numbers 123 and 4,567.89 and ½ ² Ⅻ ٣ ૭ 〇 𝟘",
    "Ελληνικά κείμενα, русский текст, עברית, العربية, हिन्दी, ไทย",
    "日本語のテキスト、中文文本，한국어 텍스트",
    "café ñ Å è́ decomposed accents",
    "café naïve Ångström — precomposed",
    "emoji 🙂🙃 👩‍👩‍👧 🏳️‍🌈 and flags 🇫🇷🇩🇪",
    "runs   of  spaces    here   ",
    "tabs\tand\t\tnewlines\n\nand\r\n crlf \x0b\x0c",
    "\x1c\x1d\x1e\x1f separators \x1cx\x1d1\x1e \x1f",
    " nbsp thin　ideographic line para\u0085nel",
    "zero​width‌‍joiners﻿bom",
    "<s>hi</s>",
    "<s>Is it red?</s><pad><unk>",
    "fill the <mask> here and  <mask> there<mask>",
    "   <mask>",
    "punctuation!?...;:--((]]}}**&&^^%%$$##@@~~``||\\\\//",
    "mixed1a2b3c x1 1x a1! !1a",
    "\U0001F600\U000E0001\U0010FFFF private use",
    "ǅungla ǈ ǋ titlecase, ʰʲ modifier letters, ß ẞ",
]


def _unicode_vocab():
    """A vocabulary with merges over the byte-level pieces of non-ASCII
    text (Greek, CJK, an accent, an emoji), so BPE merges more than ASCII."""
    base = jax_tok.synthetic_tokenizer()
    enc = jax_tok.bytes_to_unicode()
    vocab = dict(base.vocab)
    merges = [m for m, _ in sorted(base.bpe_ranks.items(),
                                   key=lambda kv: kv[1])]

    def mapped(s):
        return "".join(enc[b] for b in s.encode("utf-8"))

    for word in ("Ελ", "κε", "日本", "文本", "é", "🙂", " ½"):
        pieces = list(mapped(word))
        while len(pieces) > 1:
            a, b = pieces[0], pieces[1]
            merges.append((a, b))
            vocab.setdefault(a + b, len(vocab))
            pieces = [a + b] + pieces[2:]
    return vocab, merges


@pytest.fixture(scope="module", params=["synthetic", "unicode"])
def pair(request):
    if request.param == "synthetic":
        return jax_tok.synthetic_tokenizer(), port_tok.synthetic_tokenizer()
    vocab, merges = _unicode_vocab()
    return (jax_tok.BPETokenizer(vocab, merges),
            port_tok.BPETokenizer(vocab, merges))


def test_synthetic_vocabularies_are_equal():
    a, b = jax_tok.synthetic_tokenizer(), port_tok.synthetic_tokenizer()
    assert a.vocab == b.vocab and a.bpe_ranks == b.bpe_ranks
    assert port_tok.bytes_to_unicode() == jax_tok.bytes_to_unicode()


@pytest.mark.parametrize("text", CORPUS)
def test_encode_and_decode_match_jax(pair, text):
    want, got = pair
    assert got.tokenize(text) == want.tokenize(text)
    for specials in (True, False):
        ids = want.encode(text, add_special_tokens=specials)
        assert got.encode(text, add_special_tokens=specials) == ids
        for skip in (True, False):
            assert got.decode(ids, skip_special_tokens=skip) == \
                want.decode(ids, skip_special_tokens=skip)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(padding="longest", add_special_tokens=False),
    dict(padding="max_length", max_length=40),
    dict(padding="longest", truncation=True, max_length=7),
    dict(padding="max_length", truncation=True, max_length=5,
         add_special_tokens=False),
    dict(padding="longest", max_length=3),
    dict(padding="longest", pad_to_multiple_of=8),
])
def test_call_matches_jax(pair, kw):
    want, got = pair
    a, b = want(CORPUS, **kw), got(CORPUS, **kw)
    assert b.input_ids.dtype == np.int32 and b.attention_mask.dtype == np.int32
    np.testing.assert_array_equal(b.input_ids, a.input_ids)
    np.testing.assert_array_equal(b.attention_mask, a.attention_mask)


def test_from_files_and_load_tokenizer_match_jax(tmp_path, monkeypatch):
    vocab, merges = _unicode_vocab()
    (tmp_path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
        encoding="utf-8")
    monkeypatch.setenv("PRISMER_TOKENIZER_DIR", str(tmp_path))
    want, got = jax_tok.load_tokenizer(), port_tok.load_tokenizer()
    assert got.vocab == want.vocab and got.bpe_ranks == want.bpe_ranks
    for text in CORPUS:
        assert got.encode(text) == want.encode(text)
    monkeypatch.setenv("PRISMER_TOKENIZER_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        port_tok.load_tokenizer()


_TEXT = st.lists(st.one_of(
    st.characters(),
    st.sampled_from(list(" \t\n\x1c\x1f 'sltrevmd1½<>/")),
    st.sampled_from(["<s>", "</s>", "<pad>", "<unk>", "<mask>", " <mask>",
                     "'ll", "'re", "  "])), max_size=40).map("".join)


@settings(max_examples=300, deadline=None, database=None)
@given(text=_TEXT)
def test_random_text_matches_jax(text):
    want = jax_tok.synthetic_tokenizer()
    got = port_tok.synthetic_tokenizer()
    assert port_tok._SPLIT_PATTERN.findall(text) == \
        jax_tok._SPLIT_PATTERN.findall(text)
    try:
        ids = want.encode(text)
    except UnicodeEncodeError:
        # a lone surrogate has no UTF-8 bytes: both tokenizers refuse it
        with pytest.raises(UnicodeEncodeError):
            got.encode(text)
        return
    assert got.encode(text) == ids
    assert got.decode(ids) == want.decode(ids)


def test_every_code_point_splits_as_regex_does():
    """All of U+0000-U+10FFFF (surrogates included), each code point beside
    a letter, a digit, a space, two spaces, a tab or nothing, in turn."""
    seps = ("a", "1", " ", "", "  ", "\t")
    text = "".join(chr(c) + seps[c % len(seps)] for c in range(0x110000))
    want = jax_tok._SPLIT_PATTERN.findall(text)
    got = port_tok._SPLIT_PATTERN.findall(text)
    assert len(got) == len(want)
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not bad, [(got[i], want[i]) for i in bad[:10]]


def test_committed_class_table_is_what_regex_gives():
    spec = importlib.util.spec_from_file_location(
        "gen_unicode_classes", ROOT / "tools" / "gen_unicode_classes.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    fresh = gen.class_ranges()
    assert {name: len(r) for name, r in fresh.items()} == {
        "LETTER_RANGES": 684, "NUMBER_RANGES": 146, "SPACE_RANGES": 10}
    for name, ranges in fresh.items():
        assert tuple(ranges) == getattr(unicode_classes, name), name
    # where Python's own \\s would disagree
    spaces = unicode_classes.SPACE_RANGES
    assert not any(a <= 0x1C <= b for a, b in spaces)
    assert "\x1c".isspace()
