"""Byte-level BPE tokenizer (RoBERTa / GPT-2 family), ported from
prismer_tpu/tokenizer.py.

Given RoBERTa's `vocab.json` and `merges.txt` it tokenizes as the JAX
package does (byte-level BPE after the GPT-2 split pattern); tests use
`synthetic_tokenizer()`. `__call__` returns fixed-length right-padded int32
arrays.

RoBERTa specifics, as in JAX:
  * specials: <s>=0, <pad>=1, </s>=2, <unk>=3, <mask>;
  * encode(text) = [<s>] + bpe(text) + [</s>] unless add_special_tokens=False;
  * right padding with <pad>, attention_mask 1 on real tokens.

The JAX package splits text with the `regex` package's `\\p{L}`, `\\p{N}` and
`\\s`. The port does not need `regex`: it writes the same pattern for
Python's `re` over the code-point ranges of `unicode_classes.py`, which
tools/gen_unicode_classes.py generates from `regex` (Python's `\\s` also
takes U+001C-U+001F, and `unicodedata` follows an older Unicode).

`CLIPTokenizer` is OpenAI CLIP's SimpleTokenizer, as the JAX package has
it; its split pattern's classes come from the same table.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from prismer_tpu_torch.unicode_classes import (CLIP_DIGIT_RANGES,
                                               CLIP_LETTER_RANGES,
                                               CLIP_OTHER_RANGES,
                                               LETTER_RANGES, NUMBER_RANGES,
                                               SPACE_RANGES)


def _char_class(ranges: Sequence[Tuple[int, int]]) -> str:
    """The body of an `re` character class matching `ranges`."""
    return "".join(f"\\U{a:08X}" if a == b else f"\\U{a:08X}-\\U{b:08X}"
                   for a, b in ranges)


_L = _char_class(LETTER_RANGES)
_N = _char_class(NUMBER_RANGES)
_S = _char_class(SPACE_RANGES)
# 's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
# with the classes spelled out; both engines try the alternatives in order
# and backtrack the same way
_SPLIT_PATTERN = re.compile(
    rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{_L}]+| ?[{_N}]+| ?[^{_S}{_L}{_N}]+"
    rf"|[{_S}]+(?![^{_S}])|[{_S}]+")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@dataclasses.dataclass
class Encoding:
    input_ids: np.ndarray       # (B, L) int32
    attention_mask: np.ndarray  # (B, L) int32


class BPETokenizer:
    bos_token = "<s>"
    eos_token = "</s>"
    pad_token = "<pad>"
    unk_token = "<unk>"
    mask_token = "<mask>"

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]]):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}

        self.bos_token_id = self.vocab[self.bos_token]
        self.eos_token_id = self.vocab[self.eos_token]
        self.pad_token_id = self.vocab[self.pad_token]
        self.unk_token_id = self.vocab.get(self.unk_token, 3)
        self.special_ids = {self.bos_token_id, self.eos_token_id,
                            self.pad_token_id, self.unk_token_id}
        if self.mask_token in self.vocab:
            self.special_ids.add(self.vocab[self.mask_token])

    # -- construction -----------------------------------------------------
    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str) -> "BPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_pretrained_dir(cls, path: str) -> "BPETokenizer":
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"))

    # -- BPE core ---------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token)
        if len(word) == 1:
            self._cache[token] = [token]
            return [token]
        while True:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
        out = list(word)
        self._cache[token] = out
        return out

    def _split_specials(self, text: str) -> List[Tuple[str, bool]]:
        """Split text around literal special-token strings (HF added-token
        behaviour): '<s>Is it red?' and ' cat</s>' spell specials inline."""
        specials = [self.bos_token, self.eos_token, self.pad_token,
                    self.unk_token, self.mask_token]
        pattern = "(" + "|".join(re.escape(s) for s in specials
                                 if s in self.vocab) + ")"
        out: List[Tuple[str, bool]] = []
        for piece in re.split(pattern, text):
            if not piece:
                continue
            is_special = piece in self.vocab and piece in specials
            # RoBERTa's <mask> is an lstrip=True added token: whitespace
            # before it is consumed
            if is_special and piece == self.mask_token and out \
                    and not out[-1][1]:
                out[-1] = (out[-1][0].rstrip(" "), False)
                if not out[-1][0]:
                    out.pop()
            out.append((piece, is_special))
        return out

    def tokenize(self, text: str) -> List[str]:
        toks: List[str] = []
        for segment, is_special in self._split_specials(text):
            if is_special:
                toks.append(segment)
                continue
            for piece in _SPLIT_PATTERN.findall(segment):
                mapped = "".join(self.byte_encoder[b]
                                 for b in piece.encode("utf-8"))
                toks.extend(self._bpe(mapped))
        return toks

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab.get(t, self.unk_token_id)
               for t in self.tokenize(text)]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    def decode(self, ids: Iterable[int],
               skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                continue
            toks.append(self.inv_vocab.get(i, self.unk_token))
        text = "".join(toks)
        data = bytearray(self.byte_decoder.get(c, ord("?")) for c in text)
        return data.decode("utf-8", errors="replace")

    # -- batched, statically padded entry point ---------------------------
    def __call__(self, texts: Sequence[str], padding: str = "longest",
                 max_length: Optional[int] = None, truncation: bool = False,
                 add_special_tokens: bool = True,
                 pad_to_multiple_of: Optional[int] = None) -> Encoding:
        seqs = [self.encode(t, add_special_tokens=add_special_tokens)
                for t in texts]
        if truncation and max_length is not None:
            trunc = []
            for s in seqs:
                if len(s) > max_length:
                    s = s[:max_length]
                    if add_special_tokens:
                        s = s[:-1] + [self.eos_token_id]
                trunc.append(s)
            seqs = trunc
        if padding == "max_length":
            if max_length is None:
                raise ValueError("padding='max_length' needs max_length")
            target = max_length
        else:  # 'longest'
            target = max(1, max(len(s) for s in seqs))
            if max_length is not None:
                target = min(target, max_length) if truncation else target
        if pad_to_multiple_of:
            target = -(-target // pad_to_multiple_of) * pad_to_multiple_of
        ids = np.full((len(seqs), target), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(seqs), target), dtype=np.int32)
        for r, s in enumerate(seqs):
            s = s[:target]
            ids[r, :len(s)] = s
            mask[r, :len(s)] = 1
        return Encoding(input_ids=ids, attention_mask=mask)


def _candidate_dirs() -> List[str]:
    dirs = []
    env = os.environ.get("PRISMER_TOKENIZER_DIR")
    if env:
        dirs.append(env)
    dirs.append(os.path.join(os.path.dirname(__file__), "assets",
                             "tokenizer"))
    hf_home = os.environ.get("HF_HOME",
                             os.path.expanduser("~/.cache/huggingface"))
    for name in ("roberta-base", "roberta-large"):
        dirs.append(os.path.join(hf_home, name))
    return dirs


def load_tokenizer(name: str = "roberta-base") -> BPETokenizer:
    """Locate vocab.json / merges.txt (PRISMER_TOKENIZER_DIR, the package's
    assets/tokenizer, the HF cache); RoBERTa-base and -large share one
    vocabulary."""
    for d in _candidate_dirs():
        if (os.path.exists(os.path.join(d, "vocab.json"))
                and os.path.exists(os.path.join(d, "merges.txt"))):
            return BPETokenizer.from_pretrained_dir(d)
    raise FileNotFoundError(
        "RoBERTa vocab.json/merges.txt not found. Set PRISMER_TOKENIZER_DIR "
        "or place them under prismer_tpu_torch/assets/tokenizer/.")


def synthetic_tokenizer(vocab_size: int = 512) -> BPETokenizer:
    """Deterministic tiny tokenizer for tests: specials + printable bytes +
    a few merges. Not RoBERTa-compatible; exercises the same code paths."""
    byte_chars = list(bytes_to_unicode().values())
    tokens = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
    tokens += byte_chars
    merges = [("Ġ", "t"), ("Ġt", "h"), ("Ġth", "e"), ("t", "h"),
              ("i", "n"), ("a", "n"), ("o", "n"), ("e", "r"), ("Ġ", "a"),
              ("Ġ", "s"), ("r", "e"), ("a", "t"), ("o", "r"), ("e", "n"),
              ("Ġa", "n"), ("th", "e")]
    for a, b in merges:
        tokens.append(a + b)
    tokens = tokens[:vocab_size]
    vocab = {t: i for i, t in enumerate(tokens)}
    kept = [m for m in merges if m[0] in vocab and m[1] in vocab
            and (m[0] + m[1]) in vocab]
    return BPETokenizer(vocab, kept)


# ---------------------------------------------------------------------------
# CLIP text tokenizer (OpenAI SimpleTokenizer), ported from
# prismer_tpu/tokenizer.py
# ---------------------------------------------------------------------------

# <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+|_+
# under IGNORECASE in `regex`: the literals keep the flag, the classes are
# the sets `regex` matches with it
_CLIP_PAT = re.compile(
    r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)"
    rf"|[{_char_class(CLIP_LETTER_RANGES)}]+"
    rf"|[{_char_class(CLIP_DIGIT_RANGES)}]"
    rf"|[{_char_class(CLIP_OTHER_RANGES)}]+|_+")


class CLIPTokenizer:
    """OpenAI CLIP's SimpleTokenizer, which the reference's OCR generator
    calls (clip.tokenize of the recognised words): the byte -> unicode map,
    BPE with a word-final '</w>', vocabulary = 256 bytes + 256 byte+'</w>'
    + one token per merge + <|startoftext|> / <|endoftext|>; context 77,
    zero-padded.

    The merges come from bpe_simple_vocab_16e6.txt(.gz);
    `synthetic_clip_tokenizer` builds a tiny stand-in for tests."""

    def __init__(self, merges: List[Tuple[str, str]], context: int = 77):
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.context = context
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_file(cls, path: str, context: int = 77) -> "CLIPTokenizer":
        """bpe_simple_vocab_16e6.txt(.gz): the first line is a version
        header; CLIP reads merges[1 : 49152 - 256 - 2 + 1]."""
        import gzip
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        lines = lines[1: 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines if line.strip()]
        return cls(merges, context)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        res = list(word)
        self._cache[token] = res
        return res

    def encode(self, text: str) -> List[int]:
        import html
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids: List[int] = []
        for tok in _CLIP_PAT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """clip.tokenize: (N, 77) int32, <sot> ids <eot>, zero-padded;
        over-long inputs truncated with the <eot> kept."""
        out = np.zeros((len(texts), self.context), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: self.context - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


CLIP_SYNTHETIC_MERGES = (
    ("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("i", "n"),
    ("o", "n</w>"), ("e", "r</w>"), ("s", "t"), ("c", "a"), ("ca", "t</w>"),
    ("d", "o"), ("do", "g</w>"))


def synthetic_clip_tokenizer(context: int = 77) -> CLIPTokenizer:
    """Tiny deterministic CLIP-style tokenizer for tests (the same
    mechanics, a handful of merges)."""
    return CLIPTokenizer(list(CLIP_SYNTHETIC_MERGES), context)
