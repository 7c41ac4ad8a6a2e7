"""PTB-style caption tokenization replicating pycocoevalcap's PTBTokenizer.

The reference tokenizes captions with the Java Stanford PTBTokenizer
(pycocoevalcap/tokenizer/ptbtokenizer.py, invoked from coco_caption_eval —
reference utils.py:34-41), then lowercases and removes a fixed punctuation
list. No Java in this image, so this module replicates the pipeline in pure
Python using the Treebank tokenization rules (Robert McIntyre's
tokenizer.sed, the same spec NLTK's TreebankWordTokenizer implements):

  1. Treebank split: punctuation separation, contraction splitting
     ("don't" -> "do n't", "dog's" -> "dog 's"), bracket/quote handling;
     internal hyphens and numeric commas are KEPT ("well-lit", "1,000").
  2. lowercase.
  3. drop tokens in PTBTokenizer.PUNCTUATIONS.

The previous strip-all-punctuation tokenizer is kept as simple_tokenize();
tests/test_evals.py bounds the CIDEr delta between the two on a caption
fixture (the gating-error bound VERDICT weak-#6 asked for)."""

from __future__ import annotations

import re
from typing import List

# pycocoevalcap/tokenizer/ptbtokenizer.py PUNCTUATIONS
PUNCTUATIONS = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"}

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]

_PUNCT_RULES = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # final period (not part of an abbreviation token mid-sentence)
    (re.compile(r"([^\.])(\.)([\]\)}>\"\']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

_PARENS = [
    (re.compile(r"[\]\[\(\)\{\}<>]"), r" \g<0> "),
    (re.compile(r"--"), r" -- "),
]

_ENDING_QUOTES = [
    (re.compile(r"\""), r" '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

_CONTRACTIONS2 = [
    re.compile(r"(?i)\b(can)(not)\b"),
    re.compile(r"(?i)\b(d)('ye)\b"),
    re.compile(r"(?i)\b(gim)(me)\b"),
    re.compile(r"(?i)\b(gon)(na)\b"),
    re.compile(r"(?i)\b(got)(ta)\b"),
    re.compile(r"(?i)\b(lem)(me)\b"),
    re.compile(r"(?i)\b(wan)(na)\b"),
]


# Stanford PTBTokenizer normalizes brackets to PTB escapes; pycocoevalcap's
# removal list names -LRB-/-RRB-/-LCB-/-RCB- (square brackets survive as
# -LSB-/-RSB-, same as the Java pipeline)
_BRACKETS = {"(": "-LRB-", ")": "-RRB-", "{": "-LCB-", "}": "-RCB-",
             "[": "-LSB-", "]": "-RSB-"}


def treebank_split(text: str) -> List[str]:
    """Treebank word split (pre-lowercase, punctuation kept as tokens)."""
    for pat, sub in _STARTING_QUOTES:
        text = pat.sub(sub, text)
    for pat, sub in _PUNCT_RULES:
        text = pat.sub(sub, text)
    for pat, sub in _PARENS:
        text = pat.sub(sub, text)
    text = " " + text + " "
    for pat, sub in _ENDING_QUOTES:
        text = pat.sub(sub, text)
    for pat in _CONTRACTIONS2:
        text = pat.sub(r" \1 \2 ", text)
    return [_BRACKETS.get(t, t) for t in text.split()]


def ptb_tokenize(text: str) -> List[str]:
    """Full pycocoevalcap pipeline: treebank split -> lowercase -> drop
    the punctuation-token list."""
    return [t.lower() for t in treebank_split(text)
            if t not in PUNCTUATIONS]


_STRIP_PUNCT = re.compile(r"[^\w\s]")


def simple_tokenize(text: str) -> List[str]:
    """The round-1 tokenizer (lowercase, strip punctuation, split) — kept
    for the deviation-bound fixture test."""
    return _STRIP_PUNCT.sub("", text.lower()).split()
