"""Text preprocessing, ported from prismer_tpu/data/text.py (the reference's
dataset/utils.py:163-187)."""

from __future__ import annotations

import re


def pre_caption(caption: str, max_words: int = 50) -> str:
    """Capitalize, strip special chars / repeated whitespace, truncate
    (dataset/utils.py:163-174)."""
    caption = re.sub(r"([.!\"()*#:;~])", " ", caption.capitalize())
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n").strip(" ")
    words = caption.split(" ")
    if len(words) > max_words:
        caption = " ".join(words[:max_words])
    return caption


def pre_question(question: str, max_words: int = 50) -> str:
    """Same cleaning + guaranteed trailing '?' (dataset/utils.py:177-187)."""
    question = re.sub(r"([.!\"()*#:;~])", " ", question.capitalize())
    question = question.strip()
    words = question.split(" ")
    if len(words) > max_words:
        question = " ".join(words[:max_words])
    if not question.endswith("?"):
        question += "?"
    return question
