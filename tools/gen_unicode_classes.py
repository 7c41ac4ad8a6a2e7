"""Generate prismer_tpu_torch/unicode_classes.py from the `regex` package.

    python3 tools/gen_unicode_classes.py [--check]

The GPT-2 pre-tokenizer splits text with `\\p{L}`, `\\p{N}` and `\\s` as the
`regex` package defines them; CLIP's pre-tokenizer with `[^\\W\\d_]`, `\\d` and
`[^\\s\\w]` under IGNORECASE. Python's `re` has no `\\p{...}`, its `\\s`
also takes U+001C-U+001F, and `unicodedata` follows an older Unicode than
`regex` does, so the port's tokenizer (which must not need `regex`) reads
these classes from a committed table of code-point ranges. This script
writes that table; `--check` exits 1 if the committed file differs from
what it would write.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Tuple

TARGET = (Path(__file__).resolve().parents[1] / "prismer_tpu_torch"
          / "unicode_classes.py")
CLASSES = (("LETTER_RANGES", r"\p{L}+"), ("NUMBER_RANGES", r"\p{N}+"),
           ("SPACE_RANGES", r"\s+"))
# CLIP's SimpleTokenizer classes, matched with IGNORECASE
CLIP_CLASSES = (("CLIP_LETTER_RANGES", r"[^\W\d_]+"),
                ("CLIP_DIGIT_RANGES", r"\d+"),
                ("CLIP_OTHER_RANGES", r"[^\s\w]+"))
PER_LINE = 4


def class_ranges() -> Dict[str, List[Tuple[int, int]]]:
    """{name: [(first, last), ...]}: the inclusive runs of code points that
    each class of `regex` matches, over U+0000-U+10FFFF."""
    import regex
    everything = "".join(map(chr, range(0x110000)))
    return {name: [(m.start(), m.end() - 1)
                   for m in regex.finditer(pattern, everything)]
            for name, pattern in CLASSES}


def clip_class_ranges() -> Dict[str, List[Tuple[int, int]]]:
    """As `class_ranges`, for CLIP's classes under IGNORECASE."""
    import regex
    everything = "".join(map(chr, range(0x110000)))
    return {name: [(m.start(), m.end() - 1) for m in regex.finditer(
        pattern, everything, regex.IGNORECASE)]
        for name, pattern in CLIP_CLASSES}


def render() -> str:
    import regex
    lines = [
        'r"""Code-point ranges of the character classes that the GPT-2',
        "pre-tokenizer uses, as the `regex` package "
        f"({regex.__version__}) defines them:",
        "`\\p{L}`, `\\p{N}` and `\\s`; and those of CLIP's pre-tokenizer,",
        "`[^\\W\\d_]`, `\\d` and `[^\\s\\w]` under IGNORECASE. Inclusive",
        "(first, last) pairs, sorted.",
        "",
        "Generated by tools/gen_unicode_classes.py; do not edit.",
        '"""',
        "",
    ]
    tables = {**class_ranges(), **clip_class_ranges()}
    for name, ranges in tables.items():
        lines.append(f"{name} = (")
        for i in range(0, len(ranges), PER_LINE):
            chunk = ranges[i:i + PER_LINE]
            lines.append("    " + " ".join(
                f"(0x{a:04X}, 0x{b:04X})," for a, b in chunk))
        lines.append(")")
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="compare with the committed table, write "
                        "nothing")
    args = parser.parse_args(argv)
    text = render()
    if args.check:
        same = TARGET.read_text(encoding="utf-8") == text
        print("up to date" if same else f"{TARGET} differs")
        return 0 if same else 1
    TARGET.write_text(text, encoding="utf-8")
    print(f"wrote {TARGET}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
