"""Corpus BLEU (Papineni et al., 2002) — the BLEU-1..4 slots of the COCO
caption report (utils.py:38-40 prints pycocoevalcap's Bleu)."""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence

from prismer_tpu_torch.evals.cider import tokenize


def _ngram_counts(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(candidates: Dict[str, str],
                references: Dict[str, Sequence[str]],
                max_n: int = 4) -> List[float]:
    """Returns [BLEU-1, ..., BLEU-max_n] with closest-ref-length brevity
    penalty and clipped modified precision."""
    match = [0] * (max_n + 1)
    total = [0] * (max_n + 1)
    cand_len_sum = 0
    ref_len_sum = 0
    for i, cand in candidates.items():
        ct = tokenize(cand)
        refs = [tokenize(r) for r in references[i]]
        cand_len_sum += len(ct)
        ref_len_sum += min((abs(len(r) - len(ct)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cc = _ngram_counts(ct, n)
            max_ref = Counter()
            for r in refs:
                rc = _ngram_counts(r, n)
                for g, c in rc.items():
                    max_ref[g] = max(max_ref[g], c)
            total[n] += sum(cc.values())
            match[n] += sum(min(c, max_ref[g]) for g, c in cc.items())

    bp = (1.0 if cand_len_sum > ref_len_sum
          else math.exp(1 - ref_len_sum / max(cand_len_sum, 1)))
    out = []
    log_sum = 0.0
    for n in range(1, max_n + 1):
        p = match[n] / total[n] if total[n] else 0.0
        log_sum += math.log(p) if p > 0 else -1e9
        out.append(bp * math.exp(log_sum / n))
    return out
