"""ROUGE-L, exactly pycocoevalcap's formulation (pycocoevalcap/rouge/
rouge.py, one of the five metrics the reference prints via
coco_caption_eval, utils.py:38-40):

  per image: precision_i = LCS(cand, ref_i)/|cand|, recall_i = LCS/|ref_i|
  over refs: p = max_i precision_i, r = max_i recall_i  (maxed SEPARATELY)
  score = (1 + beta^2) p r / (r + beta^2 p),  beta = 1.2
  corpus = mean over images
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from prismer_tpu_torch.evals.tokenizer import ptb_tokenize

BETA = 1.2


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[j], prev[j + 1]))
        prev = cur
    return prev[-1]


def rouge_l_sentence(cand: List[str], refs: Sequence[List[str]],
                     beta: float = BETA) -> float:
    precs, recs = [], []
    for r in refs:
        lcs = _lcs_len(cand, r)
        precs.append(lcs / max(len(cand), 1))
        recs.append(lcs / max(len(r), 1))
    p, r = max(precs), max(recs)
    if p == 0.0 or r == 0.0:
        return 0.0
    return ((1 + beta ** 2) * p * r) / (r + beta ** 2 * p)


def rouge_l(candidates: Dict, references: Dict) -> Tuple[float, Dict]:
    scores = {}
    for i, cand in candidates.items():
        scores[i] = rouge_l_sentence(ptb_tokenize(cand),
                                     [ptb_tokenize(r) for r in references[i]])
    corpus = sum(scores.values()) / max(len(scores), 1)
    return corpus, scores
