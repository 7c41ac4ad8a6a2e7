"""Native CIDEr-D scorer.

The reference scores captions with pycocoevalcap (Java METEOR/SPICE +
python CIDEr) via coco_caption_eval (utils.py:34-41). This image has no
pycocoevalcap/Java, so the primary caption metric — CIDEr — is implemented
natively, following the CIDEr-D definition used by the COCO server
(Vedantam et al., CVPR 2015; the pycocoevalcap 'ciderD' variant):

  * n-grams n=1..4 of tokenized captions
  * candidate n-gram counts clipped to the reference's counts
  * tf-idf vectors (idf from the reference corpus, log(N / df))
  * per-n cosine similarity x length penalty exp(-(lc-lr)^2 / (2*sigma^2)),
    sigma=6; averaged over refs, over n, x10

Tokenization: evals/tokenizer.py's PTB replica of pycocoevalcap's
PTBTokenizer pipeline (treebank split -> lowercase -> punctuation-token
removal); the residual delta vs the round-1 strip-punctuation tokenizer is
bounded by a fixture test (tests/test_evals.py), so the best-checkpoint
gating error (train_caption.py:162-176) is quantified."""

from __future__ import annotations

import math
from collections import Counter
from typing import Callable, Dict, List, Sequence, Tuple

from prismer_tpu_torch.evals.tokenizer import ptb_tokenize as tokenize


def _ngrams(tokens: List[str], max_n: int = 4) -> Dict[int, Counter]:
    out = {}
    for n in range(1, max_n + 1):
        out[n] = Counter(tuple(tokens[i:i + n])
                         for i in range(len(tokens) - n + 1))
    return out


class CiderD:
    def __init__(self, max_n: int = 4, sigma: float = 6.0,
                 tokenizer: Callable[[str], List[str]] = tokenize):
        self.max_n = max_n
        self.sigma = sigma
        self.tokenizer = tokenizer

    def compute(self, candidates: Dict[str, str],
                references: Dict[str, Sequence[str]]) -> Tuple[float, Dict[str, float]]:
        """candidates: {image_id: caption}; references: {image_id: [refs]}.
        Returns (corpus score, per-image scores)."""
        ids = list(candidates.keys())
        tok = self.tokenizer
        ref_grams = {i: [_ngrams(tok(r), self.max_n)
                         for r in references[i]] for i in ids}
        cand_grams = {i: _ngrams(tok(candidates[i]), self.max_n)
                      for i in ids}

        # document frequency over reference *images* (any ref containing g)
        df: Dict[int, Counter] = {n: Counter() for n in range(1, self.max_n + 1)}
        for i in ids:
            for n in range(1, self.max_n + 1):
                seen = set()
                for rg in ref_grams[i]:
                    seen.update(rg[n].keys())
                for g in seen:
                    df[n][g] += 1
        log_n_images = math.log(max(len(ids), 1))

        def tfidf(grams: Counter, n: int) -> Tuple[Dict, float]:
            vec = {}
            norm = 0.0
            for g, c in grams.items():
                idf = max(log_n_images - math.log(max(df[n][g], 1)), 0.0)
                v = c * idf
                vec[g] = v
                norm += v * v
            return vec, math.sqrt(norm)

        scores = {}
        for i in ids:
            cand_len = sum(cand_grams[i][1].values())
            per_ref = []
            for rg in ref_grams[i]:
                ref_len = sum(rg[1].values())
                sim_total = 0.0
                for n in range(1, self.max_n + 1):
                    cvec, cnorm = tfidf(cand_grams[i][n], n)
                    rvec, rnorm = tfidf(rg[n], n)
                    num = 0.0
                    for g, v in cvec.items():
                        if g in rvec:
                            # CIDEr-D clips candidate counts to reference's
                            num += min(v, rvec[g]) * rvec[g]
                    if cnorm > 0 and rnorm > 0:
                        sim_total += num / (cnorm * rnorm)
                delta = cand_len - ref_len
                penalty = math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
                per_ref.append(penalty * sim_total / self.max_n)
            scores[i] = 10.0 * (sum(per_ref) / max(len(per_ref), 1))
        corpus = sum(scores.values()) / max(len(scores), 1)
        return corpus, scores
