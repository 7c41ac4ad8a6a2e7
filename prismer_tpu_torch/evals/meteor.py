"""METEOR — faithful replication of the METEOR 1.5 jar's exact+stem
scoring, as run by pycocoevalcap in the reference pipeline
(`java -jar meteor-1.5.jar - - -stdio -l en -norm`, reference
utils.py:38-40).

Replicated from the published algorithm (Denkowski & Lavie 2014, "Meteor
Universal"), matching the jar's behavior stage by stage:

  * matcher stages: exact, then Porter-stem (weights 1.0 / 0.6). The jar's
    two further stages — WordNet synonymy (0.8) and the paraphrase table
    (0.6) — need resources absent from this zero-egress image and are
    DOCUMENTED OUT; since extra stages can only add matches, this scorer
    is a (tight, caption-length-text) lower-bound companion of the jar.
  * alignment: one-to-one, resolved by beam search over per-word match
    choices with the jar's priority order — (1) maximize covered words,
    (2) minimize chunks, (3) minimize the summed |i - j| match distance —
    beam width 40 (Aligner.java's default), replacing the previous
    leftmost-greedy approximation.
  * scoring: METEOR 1.5 English parameters alpha=0.85, beta=0.2,
    gamma=0.6, delta=0.75. Content/function word distinction per side:
    P = sum_m w(m) * (delta | 1-delta) / weighted candidate length (R over
    the reference), Fmean = PR / (aP + (1-a)R), penalty =
    gamma * (chunks / mean_matches)^beta, score = Fmean * (1 - penalty).
    The jar derives its function-word list from corpus frequencies; here a
    standard high-frequency English function-word list stands in
    (documented approximation — the delta split only reweights, never
    creates or removes matches).
  * aggregation: corpus score = score(SUM of per-segment sufficient
    statistics) with each segment contributing its best-scoring
    reference's statistics — the jar's aggregation, NOT a mean of
    sentence scores.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from prismer_tpu_torch.evals.tokenizer import ptb_tokenize

ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
W_EXACT, W_STEM = 1.0, 0.6
BEAM = 40

try:
    from nltk.stem.porter import PorterStemmer
    _STEM = PorterStemmer().stem
except ImportError:  # no nltk: the stem stage matches exact words only
    _STEM = lambda w: w

# High-frequency English function words (approximation of the jar's
# frequency-derived resources/function/en.words — articles, prepositions,
# conjunctions, pronouns, auxiliaries, common adverbial particles).
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both either
neither and or but nor so yet for of in on at by to from with without
about into onto over under between among through during before after
above below up down out off near behind beside against along across
around past since until upon within i you he she it we they me him her
us them my your his its our their mine yours hers ours theirs myself
yourself himself herself itself ourselves themselves who whom whose
which what where when why how be am is are was were been being have has
had having do does did doing will would shall should can could may
might must ought not n't as if than then there here also just only very
too quite rather because while although though whether unless however
's 'll 're 've 'd 'm
""".split())


def _chunks_and_dist(matches: List[Tuple[int, int]]) -> Tuple[int, int]:
    ch, dist, prev = 0, 0, None
    for ci, ri in matches:
        if prev is None or ci != prev[0] + 1 or ri != prev[1] + 1:
            ch += 1
        dist += abs(ci - ri)
        prev = (ci, ri)
    return ch, dist


def _align(cand: List[str], ref: List[str]) -> List[Tuple[int, int]]:
    """Beam search for the jar's alignment: among all one-to-one match
    sets (a pair matches if exact or stem keys agree), pick max matches,
    then min chunks, then min summed distance. Returns (ci, ri) pairs
    sorted by ci."""
    cs = [_STEM(w) for w in cand]
    rs = [_STEM(w) for w in ref]
    options = []
    for ci in range(len(cand)):
        opts = [ri for ri in range(len(ref))
                if cand[ci] == ref[ri] or cs[ci] == rs[ri]]
        options.append(opts)

    # state: (n_matches, chunks, dist, ref_used_mask, last_ci, last_ri,
    #         matches tuple); iterate candidate positions left to right so
    #         chunk counting is incremental
    beam = [(0, 0, 0, 0, -2, -2, ())]
    for ci, opts in enumerate(options):
        nxt = {}

        def push(state):
            key = (state[3], state[4], state[5])
            cur = nxt.get(key)
            rank = (-state[0], state[1], state[2])
            if cur is None or rank < (-cur[0], cur[1], cur[2]):
                nxt[key] = state

        for m, ch, dist, mask, lci, lri, ms in beam:
            push((m, ch, dist, mask, lci, lri, ms))  # skip this cand word
            for ri in opts:
                if mask >> ri & 1:
                    continue
                nch = ch + (0 if (lci == ci - 1 and lri == ri - 1) else 1)
                push((m + 1, nch, dist + abs(ci - ri), mask | (1 << ri),
                      ci, ri, ms + ((ci, ri),)))
        beam = sorted(nxt.values(),
                      key=lambda s: (-s[0], s[1], s[2]))[:BEAM]
    best = beam[0]
    return list(best[6])


def _weighted_len(words: List[str]) -> float:
    return sum(DELTA if w not in FUNCTION_WORDS else 1.0 - DELTA
               for w in words)


def segment_stats(cand: List[str], ref: List[str]) -> Dict[str, float]:
    """METEOR 1.5 sufficient statistics for one candidate/reference pair."""
    matches = _align(cand, ref)
    ch, _ = _chunks_and_dist(matches)
    twm = rwm = 0.0
    for ci, ri in matches:
        w = W_EXACT if cand[ci] == ref[ri] else W_STEM
        twm += w * (DELTA if cand[ci] not in FUNCTION_WORDS else 1.0 - DELTA)
        rwm += w * (DELTA if ref[ri] not in FUNCTION_WORDS else 1.0 - DELTA)
    return {"twm": twm, "rwm": rwm,
            "twl": _weighted_len(cand), "rwl": _weighted_len(ref),
            "m_t": float(len(matches)), "m_r": float(len(matches)),
            "chunks": float(ch)}


def score_from_stats(st: Dict[str, float]) -> float:
    if st["twl"] <= 0 or st["rwl"] <= 0 or st["twm"] <= 0 or st["rwm"] <= 0:
        return 0.0
    p = st["twm"] / st["twl"]
    r = st["rwm"] / st["rwl"]
    fmean = p * r / (ALPHA * p + (1.0 - ALPHA) * r)
    avg_m = 0.5 * (st["m_t"] + st["m_r"])
    penalty = 0.0
    if st["chunks"] > 0 and avg_m > 0:
        penalty = GAMMA * (st["chunks"] / avg_m) ** BETA
    return fmean * (1.0 - penalty)


def _best_ref(cand: List[str], refs: Sequence[List[str]]
              ) -> Tuple[float, Dict[str, float]]:
    best_s, best_st = 0.0, None
    for ref in refs:
        st = segment_stats(cand, ref)
        s = score_from_stats(st)
        if best_st is None or s > best_s:
            best_s, best_st = s, st
    if best_st is None:  # no references
        best_st = segment_stats(cand, [])
    return best_s, best_st


def meteor_sentence(cand: List[str], refs: Sequence[List[str]]) -> float:
    return _best_ref(cand, refs)[0]


def meteor(candidates: Dict, references: Dict) -> Tuple[float, Dict]:
    """(corpus score, {id: sentence score}). Corpus = score of the summed
    best-reference sufficient statistics (the jar's aggregation)."""
    scores = {}
    agg = {k: 0.0 for k in
           ("twm", "rwm", "twl", "rwl", "m_t", "m_r", "chunks")}
    for i, cand in candidates.items():
        toks = ptb_tokenize(cand)
        refs = [ptb_tokenize(r) for r in references[i]]
        s, st = _best_ref(toks, refs)
        scores[i] = s
        for k in agg:
            agg[k] += st[k]
    corpus = score_from_stats(agg) if scores else 0.0
    return corpus, scores
