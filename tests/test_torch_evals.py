"""The port's caption scorers (prismer_tpu_torch.evals, copied from
prismer_tpu/evals with the arithmetic unchanged) return exactly what the
JAX package's return, on seeded candidates and references: the PTB-replica
tokenizer, CIDEr-D, BLEU-1..4, ROUGE-L, METEOR-lite and
`coco_caption_eval` over a COCO-format ground-truth file."""

import json

import numpy as np
import pytest

from prismer_tpu.evals import bleu as jax_bleu
from prismer_tpu.evals import cider as jax_cider
from prismer_tpu.evals import coco_eval as jax_coco
from prismer_tpu.evals import meteor as jax_meteor
from prismer_tpu.evals import rouge as jax_rouge
from prismer_tpu.evals import tokenizer as jax_tok
from prismer_tpu_torch.evals import bleu, cider, coco_eval, meteor, rouge
from prismer_tpu_torch.evals import tokenizer

WORDS = ("a man woman dog dogs running runs ran on the grassy field with "
         "frisbee red blue two people sitting sits at table eating pizza "
         "an old train station near water's edge isn't it. , ! ? (big) "
         "cats playing plays together street-side 3 10 o'clock").split()


def corpus(seed: int, n_images: int = 12, n_refs: int = 5):
    rng = np.random.default_rng(seed)

    def sentence():
        k = int(rng.integers(3, 14))
        return " ".join(rng.choice(WORDS, k))

    refs = {i: [sentence() for _ in range(n_refs)] for i in range(n_images)}
    # some candidates copy a reference, some share its words, some are new
    cands = {}
    for i in range(n_images):
        r = refs[i][0].split()
        cands[i] = (refs[i][1] if i % 3 == 0 else
                    " ".join(r[::-1]) if i % 3 == 1 else sentence())
    return cands, refs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tokenizers_equal(seed):
    cands, refs = corpus(seed)
    for text in list(cands.values()) + sum(refs.values(), []):
        assert tokenizer.ptb_tokenize(text) == jax_tok.ptb_tokenize(text)
        assert tokenizer.simple_tokenize(text) == \
            jax_tok.simple_tokenize(text)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scorers_equal(seed):
    cands, refs = corpus(seed)
    assert cider.CiderD().compute(cands, refs) == \
        jax_cider.CiderD().compute(cands, refs)
    assert bleu.corpus_bleu(cands, refs) == jax_bleu.corpus_bleu(cands, refs)
    assert rouge.rouge_l(cands, refs) == jax_rouge.rouge_l(cands, refs)
    assert meteor.meteor(cands, refs) == jax_meteor.meteor(cands, refs)


def test_coco_caption_eval_equal(tmp_path):
    cands, refs = corpus(7, n_images=16)
    gt = {"images": [{"id": i} for i in refs],
          "annotations": [{"image_id": i, "id": 100 * i + j, "caption": c}
                          for i, rs in refs.items()
                          for j, c in enumerate(rs)]}
    path = tmp_path / "coco_karpathy_test_gt.json"
    path.write_text(json.dumps(gt))
    results = [{"image_id": i, "caption": c} for i, c in cands.items()]
    got = coco_eval.coco_caption_eval(str(path), results)
    want = jax_coco.coco_caption_eval(str(path), results)
    assert got == want
    assert set(got) >= {"CIDEr", "Bleu_4", "ROUGE_L", "METEOR_lite"}
