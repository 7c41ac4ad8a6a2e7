"""COCO caption evaluation (reference: utils.py:34-41 coco_caption_eval).

Consumes the exact file formats of the reference pipeline: the COCO-format
ground-truth JSON (coco_karpathy_test_gt.json) and the results list
[{'image_id': int, 'caption': str}] that the drivers dump
(train_caption.py:160). Uses pycocoevalcap when importable (full
BLEU/METEOR/ROUGE/CIDEr/SPICE with the official tokenizer); otherwise falls
back to the native scorers — CIDEr-D, BLEU-1..4, ROUGE-L and METEOR-lite,
all over the PTB-replica tokenizer (evals/tokenizer.py). SPICE (Java scene
graphs) has no native fallback."""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Union


def _load_gt(gt: Union[str, Dict]) -> Dict[Any, List[str]]:
    if isinstance(gt, str):
        gt = json.load(open(gt))
    refs = defaultdict(list)
    for ann in gt["annotations"]:
        refs[ann["image_id"]].append(ann["caption"])
    return dict(refs)


def coco_caption_eval(gt_json: Union[str, Dict],
                      results: List[Dict[str, Any]]) -> Dict[str, float]:
    """Returns a metric dict always containing 'CIDEr' (the best-checkpoint
    gate metric, train_caption.py:163)."""
    try:  # official scorers if the environment has them
        from pycocotools.coco import COCO
        from pycocoevalcap.eval import COCOEvalCap
        import tempfile, os
        coco = COCO(gt_json if isinstance(gt_json, str) else None)
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as f:
            json.dump(results, f)
            res_path = f.name
        coco_res = coco.loadRes(res_path)
        ev = COCOEvalCap(coco, coco_res)
        ev.params["image_id"] = coco_res.getImgIds()
        ev.evaluate()
        os.unlink(res_path)
        return dict(ev.eval)
    except ImportError:
        pass

    refs = _load_gt(gt_json)
    cands = {r["image_id"]: r["caption"] for r in results
             if r["image_id"] in refs}
    refs = {i: refs[i] for i in cands}

    from prismer_tpu_torch.evals.bleu import corpus_bleu
    from prismer_tpu_torch.evals.cider import CiderD
    from prismer_tpu_torch.evals.meteor import meteor
    from prismer_tpu_torch.evals.rouge import rouge_l
    cider, _ = CiderD().compute(cands, refs)
    bleu = corpus_bleu(cands, refs)
    out = {"CIDEr": cider}
    for n, b in enumerate(bleu, start=1):
        out[f"Bleu_{n}"] = b
    out["ROUGE_L"], _ = rouge_l(cands, refs)
    # Labeled _lite so driver printouts/logs can never be mistaken for the
    # official jar METEOR (evals/meteor.py documents the approximations);
    # only the pycocoevalcap path above reports a plain "METEOR".
    out["METEOR_lite"], _ = meteor(cands, refs)
    return out
