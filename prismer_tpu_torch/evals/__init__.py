"""Caption scorers, copied from prismer_tpu/evals/ with the arithmetic
unchanged: CIDEr-D, BLEU-1..4, ROUGE-L and METEOR-lite over the PTB-replica
tokenizer, and `coco_caption_eval` over the COCO ground-truth JSON."""

from prismer_tpu_torch.evals.bleu import corpus_bleu
from prismer_tpu_torch.evals.cider import CiderD
from prismer_tpu_torch.evals.coco_eval import coco_caption_eval

__all__ = ["CiderD", "corpus_bleu", "coco_caption_eval"]
