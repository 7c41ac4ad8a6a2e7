"""Few-shot ImageNet classification driver, ported from prismer_tpu/cli/
train_classification.py (reference: train_classification.py).

  python -m prismer_tpu_torch.cli.train_classification \\
      --config prismer_tpu/configs/classification.yaml --exp_name exp \\
      [--evaluate] [--device cuda|cpu]

Caption training on 'A photo of a <class>' strings, then rank inference
over the lower-cased class names through the caption rank path (k_test
from the config), accuracy printed each epoch, the state saved on a strict
improvement (train_classification.py:132-160).
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from prismer_tpu_torch.cli import common
from prismer_tpu_torch.cli.train_caption import prepare_train_batch
from prismer_tpu_torch.data import create_dataset, create_loader
from prismer_tpu_torch.models import caption as caption_head
from prismer_tpu_torch.parallel.zero import full_params
from prismer_tpu_torch.train import build_train_step
from prismer_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from prismer_tpu_torch.train.schedules import per_step_cosine

__all__ = ["prepare_train_batch", "eval_accuracy", "main"]


def eval_accuracy(model, test_loader, tokenizer, config, args) -> float:
    """Rank accuracy over the test split, correct and total summed over
    processes."""
    prefix = config.get("prefix", "")
    rank = caption_head.build_rank_fn(model, k_test=config.get("k_test", 32))
    # answers lowercased with a prefix space (train_classification.py:139
    # uses the caption rank path, prismer_caption.py:64)
    ans = [torch.from_numpy(a).to(args.device) for a in
           caption_head.tokenize_answer_list(
               tokenizer, test_loader.dataset.answer_list, lowercase=True)]
    correct = total = 0
    for batch in test_loader:
        b = len(batch["label"])
        experts = common.experts_to_device(batch["experts"], args.device)
        prompt = caption_head.to_expert_device(
            experts, *caption_head.prefix_prompt_ids(tokenizer, prefix, b))
        pred = rank(experts, *prompt, *ans).cpu().numpy()
        want = np.asarray([int(l) for l in batch["label"]])
        correct += int((pred == want).sum())
        total += b
    agg = common.gather_results([{"c": correct, "t": total}])
    return sum(r["c"] for r in agg) / max(sum(r["t"] for r in agg), 1)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = common.parse_args(common.base_parser("classification"), argv)
    config, cfg, model, tokenizer = common.setup(args, "classification",
                                                 keyed=False)
    train_ds, test_ds = create_dataset("classification", config)
    train_loader = create_loader(train_ds, config["batch_size_train"],
                                 num_workers=8, train=True,
                                 **common.loader_shard())
    test_loader = create_loader(test_ds, config["batch_size_test"],
                                num_workers=8, train=False,
                                **common.loader_shard())

    steps = common.epoch_steps(train_loader)
    steps_per_epoch = max(steps, 1)
    schedule = per_step_cosine(config["init_lr"], config["min_lr"],
                               steps_per_epoch, config["max_epoch"])
    state = common.build_state(args, config, cfg, model, schedule)
    ckpt_dir = os.path.join(args.logging_dir,
                            f"classification_{args.exp_name}")
    start_epoch = 0
    best_acc = 0.0
    if args.from_checkpoint and os.path.exists(ckpt_dir):
        state, meta = restore_checkpoint(os.path.join(ckpt_dir, "state"),
                                         state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_acc = float(meta.get("best_acc", 0.0))

    prompt_len = caption_head.prefix_length(tokenizer,
                                            config.get("prefix", ""))
    pad_id = cfg.decoder.pad_token_id
    # data parallel over every rank under --multihost; the state is placed
    # on the mesh at the first step, after any restore above
    step_fn = build_train_step(model, common.train_mesh(args),
                               common.train_mode(args))

    t0 = time.time()
    if not args.evaluate:
        for epoch in range(start_epoch, config["max_epoch"]):
            losses = []
            for batch in itertools.islice(train_loader, steps):
                state, metrics = step_fn(state, prepare_train_batch(
                    batch, tokenizer, prompt_len, pad_id, args.device))
                losses.append(float(metrics["loss"]))
            with full_params(state):
                acc = eval_accuracy(model, test_loader, tokenizer, config,
                                    args)
            print(f"Epoch {epoch:03d} | loss "
                  f"{np.mean(losses) if losses else 0:.4f} | acc {acc:.4f} "
                  f"| {time.time() - t0:.0f}s")
            if acc > best_acc:
                best_acc = acc
                os.makedirs(ckpt_dir, exist_ok=True)
                save_checkpoint(os.path.join(ckpt_dir, "state"), state,
                                {"epoch": epoch, "best_acc": best_acc})
    else:
        acc = eval_accuracy(model, test_loader, tokenizer, config, args)
        print(f"accuracy: {acc:.4f}")


if __name__ == "__main__":
    main()
