"""VQA fine-tune / eval driver, ported from prismer_tpu/cli/train_vqa.py
(reference: train_vqa.py).

  python -m prismer_tpu_torch.cli.train_vqa \\
      --config prismer_tpu/configs/vqa.yaml --exp_name exp [--evaluate] \\
      [--device cuda|cpu]

Training weights each sample's loss (VQAv2's answer weights, 0.2 for VG).
Eval ranks the dataset's answer list (`inference: rank`, k_test from the
config) or generates answers (any other `inference`), and writes
vqa_results_{exp}.json in the EvalAI submission format (train_vqa.py:
165-173): [{'question_id': int, 'answer': str}].
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from prismer_tpu_torch.cli import common
from prismer_tpu_torch.data import create_dataset, create_loader
from prismer_tpu_torch.models import caption as caption_head
from prismer_tpu_torch.models import vqa as vqa_head
from prismer_tpu_torch.parallel.zero import full_params
from prismer_tpu_torch.train import build_train_step
from prismer_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from prismer_tpu_torch.train.schedules import per_step_cosine


def prepare_train_batch(batch, tokenizer, device="cuda") -> Dict[str, Any]:
    """[question ; answer] ids, targets on the answer span, and the
    per-sample weights."""
    ids, mask, targets = vqa_head.vqa_training_batch(
        tokenizer, batch["question"], batch["answer"])
    return {
        "experts": common.experts_to_device(batch["experts"], device),
        "input_ids": torch.from_numpy(ids).to(device),
        "attention_mask": torch.from_numpy(mask).to(device),
        "targets": torch.from_numpy(targets).to(device),
        "weights": torch.from_numpy(
            np.asarray(batch["weight"], np.float32)).to(device),
    }


def evaluate(model, test_loader, tokenizer, config, args):
    """[{'question_id', 'answer'}] for the test split."""
    answer_list = test_loader.dataset.answer_list
    results = []
    if config.get("inference", "rank") == "rank":
        ans = [torch.from_numpy(a).to(args.device) for a in
               caption_head.tokenize_answer_list(tokenizer, answer_list,
                                                 lowercase=False)]
        rank = caption_head.build_rank_fn(model,
                                          k_test=config.get("k_test", 128))
        for batch in test_loader:
            experts = common.experts_to_device(batch["experts"], args.device)
            q = caption_head.to_expert_device(
                experts, *vqa_head.tokenize_questions(tokenizer,
                                                      batch["question"]))
            best = rank(experts, *q, *ans).cpu().numpy()
            for qid, idx in zip(batch["question_id"], best):
                results.append({"question_id": int(qid),
                                "answer": answer_list[int(idx)]})
    else:
        answer = vqa_head.build_answer_fn(model)
        for batch in test_loader:
            experts = common.experts_to_device(batch["experts"], args.device)
            answers = vqa_head.generate_answers(answer, experts, tokenizer,
                                                batch["question"])
            for qid, ans in zip(batch["question_id"], answers):
                results.append({"question_id": int(qid), "answer": ans})
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = common.parse_args(common.base_parser("vqa"), argv)
    config, cfg, model, tokenizer = common.setup(args, "vqa", keyed=False)

    train_ds, test_ds = create_dataset("vqa", config)
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
    ckpt_dir = os.path.join(args.logging_dir, f"vqa_{args.exp_name}")
    start_epoch = 0
    if args.from_checkpoint and os.path.exists(ckpt_dir):
        state, meta = restore_checkpoint(os.path.join(ckpt_dir, "state"),
                                         state)
        start_epoch = int(meta.get("epoch", -1)) + 1

    # data parallel over every rank under --multihost; the state is placed
    # on the mesh at the first step, after any restore above
    step_fn = build_train_step(model, common.train_mesh(args),
                               common.train_mode(args))

    if not args.evaluate:
        t0 = time.time()
        for epoch in range(start_epoch, config["max_epoch"]):
            losses = []
            for batch in itertools.islice(train_loader, steps):
                state, metrics = step_fn(state, prepare_train_batch(
                    batch, tokenizer, args.device))
                losses.append(float(metrics["loss"]))
            print(f"Epoch {epoch:03d} | loss "
                  f"{np.mean(losses) if losses else 0:.4f} | "
                  f"{time.time() - t0:.0f}s")
            os.makedirs(ckpt_dir, exist_ok=True)
            save_checkpoint(os.path.join(ckpt_dir, "state"), state,
                            {"epoch": epoch})

    with full_params(state):
        results = evaluate(model, test_loader, tokenizer, config, args)
    all_results = common.gather_results(results)
    if common.is_main_process():
        path = common.dump_results(all_results, args.results_dir,
                                   f"vqa_results_{args.exp_name}.json")
        print(f"wrote {path} ({len(all_results)} answers) "
              f"— submit to EvalAI")


if __name__ == "__main__":
    main()
