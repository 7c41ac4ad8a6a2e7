"""Caption fine-tune / eval driver, ported from prismer_tpu/cli/
train_caption.py (reference: train_caption.py).

  python -m prismer_tpu_torch.cli.train_caption \\
      --config prismer_tpu/configs/caption.yaml --target_dataset coco \\
      --exp_name exp [--evaluate] [--from_checkpoint] [--pretrained path] \\
      [--device cuda|cpu]
  torchrun --nproc_per_node=N -m prismer_tpu_torch.cli.train_caption \\
      --multihost [--shard_grad_op | --full_shard] ...

The train step of train/step.py (AdamW over fp32 masters, the fused CE and
flash attention kernels on CUDA), data parallel over the ranks with
--multihost (each reads its shard of the data), beam search with the fused
decode kernels for eval (each rank captions its shard, rank 0 scores the
gathered results), best-CIDEr gating decided on rank 0.
Writes caption_results_{exp}_{dataset}.json into --results_dir, the train
state into {logging_dir}/caption_{exp}/state and metrics.jsonl beside it.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from prismer_tpu_torch.cli import common
from prismer_tpu_torch.data import create_dataset, create_loader
from prismer_tpu_torch.evals.coco_eval import coco_caption_eval
from prismer_tpu_torch.models import caption as caption_head
from prismer_tpu_torch.parallel.zero import full_params
from prismer_tpu_torch.train import build_train_step
from prismer_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from prismer_tpu_torch.train.metrics import MetricsLogger
from prismer_tpu_torch.train.schedules import per_step_cosine


def prepare_train_batch(batch, tokenizer, prompt_len: int, pad_id: int,
                        device="cuda") -> Dict[str, Any]:
    """Captions tokenized to at most 30 tokens; targets -100 at pads and
    over the prompt."""
    enc = tokenizer(batch["caption"], padding="longest", truncation=True,
                    max_length=caption_head.CAPTION_MAX_TOKENS)
    targets = np.where(enc.input_ids == pad_id, -100, enc.input_ids)
    targets[:, :prompt_len] = -100
    return {
        "experts": common.experts_to_device(batch["experts"], device),
        "input_ids": torch.from_numpy(enc.input_ids).to(device),
        "attention_mask": torch.from_numpy(enc.attention_mask).to(device),
        "targets": torch.from_numpy(targets).to(device),
    }


def coco_image_id(image: str) -> int:
    """The reference's id parse: `strip(".jpg")` strips those characters
    from both ends, not the suffix."""
    return int(image.split("/")[-1].strip(".jpg").split("_")[-1])


def evaluate(model, test_loader, tokenizer, config, args
             ) -> List[Dict[str, Any]]:
    """Captions for the test split in the reference's results format.
    The serving state (packed decoder weights) is built once per call,
    from the weights as they stand."""
    prefix = config.get("prefix", "")
    generate = caption_head.build_generate_fn(model)
    results = []
    for batch in test_loader:
        experts = common.experts_to_device(batch["experts"], args.device)
        captions = caption_head.generate_captions(generate, experts,
                                                  tokenizer, prefix)
        for data_id, cap in zip(batch["index"], captions):
            rec = test_loader.dataset.data_list[int(data_id)]
            if args.target_dataset == "coco":
                results.append({"image_id": coco_image_id(rec["image"]),
                                "caption": cap.capitalize() + "."})
            elif args.target_dataset == "nocaps":
                results.append({"image_id": rec["img_id"],
                                "caption": cap.capitalize() + "."})
            else:  # demo
                results.append({"image": rec["image"], "caption": cap})
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = common.parse_args(common.base_parser("caption"), argv)
    config, cfg, model, tokenizer = common.setup(args, "caption")

    train_ds, test_ds = create_dataset("caption", config)
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
    ckpt_dir = os.path.join(args.logging_dir, f"caption_{args.exp_name}")
    start_epoch = 0
    best_cider = 0.0
    if args.from_checkpoint and os.path.exists(ckpt_dir):
        state, meta = restore_checkpoint(os.path.join(ckpt_dir, "state"),
                                         state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_cider = float(meta.get("best_cider", 0.0))
        print(f"resuming from epoch {start_epoch}")

    prompt_len = caption_head.prefix_length(tokenizer,
                                            config.get("prefix", ""))
    pad_id = cfg.decoder.pad_token_id
    # data parallel over every rank under --multihost; the state is placed
    # on the mesh at the first step, after any restore above
    step_fn = build_train_step(model, common.train_mesh(args),
                               common.train_mode(args))
    metrics_log = MetricsLogger(ckpt_dir, enabled=common.is_main_process())
    results_name = (f"caption_results_{args.exp_name}_"
                    f"{args.target_dataset}.json")
    gt_path = os.path.join(config["data_path"], "coco_karpathy_test_gt.json")

    t0 = time.time()
    if not args.evaluate:
        for epoch in range(start_epoch, config["max_epoch"]):
            losses = []
            for batch in itertools.islice(train_loader, steps):
                state, metrics = step_fn(state, prepare_train_batch(
                    batch, tokenizer, prompt_len, pad_id, args.device))
                losses.append(metrics["loss"])
            train_loss = float(np.mean([float(l) for l in losses])) \
                if losses else 0.0

            with full_params(state):
                results = evaluate(model, test_loader, tokenizer, config,
                                   args)
            all_results = common.gather_results(results)
            cider = -1.0
            if common.is_main_process() and args.target_dataset == "coco":
                common.dump_results(all_results, args.results_dir,
                                    results_name)
                scores = coco_caption_eval(gt_path, all_results)
                cider = scores["CIDEr"]
                print(f"Epoch {epoch:03d} | loss {train_loss:.4f} | "
                      f"CIDEr {cider:.2f} | {time.time() - t0:.0f}s")
                metrics_log.log({"epoch": epoch, "train_loss": train_loss,
                                 **{k: float(v) for k, v in scores.items()}})
            cider = common.broadcast_from_main(cider)
            # best-CIDEr gating (train_caption.py:162-176); ties keep the
            # newest state so the first epoch always checkpoints; non-COCO
            # saves every epoch
            if args.target_dataset != "coco" or cider >= best_cider:
                best_cider = max(best_cider, cider)
                os.makedirs(ckpt_dir, exist_ok=True)
                save_checkpoint(os.path.join(ckpt_dir, "state"), state,
                                {"epoch": epoch, "best_cider": best_cider})

    with full_params(state):
        results = evaluate(model, test_loader, tokenizer, config, args)
    all_results = common.gather_results(results)
    if common.is_main_process():
        common.dump_results(all_results, args.results_dir, results_name)
        if args.target_dataset == "coco":
            print(json.dumps(coco_caption_eval(gt_path, all_results)))


if __name__ == "__main__":
    main()
