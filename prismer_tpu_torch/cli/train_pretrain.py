"""Caption-objective pre-training driver, ported from prismer_tpu/cli/
train_pretrain.py (reference: train_pretrain.py).

  python -m prismer_tpu_torch.cli.train_pretrain \\
      --config prismer_tpu/configs/pretrain.yaml --exp_name exp \\
      [--device cuda|cpu]

Warmup lr over the first `warmup_steps` of epoch 0, per-epoch cosine after
(train_pretrain.py:110-120); freeze mode 'freeze_lang_vision', so only the
adaptors, cross-attention, stems, resampler and embeddings train. Targets
mask the pads only (no prompt). The state is saved every epoch.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from prismer_tpu_torch.cli import common
from prismer_tpu_torch.cli import train_caption
from prismer_tpu_torch.data import create_dataset, create_loader
from prismer_tpu_torch.train import build_train_step
from prismer_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from prismer_tpu_torch.train.schedules import pretrain_schedule


def prepare_train_batch(batch, tokenizer, pad_id: int,
                        device="cuda") -> Dict[str, Any]:
    """Captions tokenized to at most 30 tokens; targets -100 at pads."""
    return train_caption.prepare_train_batch(batch, tokenizer, 0, pad_id,
                                             device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = common.parse_args(common.base_parser("pretrain"), argv)
    config, cfg, model, tokenizer = common.setup(args, "pretrain",
                                                 keyed=False)
    dataset = create_dataset("pretrain", config)
    loader = create_loader(dataset, config["batch_size_train"],
                           num_workers=8, train=True,
                           **common.loader_shard())

    steps = common.epoch_steps(loader)
    steps_per_epoch = max(steps, 1)
    schedule = pretrain_schedule(
        config["init_lr"], config["min_lr"], config["warmup_lr"],
        config["warmup_steps"], steps_per_epoch, config["max_epoch"])
    state = common.build_state(args, config, cfg, model, schedule)
    ckpt_dir = os.path.join(args.logging_dir, f"pretrain_{args.exp_name}")
    start_epoch = 0
    if args.from_checkpoint and os.path.exists(ckpt_dir):
        state, meta = restore_checkpoint(os.path.join(ckpt_dir, "state"),
                                         state)
        start_epoch = int(meta.get("epoch", -1)) + 1

    pad_id = cfg.decoder.pad_token_id
    # data parallel over every rank under --multihost; the state is placed
    # on the mesh at the first step, after any restore above
    step_fn = build_train_step(model, common.train_mesh(args),
                               common.train_mode(args))

    t0 = time.time()
    for epoch in range(start_epoch, config["max_epoch"]):
        losses = []
        for batch in itertools.islice(loader, steps):
            state, metrics = step_fn(state, prepare_train_batch(
                batch, tokenizer, pad_id, args.device))
            losses.append(float(metrics["loss"]))
        print(f"Epoch {epoch:03d} | loss "
              f"{np.mean(losses) if losses else 0:.4f} | "
              f"{time.time() - t0:.0f}s")
        os.makedirs(ckpt_dir, exist_ok=True)
        save_checkpoint(os.path.join(ckpt_dir, "state"), state,
                        {"epoch": epoch})


if __name__ == "__main__":
    main()
