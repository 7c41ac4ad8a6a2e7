"""Shared driver plumbing for the task CLIs, ported from
prismer_tpu/cli/common.py: argument parsing, the task config (read by path
with the port's YAML reader), the model and train state, pretrained
weights, and the cross-process collectives.

The port runs in one process on one device. `--device` (default cuda)
picks it; without a CUDA device the drivers refuse to start unless given
`--device cpu`. The multi-process flags and collectives raise
NotImplementedError: they are ROADMAP §1 item 9 (multi-GPU). With one
process the collectives return their input, as the JAX versions do when
`jax.process_count() == 1`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from prismer_tpu_torch.config import (PrismerConfig, build_prismer_config,
                                      default_config_path, load_task_config)
from prismer_tpu_torch.convert.cli import _load_sd
from prismer_tpu_torch.convert.from_jax import _leaves, torch_key_and_value
from prismer_tpu_torch.convert.torch_to_jax import convert_prismer_checkpoint
from prismer_tpu_torch.data.device import experts_to_device
from prismer_tpu_torch.models.prismer import (Prismer, build_random_prismer,
                                              random_masters)
from prismer_tpu_torch.tokenizer import BPETokenizer, load_tokenizer
from prismer_tpu_torch.train import TrainState
from prismer_tpu_torch.train.checkpoint import load_params_npz
from prismer_tpu_torch.train.schedules import Schedule

MULTI_PROCESS = "ROADMAP §1 item 9 (multi-GPU)"
MULTI_PROCESS_FLAGS = ("multihost", "shard_grad_op", "full_shard")

__all__ = ["base_parser", "parse_args", "setup", "load_pretrained",
           "build_state", "experts_to_device", "gather_for_metrics",
           "gather_results", "broadcast_from_main", "is_main_process",
           "dump_results"]


def base_parser(task: str) -> argparse.ArgumentParser:
    """The JAX drivers' flags (reference train_caption.py:28-41) and
    `--device`."""
    p = argparse.ArgumentParser(description=f"prismer_tpu_torch {task}")
    p.add_argument("--config", default=default_config_path(task))
    p.add_argument("--target_dataset", default="coco")
    p.add_argument("--exp_name", default="", type=str)
    p.add_argument("--from_checkpoint", action="store_true")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--shard_grad_op", action="store_true",
                   help="ZeRO-2 (not ported: " + MULTI_PROCESS + ")")
    p.add_argument("--full_shard", action="store_true",
                   help="ZeRO-3 (not ported: " + MULTI_PROCESS + ")")
    p.add_argument("--mixed_precision", default="bf16",
                   choices=["bf16", "fp32"])
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--pretrained", default="",
                   help="converted params (.npz) or a reference "
                        "pytorch_model.bin to convert on the fly")
    p.add_argument("--tokenizer_dir", default="")
    p.add_argument("--logging_dir", default="logging")
    p.add_argument("--results_dir", default="results")
    p.add_argument("--multihost", action="store_true",
                   help="several processes (not ported: "
                        + MULTI_PROCESS + ")")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p


def parse_args(parser: argparse.ArgumentParser,
               argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parse; refuse a run on no CUDA device unless `--device cpu`, and
    the multi-process flags."""
    args = parser.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --device cpu to run on the CPU")
    for flag in MULTI_PROCESS_FLAGS:
        if getattr(args, flag, False):
            raise NotImplementedError(
                f"--{flag}: the port runs in one process; several processes "
                f"are {MULTI_PROCESS}")
    return args


def setup(args, task: str, keyed: bool = True
          ) -> Tuple[Dict[str, Any], PrismerConfig, Prismer, BPETokenizer]:
    """(task config, model config, model on args.device with weights drawn
    from args.seed, tokenizer)."""
    config = load_task_config(args.config,
                              args.target_dataset if keyed else None)
    if args.mixed_precision == "fp32":
        config["dtype"] = "float32"
    cfg = build_prismer_config(config)
    model = build_random_prismer(cfg, args.seed, args.device)
    if args.tokenizer_dir:
        os.environ["PRISMER_TOKENIZER_DIR"] = args.tokenizer_dir
    tokenizer = load_tokenizer(cfg.decoder.model_name)
    return config, cfg, model, tokenizer


def _port_values(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """fp32 tensors by port state_dict name from a flax variable tree."""
    out = {}
    for coll, sub in tree.items():
        for path, value in _leaves(sub):
            key, value = torch_key_and_value(coll, path, value)
            out[key] = torch.from_numpy(np.array(value, np.float32))
    return out


def load_pretrained(path: str, cfg: PrismerConfig, model: Prismer
                    ) -> Dict[str, torch.Tensor]:
    """Load pretrained weights into `model` (strict=False: leaves the file
    lacks keep their values). `.bin` / `.pt`: a reference checkpoint,
    converted on the fly (reference train_caption.py:96-100), every
    converted leaf a leaf of the model; `.npz`: the flat export of
    `save_params_npz` or of the converter CLI, whose leaves the model lacks
    are skipped, as the JAX loader skips them. The file is read once.
    Returns the values loaded, fp32 by port name, from which the train
    state takes its masters."""
    own = model.state_dict()
    if path.endswith((".bin", ".pt")):
        values = _port_values({c: t for c, t in convert_prismer_checkpoint(
            _load_sd(path), cfg).items() if t})
        extra = sorted(set(values) - set(own))
        if extra:
            raise KeyError(f"{path}: converted leaves not in the model: "
                           f"{extra[:5]}")
    elif path.endswith(".npz"):
        tree = load_params_npz(path)
        if not set(tree) <= {"params", "batch_stats"}:
            tree = {"params": tree}
        values = {k: v for k, v in _port_values(tree).items() if k in own}
        if not values:
            raise ValueError(f"no matching params found in {path}")
    else:
        raise ValueError(f"unknown pretrained format: {path}")
    for key, value in values.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{path}: {key} is {tuple(value.shape)} in the "
                             f"file, {tuple(own[key].shape)} in the model")
    model.load_state_dict(values, strict=False)
    return values


def build_state(args, config: Dict[str, Any], cfg: PrismerConfig,
                model: Prismer, schedule: Schedule) -> TrainState:
    """`--pretrained` loaded, then the train state under `cfg.freeze` with
    AdamW (weight decay from the config, 0.05 by default) and fp32
    masters: the file's values where it has them, else the seed's."""
    loaded = (load_pretrained(args.pretrained, cfg, model)
              if args.pretrained else {})
    low = {n: p.device for n, p in model.named_parameters()
           if p.dtype != torch.float32}
    drawn = (random_masters(model, args.seed) if set(low) - set(loaded)
             else {})
    masters = {n: loaded[n].to(d) if n in loaded else drawn[n]
               for n, d in low.items()}
    return TrainState.create(model, schedule,
                             config.get("weight_decay", 0.05), cfg.freeze,
                             masters, seed=args.seed)


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _single_process(what: str) -> None:
    n = _world_size()
    if n > 1:
        raise NotImplementedError(f"{what} across {n} processes is "
                                  f"{MULTI_PROCESS}")


def gather_for_metrics(values: np.ndarray) -> np.ndarray:
    """Per-process metric arrays, gathered (one process: `values`)."""
    _single_process("gather_for_metrics")
    return values


def gather_results(results: List[Any]) -> List[Any]:
    """Per-process JSON-able result lists, concatenated (one process:
    `results`)."""
    _single_process("gather_results")
    return results


def broadcast_from_main(value: float) -> float:
    """A scalar decision of process 0 (one process: `value`)."""
    _single_process("broadcast_from_main")
    return value


def is_main_process() -> bool:
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def dump_results(results, results_dir: str, name: str) -> Optional[str]:
    if not is_main_process():
        return None
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, name)
    with open(path, "w") as f:
        json.dump(results, f)
    return path
