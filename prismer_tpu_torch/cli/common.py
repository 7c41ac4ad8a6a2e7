"""Shared driver plumbing for the task CLIs, ported from
prismer_tpu/cli/common.py: argument parsing, the task config (read by path
with the port's YAML reader), the model and train state, pretrained
weights, and the cross-process collectives.

`--device` (default cuda) picks the device; without a CUDA device the
drivers refuse to start unless given `--device cpu`. `--multihost` opens
the process group (parallel/runtime.py `init`, from the variables torchrun
sets: NCCL for CUDA, gloo for the CPU); every loader then reads its
process's shard of the data, and the train step is data parallel over all
ranks: "dp" by default, ZeRO-2 with `--shard_grad_op`, ZeRO-3 with
`--full_shard` (parallel/zero.py). With one process the collectives return
their input, as the JAX versions do when `jax.process_count() == 1`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from prismer_tpu_torch.config import (PrismerConfig, build_prismer_config,
                                      default_config_path, load_task_config)
from prismer_tpu_torch.convert.cli import _load_sd
from prismer_tpu_torch.convert.from_jax import _leaves, torch_key_and_value
from prismer_tpu_torch.convert.torch_to_jax import convert_prismer_checkpoint
from prismer_tpu_torch.data.device import experts_to_device
from prismer_tpu_torch.models.prismer import (Prismer, build_random_prismer,
                                              random_masters)
from prismer_tpu_torch.parallel import runtime
from prismer_tpu_torch.parallel.mesh import make_mesh
from prismer_tpu_torch.tokenizer import BPETokenizer, load_tokenizer
from prismer_tpu_torch.train import TrainState
from prismer_tpu_torch.train.checkpoint import load_params_npz
from prismer_tpu_torch.train.schedules import Schedule

__all__ = ["base_parser", "parse_args", "train_mode", "setup",
           "load_pretrained", "build_state", "train_mesh", "loader_shard",
           "epoch_steps",
           "experts_to_device", "gather_for_metrics", "gather_results",
           "broadcast_from_main", "is_main_process", "dump_results"]


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
                   help="ZeRO-2: shard the masters' optimizer state over "
                        "the ranks")
    p.add_argument("--full_shard", action="store_true",
                   help="ZeRO-3: shard the parameters over the ranks")
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
                   help="one rank per process, as torchrun starts them "
                        "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                        "MASTER_PORT)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p


def parse_args(parser: argparse.ArgumentParser,
               argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parse; refuse a run on no CUDA device unless `--device cpu`."""
    args = parser.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --device cpu to run on the CPU")
    return args


def train_mode(args) -> str:
    """The train step's mode under several ranks (parallel/zero.py)."""
    if args.full_shard:
        return "zero3"
    if args.shard_grad_op:
        return "zero2"
    return "dp"


def setup(args, task: str, keyed: bool = True
          ) -> Tuple[Dict[str, Any], PrismerConfig, Prismer, BPETokenizer]:
    """(task config, model config, model on args.device with weights drawn
    from args.seed, tokenizer); with `--multihost`, first the process
    group."""
    if args.multihost:
        runtime.init(args.device)
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


def train_mesh(args):
    """The mesh of the data-parallel train step over every rank when a
    process group is open (`--multihost`), else None (one process)."""
    return make_mesh(device=args.device) if runtime.initialized() else None


def loader_shard() -> Dict[str, int]:
    """create_loader's shard of this process (the whole data set with one
    process)."""
    return {"shard_id": runtime.rank(), "num_shards": runtime.world()}


def epoch_steps(loader) -> int:
    """Train steps an epoch: the fewest batches any process's shard gives,
    so that every rank takes part in every step's collectives."""
    return min(runtime.all_gather_object(len(loader)))


def gather_for_metrics(values: np.ndarray) -> np.ndarray:
    """Per-process metric arrays, stacked in process order as JAX's
    `process_allgather` stacks them (one process: `values`)."""
    if runtime.world() == 1:
        return values
    return np.stack([np.asarray(v) for v in runtime.all_gather_object(
        np.asarray(values))])


def gather_results(results: List[Any]) -> List[Any]:
    """Per-process JSON-able result lists, concatenated in process order
    (one process: `results`)."""
    if runtime.world() == 1:
        return results
    merged: List[Any] = []
    for part in runtime.all_gather_object(results):
        merged += part
    return merged


def broadcast_from_main(value: float) -> float:
    """Process 0's scalar decision, as float32 as JAX's
    `broadcast_one_to_all` carries it (one process: `value`)."""
    if runtime.world() == 1:
        return value
    return float(np.float32(runtime.broadcast_object(value)))


def is_main_process() -> bool:
    return runtime.is_main()


def dump_results(results, results_dir: str, name: str) -> Optional[str]:
    if not is_main_process():
        return None
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, name)
    with open(path, "w") as f:
        json.dump(results, f)
    return path
