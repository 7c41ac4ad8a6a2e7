"""What the ranks of the port's multi-process tests run
(tests/test_torch_parallel*.py): top-level functions that
`prismer_tpu_torch.parallel.runtime.spawn` starts in fresh processes. This
module imports no JAX (each rank asserts that none is loaded); the JAX
sides of the comparisons run in the test process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from prismer_tpu_torch import config as port_config
from prismer_tpu_torch.convert.from_jax import (load_jax_masters,
                                                load_jax_variables)
from prismer_tpu_torch.models import prismer as port_prismer
from prismer_tpu_torch.parallel import runtime, zero
from prismer_tpu_torch.parallel.mesh import make_mesh, shard_batch
from prismer_tpu_torch.train import TrainState, build_train_step
from prismer_tpu_torch.train import schedules

EXPERTS = ["depth", "obj_detection"]
RES = 64
LR = 1e-4
WD = 0.05
STEPS_PER_EPOCH = 5
PROMPT = 2


def no_jax() -> None:
    assert "jax" not in sys.modules, "a rank imported jax"


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def raw_batch(seed: int, batch: int, label_res: int = RES) -> Dict[str, Any]:
    """A raw depth + obj_detection expert batch (numpy)."""
    rng = np.random.default_rng(seed)
    raw = {"rgb": rng.integers(0, 256, (batch, RES, RES, 3)).astype(np.uint8),
           "depth": rng.uniform(-1, 1, (batch, label_res, label_res, 1)
                                ).astype(np.float32),
           "obj_detection": {
               "ids": rng.integers(0, 256, (batch, label_res, label_res)
                                   ).astype(np.uint8),
               "table": rng.uniform(-1, 1, (batch, 256, 64)
                                    ).astype(np.float32),
               "instance": rng.integers(0, 256, (batch, label_res, label_res)
                                        ).astype(np.uint8)}}
    return raw


def caption_batch(seed: int, batch: int, vocab: int = 512) -> Dict[str, Any]:
    """Raw experts and a ragged right-padded caption batch (every other
    sample 5 of 7 tokens) with the prompt and pads masked in the targets."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (batch, 7)).astype(np.int32)
    ids[:, 0] = 0
    mask = np.ones_like(ids)
    ids[1::2, 5:], mask[1::2, 5:] = 1, 0
    targets = np.where(ids == 1, -100, ids)
    targets[:, :PROMPT] = -100
    return {"experts": raw_batch(seed, batch), "input_ids": ids,
            "attention_mask": mask, "targets": targets.astype(np.int32)}


def tiny_cfg(dtype: str = "float32", dropout: float = 0.0,
             experts: Optional[List[str]] = None):
    cfg = port_config.build_prismer_config(
        dict(port_config.tiny_test_config(experts or EXPERTS, RES),
             dtype=dtype))
    dec = dataclasses.replace(cfg.decoder, hidden_dropout_prob=dropout)
    return dataclasses.replace(cfg, decoder=dec)


def build_state(cfg, variables_np, freeze: str = "freeze_vision"):
    model = port_prismer.Prismer(cfg)
    load_jax_variables(model, variables_np)
    masters = load_jax_masters(model, variables_np)
    schedule = schedules.per_step_cosine(LR, 0.0, STEPS_PER_EPOCH, 1)
    return TrainState.create(model, schedule, WD, freeze, masters)


@contextlib.contextmanager
def fixed_slots(slots: Optional[np.ndarray]):
    """Inside the block every instance-slot draw returns `slots` (the draw
    one JAX step made) when given."""
    real = port_prismer.draw_instance_slots
    if slots is not None:
        port_prismer.draw_instance_slots = (
            lambda *a, s=slots: torch.from_numpy(s.copy()))
    try:
        yield
    finally:
        port_prismer.draw_instance_slots = real


def full_grads(state) -> Dict[str, np.ndarray]:
    """Each trainable leaf's gradient, whole, fp32 (a collective under a
    mesh)."""
    return {name: g.float().numpy().copy()
            for name, g in zero.full_grads(state).items()}


def full_params(state) -> Dict[str, np.ndarray]:
    """Every parameter whole in fp32 (masters over rounded weights) and the
    BatchNorm running statistics."""
    full = zero.full_state(state)
    out = {k: v.float().numpy().copy() for k, v in full["model"].items()}
    out.update({k: v.numpy().copy() for k, v in full["masters"].items()})
    return out


def step_record(state, metrics, grads: bool = True) -> Dict[str, Any]:
    rec = {"loss": float(metrics["loss"]), "params": full_params(state)}
    if grads:
        rec["grads"] = full_grads(state)
    return rec


def run_steps(cfg, variables_np, batch_np, slots, mode: Optional[str],
              n_model: int = 1, steps: int = 1, sync: bool = True,
              save: Optional[str] = None, min_size: int = 512
              ) -> List[Dict[str, Any]]:
    """`steps` train steps on `batch_np` (the global batch): in one process
    when mode is None, else this rank's rows on a mesh under `mode`.
    `slots`: the instance slots of every step, or a list of each step's, or
    None (the state's generator draws them). `sync=False`: BatchNorm
    without its all-reduce (`batch_norm_unsynced`). With
    `save`, the state is checkpointed there after the first step. Leaves
    of `min_size` elements or more are sharded (512, as JAX's dry run)."""
    from prismer_tpu_torch.train.checkpoint import save_checkpoint
    state = build_state(cfg, variables_np)
    batch = to_torch(batch_np)
    mesh = None
    if mode is not None:
        mesh = make_mesh(n_model=n_model, device="cpu")
        batch = shard_batch(batch, mesh)
        zero.shard_state(state, mesh, mode, min_size)
    step = build_train_step(state.model, mesh, mode or "dp")
    out = []
    with contextlib.nullcontext() if sync else batch_norm_unsynced():
        for i in range(steps):
            with fixed_slots(slots[i] if isinstance(slots, list) else slots):
                state, metrics = step(state, batch)
                out.append(step_record(state, metrics))
                if save and i == 0:
                    save_checkpoint(save, state, {"epoch": 0})
    return out


@contextlib.contextmanager
def batch_norm_unsynced():
    """Inside the block BatchNorm sees no batch shard, so it normalises
    with this rank's statistics; Dropout still draws the global batch's
    masks (it reads the shard through models.layers)."""
    from prismer_tpu_torch.models import vit
    real = vit.current_batch_shard
    vit.current_batch_shard = lambda: None
    try:
        yield
    finally:
        vit.current_batch_shard = real


def restore_and_step(cfg, variables_np, batch_np, slots, path: str
                     ) -> Dict[str, Any]:
    """One process: restore `path`, then one step on the whole batch."""
    from prismer_tpu_torch.train.checkpoint import restore_checkpoint
    state = build_state(cfg, variables_np)
    state, _ = restore_checkpoint(path, state)
    step = build_train_step(state.model)
    with fixed_slots(slots):
        state, metrics = step(state, to_torch(batch_np))
    return step_record(state, metrics)


@contextlib.contextmanager
def kernel_inputs(seen: List[str]):
    """Record whether each tensor handed to the attention and fused
    cross-entropy entry points is a DTensor (kernels 1, 2, 8, 9 on CUDA; 6, 7 run on
    the forward's saved inputs) inside the block."""
    from prismer_tpu_torch.models import layers
    from prismer_tpu_torch.ops import fused_ce

    def recording(fn):
        def wrapped(*args, **kw):
            seen.extend("DTensor" if isinstance(a, DTensor) else "plain"
                        for a in list(args) + list(kw.values())
                        if isinstance(a, torch.Tensor))
            return fn(*args, **kw)
        return wrapped

    saved = [(layers, "flash_attention"), (layers, "packed_attention"),
             (fused_ce, "fused_label_smoothed_loss")]
    real = [getattr(m, n) for m, n in saved]
    fused_ce.set_fused_ce("on")
    for (m, n), fn in zip(saved, real):
        setattr(m, n, recording(fn))
    try:
        yield
    finally:
        for (m, n), fn in zip(saved, real):
            setattr(m, n, fn)
        fused_ce.set_fused_ce("auto")


def rank_train_cases(cases: List[Dict[str, Any]],
                     collectives: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """Run each case's `run_steps` on this rank; {case name: records}. A
    case with "kernels": True records the types its kernel entry points
    got (under "kernel_inputs"). With `collectives`, also this rank's
    results of the drivers' collectives on its entry of each list."""
    from prismer_tpu_torch.cli import common
    no_jax()
    out: Dict[str, Any] = {}
    for case in cases:
        kw = dict(case)
        name = kw.pop("name")
        seen: List[str] = []
        with (kernel_inputs(seen) if kw.pop("kernels", False)
              else contextlib.nullcontext()):
            out[name] = run_steps(**kw)
        out[name + ":kernel_inputs"] = seen
    if collectives is not None:
        r = runtime.rank()
        out["collectives"] = {
            "gather_results": common.gather_results(
                collectives["results"][r]),
            "gather_for_metrics": common.gather_for_metrics(
                collectives["metrics"][r]),
            "broadcast_from_main": common.broadcast_from_main(
                collectives["scalars"][r]),
            "is_main_process": common.is_main_process()}
    return out


def rank_generate(cfg, variables_np, raw_np, ids_np, mask_np, slots,
                  gen_kw: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Sharded generation over this rank's mesh with fused decode off, on
    (the plain versions of kernels 1-5 on the CPU) and on with int8 cross
    K/V; {mode: the global batch's ids}."""
    from prismer_tpu_torch.models import roberta
    from prismer_tpu_torch.models.caption import build_sharded_generate_fn
    no_jax()
    model = port_prismer.Prismer(cfg)
    load_jax_variables(model, variables_np)
    model.eval()
    mesh = make_mesh(device="cpu")
    out = {}
    try:
        for mode, fused, kv in (("off", "off", "off"), ("on", "on", "off"),
                                ("int8", "on", "int8")):
            roberta.set_fused_decode(fused)
            roberta.set_kv_quant(kv)
            fn = build_sharded_generate_fn(model, mesh, **gen_kw)
            out[mode] = fn(to_torch(raw_np), torch.from_numpy(ids_np),
                           torch.from_numpy(mask_np),
                           torch.from_numpy(slots)).numpy()
    finally:
        roberta.set_fused_decode("auto")
        roberta.set_kv_quant("off")
    return out


def rank_driver(runs: List[Dict[str, Any]]) -> List[str]:
    """Each run's `module.main(argv)` as torchrun would start it on this
    rank (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set;
    --multihost in argv opens the group), one after another; returns
    each run's standard output."""
    no_jax()
    r, world = runtime.rank(), runtime.world()
    runtime.shutdown()
    outs = []
    for run in runs:
        os.environ.update(RANK=str(r), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(run["port"]))
        module = importlib.import_module(run["module"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            module.main(run["argv"])
        runtime.shutdown()
        outs.append(buf.getvalue())
    return outs
