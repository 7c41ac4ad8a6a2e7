"""Train and eval steps, ported from prismer_tpu/train/step.py.

One train step: the lr from the schedule, the expert batch materialised in
the compute dtype, `Prismer.forward_loss(train=True)` (BatchNorm batch
statistics, dropout, remat, the fused CE kernels on CUDA), the mean over
samples, the backward (frozen leaves carry no gradient), each compute-dtype
gradient cast to fp32 onto its master (the cotangent of flax's cast at use),
AdamW on the fp32 leaves, and the compute-dtype weights refreshed from the
masters. The state is updated in place and returned. Under a mesh the
step is data parallel (parallel/zero.py: "dp", "zero2", "zero3", with an
optional tensor-parallel axis).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from prismer_tpu_torch.data.device import materialize_experts
from prismer_tpu_torch.models.layers import BatchShard, batch_shard
from prismer_tpu_torch.models.prismer import Prismer, compute_dtype
from prismer_tpu_torch.parallel.zero import (reduce_gradients,
                                             refresh_weights, shard_state)
from prismer_tpu_torch.train.state import TrainState

Batch = Dict[str, Any]


def build_train_step(model: Prismer, mesh: Optional[DeviceMesh] = None,
                     mode: str = "dp") -> Callable[[TrainState, Batch],
                                   Tuple[TrainState, Dict[str, Any]]]:
    """(state, batch) -> (state, {"loss": 0-d tensor}).

    batch: {'experts': raw expert batch, 'input_ids': (B, L),
            'attention_mask': (B, L), 'targets': (B, L) with -100 ignored,
            optional 'weights': (B,)}.

    With a mesh, `batch` is this rank's rows of the global batch (the
    'data' axis splits it evenly; ranks on one 'data' index have the same
    rows) and the state is placed on the mesh under `mode` at the first
    step (parallel/zero.py `shard_state`: "dp", "zero2" or "zero3"). The
    loss on each rank is its rows' sum over the global batch size, so the
    gradients summed over the ranks are those of the global mean; the
    stems' BatchNorm uses the global batch statistics and dropout draws
    the global batch's masks. The loss returned is the
    global mean on every rank."""
    dtype = compute_dtype(model.cfg)

    def step(state: TrainState, batch: Batch
             ) -> Tuple[TrainState, Dict[str, Any]]:
        if mesh is not None:
            shard_state(state, mesh, mode)
        par = state.parallel
        rows = batch["input_ids"].shape[0]
        shard = None
        if par is not None:
            shard = BatchShard(par.data_group,
                               par.mesh.get_local_rank("data") * rows, rows,
                               rows * par.n_data)
        experts = materialize_experts(batch["experts"], dtype)
        with batch_shard(shard):
            per_sample = model.forward_loss(
                experts, batch["input_ids"], batch["attention_mask"],
                batch["targets"], train=True, generator=state.generator)
            if "weights" in batch:
                per_sample = per_sample * batch["weights"]
            loss = (per_sample.mean() if shard is None
                    else per_sample.sum() / shard.total)
            model.zero_grad(set_to_none=True)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        apply_gradients(state)
        loss = loss.detach()
        if shard is not None:
            dist.all_reduce(loss, group=shard.group)
        return state, {"loss": loss}

    return step


@torch.no_grad()
def apply_gradients(state: TrainState) -> None:
    """The step's update from the gradients the backward left on the
    model's parameters: each compute-dtype gradient cast to fp32 onto its
    master (under a mesh, summed over the ranks: parallel/zero.py
    `reduce_gradients`), AdamW at the schedule's lr, the compute-dtype
    weights refreshed from the masters, the step counted."""
    params = dict(state.model.named_parameters())
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    if state.parallel is not None:
        reduce_gradients(state)
    else:
        for name, leaf in state.trainable():
            p = params[name]
            grad = p.grad if p.grad is not None else torch.zeros_like(p)
            if leaf is p:
                p.grad = grad
            else:
                leaf.grad = grad.float()
                p.grad = None
    state.optimizer.step()
    for name, master in state.masters.items():
        params[name].copy_(master)
    if state.parallel is not None:
        refresh_weights(state)
    state.step += 1


def build_eval_loss_step(model: Prismer) -> Callable[[Batch], torch.Tensor]:
    """Eval-mode loss: no dropout, BatchNorm running statistics, and the
    plain logits path (JAX's 'auto' rule for forward-only surfaces)."""
    dtype = compute_dtype(model.cfg)

    @torch.no_grad()
    def step(batch: Batch) -> torch.Tensor:
        experts = materialize_experts(batch["experts"], dtype)
        per_sample = model.forward_loss(
            experts, batch["input_ids"], batch["attention_mask"],
            batch["targets"], train=False)
        if "weights" in batch:
            per_sample = per_sample * batch["weights"]
        return per_sample.mean()

    return step
