"""Train and eval steps, ported from prismer_tpu/train/step.py.

One train step: the lr from the schedule, the expert batch materialised in
the compute dtype, `Prismer.forward_loss(train=True)` (BatchNorm batch
statistics, dropout, remat, the fused CE kernels on CUDA), the mean over
samples, the backward (frozen leaves carry no gradient), each compute-dtype
gradient cast to fp32 onto its master (the cotangent of flax's cast at use),
AdamW on the fp32 leaves, and the compute-dtype weights refreshed from the
masters. The state is updated in place and returned.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from prismer_tpu_torch.data.device import materialize_experts
from prismer_tpu_torch.models.prismer import Prismer, compute_dtype
from prismer_tpu_torch.train.state import TrainState

Batch = Dict[str, Any]


def build_train_step(model: Prismer
                     ) -> Callable[[TrainState, Batch],
                                   Tuple[TrainState, Dict[str, Any]]]:
    """(state, batch) -> (state, {"loss": 0-d tensor}).

    batch: {'experts': raw expert batch, 'input_ids': (B, L),
            'attention_mask': (B, L), 'targets': (B, L) with -100 ignored,
            optional 'weights': (B,)}."""
    dtype = compute_dtype(model.cfg)

    def step(state: TrainState, batch: Batch
             ) -> Tuple[TrainState, Dict[str, Any]]:
        experts = materialize_experts(batch["experts"], dtype)
        per_sample = model.forward_loss(
            experts, batch["input_ids"], batch["attention_mask"],
            batch["targets"], train=True, generator=state.generator)
        if "weights" in batch:
            per_sample = per_sample * batch["weights"]
        loss = per_sample.mean()
        model.zero_grad(set_to_none=True)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        apply_gradients(state)
        return state, {"loss": loss.detach()}

    return step


@torch.no_grad()
def apply_gradients(state: TrainState) -> None:
    """The step's update from the gradients the backward left on the
    model's parameters: each compute-dtype gradient cast to fp32 onto its
    master, AdamW at the schedule's lr, the compute-dtype weights refreshed
    from the masters, the step counted."""
    params = dict(state.model.named_parameters())
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
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
