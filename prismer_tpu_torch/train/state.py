"""The training state, ported from prismer_tpu/train/state.py.

The model stores its Dense and Conv weights in the compute dtype (serving's
layout). An AdamW step at a fine-tune lr (5e-5) moves a weight by about
5e-5, less than half a bf16 ulp for |w| >= 2^-6, so updates applied to the
bf16 weights would round away. As flax keeps every param in fp32 and casts
at use, the state keeps an fp32 master of every trainable weight stored in
a lower precision; the optimizer updates the masters (and the fp32
parameters, which are their own masters), and the step refreshes the
compute-dtype weights from the masters. Masters come from fp32 values
(`convert.from_jax.load_jax_masters`, `models.prismer.random_masters`),
never from the rounded weights. Where those values also cover frozen
low-precision leaves, the state keeps them too (on the host: the optimizer
never sees them), so `params_fp32` exports every leaf at full precision.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn as nn

from prismer_tpu_torch.train.optim import TRAIN, apply_freeze, make_optimizer
from prismer_tpu_torch.train.schedules import Schedule


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    labels: Dict[str, str]              # param name -> trainable / frozen
    masters: Dict[str, torch.Tensor]    # fp32 masters of low-precision leaves
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    generator: torch.Generator          # instance slots and dropout seeds
    frozen_fp32: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)           # host fp32 values of frozen ones
    parallel: Optional[Any] = None      # parallel/zero.py placement

    @classmethod
    def create(cls, model: nn.Module, schedule: Schedule,
               weight_decay: float, freeze_mode: str = "none",
               masters: Optional[Dict[str, torch.Tensor]] = None,
               seed: int = 0) -> "TrainState":
        """Freeze by mode, copy the masters of the trainable low-precision
        parameters (required when there are any), keep host fp32 copies of
        the frozen low-precision parameters that `masters` also covers, and
        build AdamW over the fp32 leaves. `seed` seeds the generator of the
        random streams."""
        labels = apply_freeze(model, freeze_mode)
        params = dict(model.named_parameters())
        need = [n for n, p in params.items()
                if labels[n] == TRAIN and p.dtype != torch.float32]
        if need and masters is None:
            raise ValueError(f"{len(need)} trainable parameters are stored "
                             "in a lower precision: give their fp32 masters")
        own = {n: masters[n].detach().to(device=params[n].device,
                                         dtype=torch.float32).clone()
               for n in need}
        frozen = {n: masters[n].detach().to(device="cpu",
                                            dtype=torch.float32).clone()
                  for n, p in params.items()
                  if labels[n] != TRAIN and p.dtype != torch.float32
                  and masters is not None and n in masters}
        state = cls(step=0, model=model, labels=labels, masters=own,
                    optimizer=None, schedule=schedule,
                    generator=torch.Generator().manual_seed(seed),
                    frozen_fp32=frozen)
        state.optimizer = make_optimizer(
            [leaf for _, leaf in state.trainable()], weight_decay,
            schedule(0))
        return state

    def trainable(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """(name, fp32 leaf the optimizer updates), in parameter order: a
        ZeRO-2 shard of the master, else the master, else the parameter."""
        shards = self.parallel.shards if self.parallel is not None else {}
        for name, p in self.model.named_parameters():
            if self.labels[name] == TRAIN:
                yield name, shards.get(name, self.masters.get(name, p))

    def params_fp32(self) -> Dict[str, torch.Tensor]:
        """Every parameter at full precision: masters, or the frozen
        leaves' fp32 copies, over the rounded weights, where there are
        such values."""
        return {n: self.masters.get(n, self.frozen_fp32.get(n, p)).detach()
                for n, p in self.model.named_parameters()}
