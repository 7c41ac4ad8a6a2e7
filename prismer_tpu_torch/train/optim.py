"""Freeze-mode partitions and AdamW, ported from prismer_tpu/train/optim.py.

Parameter names are the flax paths joined by '.', so the reference's name
predicates (model/prismer.py:39-59) carry over unchanged:
  freeze_lang        - decoder layer blocks frozen except cross-attention and
                       adaptors; embeddings, LM head and output layer train.
  freeze_vision      - ViT trunk blocks frozen except their adaptors; stems,
                       positional embeddings, resampler, ln_pre/ln_post train.
  freeze_lang_vision - both.
Frozen parameters get requires_grad False, which prunes their weight
gradients from the backward as JAX's stop_gradient does; only trainable
ones enter the optimizer.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.nn as nn

TRAIN = "trainable"
FROZEN = "frozen"
FREEZE_MODES = ("none", "freeze_lang", "freeze_vision", "freeze_lang_vision")


def _vision_frozen(path: Sequence[str]) -> bool:
    in_trunk = any(p.startswith("resblocks_") for p in path)
    return in_trunk and "adaptor" not in path


def _lang_frozen(path: Sequence[str]) -> bool:
    in_layer = any(p.startswith("layers_") for p in path)
    keep = {"cross_attn", "cross_out", "adaptor"}
    return in_layer and not any(p in keep for p in path)


def freeze_label(name: str, mode: str) -> str:
    """'trainable' or 'frozen' for one parameter name under `mode`."""
    if mode not in FREEZE_MODES:
        raise ValueError(f"freeze mode {mode!r}")
    path = name.split(".")
    if mode in ("freeze_vision", "freeze_lang_vision"):
        if "expert_encoder" in path and _vision_frozen(path):
            return FROZEN
    if mode in ("freeze_lang", "freeze_lang_vision"):
        if "text_decoder" in path and _lang_frozen(path):
            return FROZEN
    return TRAIN


def freeze_labels(names: Iterable[str], mode: str) -> Dict[str, str]:
    """{name: label} for parameter names (e.g. model.named_parameters())."""
    return {n: freeze_label(n, mode) for n in names}


def apply_freeze(model: nn.Module, mode: str) -> Dict[str, str]:
    """Set requires_grad from the labels; returns them."""
    labels = freeze_labels((n for n, _ in model.named_parameters()), mode)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == TRAIN)
    return labels


def make_optimizer(leaves: Sequence[torch.Tensor], weight_decay: float,
                   lr: float, foreach: Optional[bool] = None
                   ) -> torch.optim.AdamW:
    """AdamW (torch defaults b1 0.9, b2 0.999, eps 1e-8; decoupled decay on
    every trainable leaf, as the reference does not exempt LN or biases)
    over fp32 leaves. The step sets the lr from the schedule each step.
    `foreach` False: one leaf at a time (leaves that mix DTensors and plain
    tensors, which the multi-tensor kernels refuse)."""
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay, foreach=foreach)


def count_params(model: nn.Module, labels: Optional[Dict[str, str]] = None
                 ) -> Dict[str, int]:
    """Total / trainable parameter counts."""
    named: Iterable[Tuple[str, torch.Tensor]] = model.named_parameters()
    total = trainable = 0
    for name, p in named:
        total += p.numel()
        if labels is None or labels[name] == TRAIN:
            trainable += p.numel()
    return {"total": total, "trainable": trainable}
