"""Checkpoints, ported from prismer_tpu/train/checkpoint.py.

`save_checkpoint` writes the whole train state with `torch.save`: step, the
model's tensors (trainable fp32 parameters and BatchNorm running
statistics among them), the fp32 masters, the optimizer state, the
generator state and a metadata dict. `save_params_npz` / `load_params_npz`
use the JAX package's flat .npz format (keys are `jax.tree_util.keystr`
paths such as "['text_decoder']['lm_head']['bias']", values fp32 in flax
layout), so fine-tuned params cross between the packages.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from prismer_tpu_torch.convert.from_jax import to_jax_variables
from prismer_tpu_torch.parallel import runtime
from prismer_tpu_torch.parallel.zero import full_state
from prismer_tpu_torch.train.state import TrainState


def save_checkpoint(path: str, state: TrainState,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Under a mesh (parallel/zero.py) every rank calls this: the sharded
    masters, moments and parameters are gathered into the single-process
    layout, and rank 0 writes the same file one process writes."""
    payload = {
        "step": state.step,
        **full_state(state),
        "generator": state.generator.get_state(),
        "metadata": dict(metadata or {}),
    }
    if runtime.rank() != 0:
        return
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state: TrainState
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore into `state` (same model configuration and freeze mode);
    returns (state, metadata). The state is a single-process one: restore
    before placing it on a mesh (the train step places it at its first
    call), whatever mode wrote the file."""
    if state.parallel is not None:
        raise ValueError("restore into the single-process state, before "
                         "parallel.zero.shard_state")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    if set(payload["masters"]) != set(state.masters):
        raise KeyError("checkpoint masters do not match the state's")
    with torch.no_grad():
        for name, master in state.masters.items():
            master.copy_(payload["masters"][name])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state, payload["metadata"]


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}['{key}']"
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def save_tree_npz(path: str, tree: Dict[str, Any]) -> None:
    """Flat .npz of a nested tree of arrays, keyed as the JAX package keys
    it (`jax.tree_util.keystr` paths)."""
    np.savez(path, **dict(_flatten(tree)))


def save_params_npz(path: str, params: Dict[str, torch.Tensor]) -> None:
    """Flat .npz of fp32 params in the JAX package's key format and layout;
    `params` maps port names to tensors (e.g. TrainState.params_fp32())."""
    save_tree_npz(path, to_jax_variables(params)["params"])


def load_params_npz(path: str) -> Dict[str, Any]:
    """Inverse of save_params_npz: the nested flax param tree."""
    z = np.load(path)
    tree: Dict[str, Any] = {}
    for key in z.files:
        parts = re.findall(r"\['([^']*)'\]", key)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return tree
