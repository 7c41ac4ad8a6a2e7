"""Load JAX (flax) variables into the port, strictly.

`load_jax_variables(model, variables)` takes the flax variable tree
{"params": ..., "batch_stats": ...} with numpy arrays as leaves (for
example `jax.tree.map(np.asarray, variables)`) and copies every leaf into
the port module whose `state_dict` key is the leaf's flax path joined by '.'
(the port names its submodules after the flax scopes). Leaf renames:

    Dense kernel (in, out)        -> weight (out, in)
    Conv kernel HWIO              -> weight OIHW
    LayerNorm/BatchNorm scale     -> weight      (bias stays bias)
    BatchNorm mean / var          -> running_mean / running_var
    raw params (positional_embedding, latents, instance_embedding,
    embedding tables, lm_head.bias) are copied as they are.

Strict: raises on a JAX leaf it cannot place (unknown key or shape) and on
any port parameter or buffer left unset. Values are cast to the port
tensor's dtype (the compute dtype for Dense/Conv weights, as flax casts them
at use). Imports neither jax nor flax.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


def torch_key_and_value(collection: str, path: Tuple[str, ...],
                        value: np.ndarray) -> Tuple[str, np.ndarray]:
    """Map one flax leaf to (port state_dict key, array in port layout)."""
    *mods, leaf = path
    if collection == "batch_stats":
        renamed = {"mean": "running_mean", "var": "running_var"}
        if leaf not in renamed:
            raise KeyError(f"unknown batch_stats leaf {'.'.join(path)}")
        return ".".join(mods + [renamed[leaf]]), value
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel {'.'.join(path)} of rank {value.ndim}")
        return ".".join(mods + ["weight"]), value
    if leaf == "scale":
        return ".".join(mods + ["weight"]), value
    return ".".join(path), value


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: Dict[str, Any]) -> None:
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    unset = set(targets)
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {collection!r}")
        for path, value in _leaves(tree):
            key, value = torch_key_and_value(collection, path, value)
            if key not in targets:
                raise KeyError(f"JAX leaf {collection}/{'/'.join(path)} has "
                               f"no port tensor {key!r}")
            dst = targets[key]
            if tuple(dst.shape) != value.shape:
                raise ValueError(f"{key}: port shape {tuple(dst.shape)} vs "
                                 f"JAX {value.shape}")
            dst.copy_(torch.from_numpy(np.array(value)).to(
                dtype=dst.dtype, device=dst.device))
            unset.discard(key)
    if unset:
        raise KeyError(f"port tensors not set from JAX: {sorted(unset)}")
