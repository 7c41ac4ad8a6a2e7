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

Training keeps fp32 masters of the weights stored in the compute dtype:
`load_jax_masters` takes them from the JAX fp32 values, never from the
rounded weights. `to_jax_variables` and `jax_path_and_value` are the
inverse map (port name -> flax path and layout), used to export params and
to compare gradients leaf by leaf.
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


def jax_path_and_value(key: str, value: np.ndarray
                       ) -> Tuple[str, Tuple[str, ...], np.ndarray]:
    """Map one port state_dict entry to (flax collection, path, array in
    flax layout): the inverse of `torch_key_and_value`."""
    *mods, leaf = key.split(".")
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", tuple(mods) + (leaf.split("_")[1],), value
    if leaf == "weight":
        if value.ndim == 2:
            return "params", tuple(mods) + ("kernel",), value.T
        if value.ndim == 4:
            return "params", tuple(mods) + ("kernel",), value.transpose(
                2, 3, 1, 0)
        return "params", tuple(mods) + ("scale",), value
    return "params", tuple(mods) + (leaf,), value


def to_jax_variables(tensors: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{"params": tree, "batch_stats": tree} of fp32 numpy arrays in flax
    layout from port tensors keyed by state_dict name (for example a
    model's state_dict with its masters over the rounded weights)."""
    out: Dict[str, Any] = {}
    for key, t in tensors.items():
        coll, path, value = jax_path_and_value(
            key, t.detach().float().cpu().numpy())
        node = out.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return out


def load_jax_masters(model: nn.Module, variables: Dict[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """fp32 masters, from the JAX fp32 values, of every model parameter
    stored in a lower precision, in port layout on the parameter's device."""
    params = dict(model.named_parameters())
    masters = {}
    for path, value in _leaves(variables["params"]):
        key, value = torch_key_and_value("params", path, value)
        p = params.get(key)
        if p is not None and p.dtype != torch.float32:
            masters[key] = torch.from_numpy(np.array(value, np.float32)).to(
                p.device)
    missing = {k for k, p in params.items() if p.dtype != torch.float32}
    missing -= set(masters)
    if missing:
        raise KeyError(f"no JAX value for masters {sorted(missing)}")
    return masters


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
