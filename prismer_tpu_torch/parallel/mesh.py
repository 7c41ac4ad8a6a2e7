"""The device mesh and the placement rules, ported from
prismer_tpu/parallel/mesh.py.

In the JAX package multi-device training is a sharding spec per leaf:

  * data parallelism   = the batch split on the 'data' axis;
  * ZeRO-3 / FSDP      = parameters sharded on 'data' (`_fsdp_spec`);
  * ZeRO-2             = parameters replicated, optimizer state sharded;
  * tensor parallelism = the 'model' axis (`_tp_spec`).

The port keeps those rules (copied, not imported) and runs them on each
parameter's flax path and flax shape, then maps the chosen dims through
the port's transposes (Dense kernels are stored (out, in), conv kernels
OIHW: convert/from_jax.py). `train/step.py`, `parallel/zero.py` and
`parallel/tp.py` place the tensors by these rules. A mesh is a
`DeviceMesh` of dims ("data", "model") over the ranks of the process
group, rank = data index * n_model + model index, as JAX reshapes its
devices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from prismer_tpu_torch.convert.from_jax import jax_path_and_value
from prismer_tpu_torch.parallel import runtime

Spec = Tuple[Optional[Tuple[str, ...]], ...]   # per dim: mesh axes or None

_FSDP_MIN_SIZE = 2 ** 16  # replicate anything smaller (LN scales, biases)

# parameters whose LAST (flax) dim is a tensor-parallel "expand" dim
# (attention head projections, MLP up-projections): out-features on 'model'
_TP_COL_PARENTS = ("q_proj", "k_proj", "v_proj", "query", "key", "value",
                   "c_fc", "intermediate", "down_proj")
# parameters whose FIRST (flax) dim contracts a TP-sharded activation
# (attention output / MLP down-projections): in-features on 'model'
_TP_ROW_PARENTS = ("out_proj", "c_proj", "up_proj")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device="cuda") -> DeviceMesh:
    """The ("data", "model") mesh over every rank of the open group;
    n_data defaults to world / n_model."""
    world = runtime.world()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} over {world} ranks")
    return init_device_mesh(torch.device(device).type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def data_index(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank("data")


def batch_rows(batch: int, mesh: DeviceMesh) -> slice:
    """This rank's contiguous rows of a global batch, as P("data") splits
    it; the batch must divide the 'data' axis."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    if batch % n:
        raise ValueError(f"batch {batch} does not divide the 'data' axis "
                         f"of {n}")
    rows = batch // n
    start = data_index(mesh) * rows
    return slice(start, start + rows)


def shard_batch(batch: Any, mesh: DeviceMesh) -> Any:
    """This rank's rows of every leaf (leading dim: the batch) of a nested
    dict / list batch."""
    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        return x[batch_rows(x.shape[0], mesh)]
    return take(batch)


# -- the JAX rules, on flax paths and flax shapes -----------------------------

def _fsdp_spec(shape: Sequence[int], n: int, min_size: int = _FSDP_MIN_SIZE,
               exclude=()) -> list:
    if not shape or np.prod(shape, dtype=np.int64) < min_size:
        return [None] * len(shape)
    # the largest divisible dim on 'data'; dims in `exclude` already carry
    # the 'model' axis
    for d in np.argsort(shape)[::-1]:
        if d in exclude:
            continue
        if shape[d] % n == 0:
            spec = [None] * len(shape)
            spec[d] = "data"
            return spec
    return [None] * len(shape)


def _tp_spec(path_parts: Sequence[str], shape: Sequence[int], n: int) -> list:
    spec = [None] * len(shape)
    if n == 1 or len(shape) < 2:
        return spec
    parent = path_parts[-2] if len(path_parts) >= 2 else ""
    if path_parts[-1] != "kernel":
        return spec
    if parent in _TP_COL_PARENTS and shape[-1] % n == 0:
        spec[-1] = "model"
    elif parent in _TP_ROW_PARENTS and shape[0] % n == 0:
        spec[0] = "model"
    return spec


def _merge_specs(a: list, b: list) -> Spec:
    out = []
    for x, y in zip(a, b):
        axes = tuple(ax for ax in (x, y) if ax is not None)
        out.append(axes or None)
    return tuple(out)


def flax_spec(path_parts: Sequence[str], shape: Sequence[int], n_data: int,
              n_model: int, fsdp: bool = False, tp: bool = False,
              min_size: int = _FSDP_MIN_SIZE) -> Spec:
    """JAX's `param_shardings` spec of one flax leaf, per flax dim."""
    spec = [None] * len(shape)
    if tp:
        spec = _tp_spec(path_parts, shape, n_model)
    if fsdp:
        used = {i for i, s in enumerate(spec) if s is not None}
        return _merge_specs(spec, _fsdp_spec(shape, n_data, min_size, used))
    return _merge_specs(spec, [None] * len(shape))


def _flax_dims(ndim: int) -> Tuple[int, ...]:
    """For each port dim, the flax dim it holds."""
    if ndim == 2:
        return (1, 0)
    if ndim == 4:
        return (3, 2, 0, 1)
    return tuple(range(ndim))


def port_spec(name: str, shape: Sequence[int], n_data: int, n_model: int,
              fsdp: bool = False, tp: bool = False,
              min_size: int = _FSDP_MIN_SIZE) -> Spec:
    """The spec of one port parameter (port layout), from the flax rules."""
    view = np.broadcast_to(np.zeros((), np.int8), tuple(shape))
    _, path, flax_value = jax_path_and_value(name, view)
    spec = flax_spec(path, flax_value.shape, n_data, n_model, fsdp, tp,
                     min_size)
    if path[-1] != "kernel":
        return spec
    return tuple(spec[d] for d in _flax_dims(len(shape)))


def param_placements(model: nn.Module, n_data: int, n_model: int = 1,
                     fsdp: bool = False, tp: bool = False,
                     min_size: int = _FSDP_MIN_SIZE) -> Dict[str, Spec]:
    """{parameter name: spec} for every parameter of `model`, each spec a
    tuple over the port dims of None or the mesh axes that split that dim,
    equal to JAX's `param_shardings(params, mesh, fsdp, tp, min_size)`
    mapped into the port's layout."""
    return {name: port_spec(name, p.shape, n_data, n_model, fsdp, tp,
                            min_size)
            for name, p in model.named_parameters()}


def axis_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim that `axis` splits in `spec`, or None."""
    for d, axes in enumerate(spec):
        if axes and axis in axes:
            return d
    return None
