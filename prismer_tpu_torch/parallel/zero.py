"""Data-parallel train state: modes "dp", "zero2" and "zero3", each with an
optional tensor-parallel 'model' axis (not with "zero2").

  dp     every rank holds the whole state; after the backward the fp32
         gradients of the trainable leaves (the masters and the fp32
         parameters) are all-reduced (SUM) over 'data' in flat buckets, and
         every rank runs the same AdamW. DistributedDataParallel is not used:
         it would reduce the compute-dtype gradients of the compute-dtype
         weights before they are cast onto the fp32 masters.
  zero2  (--shard_grad_op) parameters replicated; each trainable leaf that
         `param_placements(fsdp=True)` shards on 'data' has its fp32 master
         and its two AdamW moments only as this rank's shard: its gradient
         is reduce-scattered, the shard updated, and the updated masters
         all-gathered into the compute-dtype weights. Smaller leaves as dp.
  zero3  (--full_shard) FSDP2 `fully_shard` on each ViT block, each decoder
         layer, the resampler and the root, each parameter sharded on the
         dim `param_placements(fsdp=True)` picks; the leaves JAX replicates
         are FSDP's `ignored_params`, their gradients all-reduced as in dp.
         Every parameter is fp32 (the masters), cast to the compute dtype
         at use by Dense and Conv, as flax casts its fp32 params; so there
         is no separate master dict and the numerics are dp's. FSDP2 hands
         the modules plain unsharded tensors during forward and backward.

`shard_state` turns a single-process `TrainState` into one of these in
place (after any `restore_checkpoint`); `full_state` gathers a sharded
state back into the single-process layout for checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from prismer_tpu_torch.parallel.mesh import (_FSDP_MIN_SIZE, Spec, axis_dim,
                                             param_placements)

MODES = ("dp", "zero2", "zero3")
BUCKET_ELEMENTS = 1 << 24   # fp32 elements an all-reduce bucket holds


@dataclasses.dataclass
class Parallel:
    mode: str
    mesh: DeviceMesh
    placements: Dict[str, Spec]         # param name -> spec (port layout)
    dtypes: Dict[str, torch.dtype]      # param dtypes before sharding
    shards: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)           # zero2: fp32 shards of masters
    fsdp_modules: List[nn.Module] = dataclasses.field(default_factory=list)

    @property
    def data_group(self):
        return self.mesh.get_group("data")

    @property
    def model_group(self):
        return self.mesh.get_group("model")

    @property
    def n_data(self) -> int:
        return self.mesh.size(0)

    @property
    def n_model(self) -> int:
        return self.mesh.size(1)

    def data_dim(self, name: str) -> Optional[int]:
        return axis_dim(self.placements[name], "data")

    def model_dim(self, name: str) -> Optional[int]:
        return axis_dim(self.placements[name], "model")


def _own(t: torch.Tensor, n: int, dim: int, index: int) -> torch.Tensor:
    return t.detach().chunk(n, dim)[index].clone()


def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    *mods, leaf = name.split(".")
    owner = model.get_submodule(".".join(mods))
    old = getattr(owner, leaf)
    setattr(owner, leaf, nn.Parameter(value, requires_grad=old.requires_grad))


def shard_state(state, mesh: DeviceMesh, mode: str = "dp",
                min_size: int = _FSDP_MIN_SIZE) -> None:
    """Place `state` (a single-process TrainState, optimizer state included)
    on `mesh` under `mode`, in place. A state already placed the same way
    is left as it is."""
    from prismer_tpu_torch.train.optim import make_optimizer
    if state.parallel is not None:
        if state.parallel.mode == mode and state.parallel.mesh is mesh:
            return
        raise ValueError(f"state already placed in mode "
                         f"{state.parallel.mode!r}")
    if mode not in MODES:
        raise ValueError(f"parallel mode {mode!r}, not one of {MODES}")
    model = state.model
    n_data, n_model = mesh.size(0), mesh.size(1)
    if mode == "zero2" and n_model > 1:
        raise ValueError("zero2 shards optimizer state over 'data' only; "
                         "use dp or zero3 with a 'model' axis")
    placements = param_placements(model, n_data, n_model,
                                  fsdp=mode != "dp", tp=n_model > 1,
                                  min_size=min_size)
    par = Parallel(mode, mesh, placements,
                   {n: p.dtype for n, p in model.named_parameters()})
    old_leaves = dict(state.trainable())
    old_opt = state.optimizer
    if n_model > 1:
        from prismer_tpu_torch.parallel.tp import apply_tensor_parallel
        m_index = mesh.get_local_rank("model")
        apply_tensor_parallel(model, placements, par.model_group, m_index,
                              n_model)
        for table in (state.masters, state.frozen_fp32):
            for name in list(table):
                d = par.model_dim(name)
                if d is not None:
                    table[name] = _own(table[name], n_model, d, m_index)
    if mode == "zero2":
        d_index = mesh.get_local_rank("data")
        for name, leaf in state.trainable():
            d = par.data_dim(name)
            if d is not None:
                par.shards[name] = _own(leaf.float(), n_data, d, d_index)
                state.masters.pop(name, None)
    elif mode == "zero3":
        _fully_shard(state, par)
    state.parallel = par

    group = old_opt.param_groups[0]
    # under zero3 the sharded leaves are DTensors and the ignored ones plain,
    # which the multi-tensor AdamW refuses to mix
    state.optimizer = make_optimizer([leaf for _, leaf in state.trainable()],
                                     group["weight_decay"], group["lr"],
                                     foreach=False if mode == "zero3" else None)
    for name, leaf in state.trainable():
        old = old_opt.state.get(old_leaves[name])
        if old:
            state.optimizer.state[leaf] = {
                k: (v.clone() if k == "step" else _placed(par, name, v, leaf))
                for k, v in old.items()}


def _placed(par: Parallel, name: str, full: torch.Tensor,
            like: torch.Tensor) -> torch.Tensor:
    """A whole optimizer moment of `name`, laid out as its placed leaf
    `like`: this rank's 'model' slice, then its 'data' shard."""
    mesh = par.mesh
    d = par.model_dim(name)
    if d is not None and full.shape != like.shape:
        full = _own(full, par.n_model, d, mesh.get_local_rank("model"))
    d, index = par.data_dim(name), mesh.get_local_rank("data")
    if name in par.shards:
        return _own(full, par.n_data, d, index)
    if isinstance(like, DTensor):
        return DTensor.from_local(_own(full, par.n_data, d, index),
                                  like.device_mesh, like.placements)
    return full.detach().clone()


def _fully_shard(state, par: Parallel) -> None:
    """zero3: every parameter fp32 (the masters, the frozen leaves' fp32
    values, else the stored value widened), then FSDP2."""
    from torch.distributed.fsdp import (MixedPrecisionPolicy, fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard

    from prismer_tpu_torch.models.layers import use_ln_proj
    needed = {"shard_placement_fn", "ignored_params"}
    if not needed <= set(inspect.signature(fully_shard).parameters):
        raise RuntimeError(f"torch {torch.__version__}: FSDP2's fully_shard "
                           f"takes no {sorted(needed)}, which zero3 needs")
    if use_ln_proj():
        raise ValueError("zero3 keeps fp32 weights, which the ln_proj "
                         "kernels do not take: turn set_ln_proj off")
    model = state.model
    for name, p in list(model.named_parameters()):
        if p.dtype != torch.float32:
            value = state.masters.get(name, state.frozen_fp32.get(name))
            value = p.detach().float() if value is None else value
            # FSDP2 shards only contiguous parameters; masters converted
            # from flax's layout are transposed views
            _set_param(model, name,
                       value.to(p.device, torch.float32).contiguous())
    state.masters.clear()
    state.frozen_fp32.clear()

    params = dict(model.named_parameters())
    dims = {id(p): par.data_dim(n) for n, p in params.items()}
    ignored = {p for n, p in params.items() if dims[id(p)] is None}
    kw = dict(mesh=par.mesh["data"],
              shard_placement_fn=lambda p: Shard(dims[id(p)]),
              mp_policy=MixedPrecisionPolicy(reduce_dtype=torch.float32),
              ignored_params=ignored)
    vit, dec = model.expert_encoder, model.text_decoder
    blocks = [getattr(vit, f"resblocks_{i}") for i in range(vit.cfg.layers)]
    blocks += dec.cross_layers() + [dec.output_layer]
    if hasattr(vit, "resampler"):
        blocks.append(vit.resampler)
    for module in blocks + [model]:
        fully_shard(module, **kw)
        # the step's loss is sum / global batch on each rank: sum the
        # ranks' gradients, as dp's all-reduce does (a plain SUM, which
        # gloo also takes)
        module.set_gradient_divide_factor(1.0)
        module.set_force_sum_reduction_for_comms(True)
        par.fsdp_modules.append(module)
    register_fsdp_forward_method(model, "forward_loss")


def all_reduce_buckets(tensors: List[torch.Tensor], group) -> None:
    """SUM-all-reduce `tensors` in place, a few flat buckets at a time."""
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        bucket.clear()

    for t in tensors:
        if size + t.numel() > BUCKET_ELEMENTS:
            flush()
            size = 0
        bucket.append(t)
        size += t.numel()
    flush()


def _reduce_scatter(full: torch.Tensor, dim: int, group, n: int
                    ) -> torch.Tensor:
    """This rank's shard on `dim` of the SUM over `group` of `full`."""
    moved = full.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _all_gather(shard: torch.Tensor, dim: int, group, n: int
                ) -> torch.Tensor:
    moved = shard.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] * n,) + moved.shape[1:])
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


@torch.no_grad()
def reduce_gradients(state) -> None:
    """Bring every trainable leaf's gradient to the SUM over 'data' of the
    ranks' gradients (each leaf's .grad set, fp32)."""
    par = state.parallel
    params = dict(state.model.named_parameters())
    reduce: List[torch.Tensor] = []
    for name, leaf in state.trainable():
        p = params[name]
        if isinstance(p, DTensor):
            # zero3: FSDP2 reduce-scattered it in the backward
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            continue
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        grad = grad.float()
        if name in par.shards:
            leaf.grad = _reduce_scatter(grad, par.data_dim(name),
                                        par.data_group, par.n_data)
            p.grad = None
            continue
        if leaf is not p:
            p.grad = None
        leaf.grad = grad
        reduce.append(grad)
    if par.n_data > 1:
        all_reduce_buckets(reduce, par.data_group)


@torch.no_grad()
def refresh_weights(state) -> None:
    """zero2: the updated shards all-gathered into the weights."""
    par = state.parallel
    params = dict(state.model.named_parameters())
    for name, shard in par.shards.items():
        params[name].copy_(_all_gather(shard, par.data_dim(name),
                                       par.data_group, par.n_data))


def _full(par: Optional[Parallel], name: str, t: torch.Tensor,
          sharded_on_data: bool) -> torch.Tensor:
    """The whole value of a leaf of `name` held as `t` on this rank."""
    if par is None:
        return t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    elif sharded_on_data:
        t = _all_gather(t.detach(), par.data_dim(name), par.data_group,
                        par.n_data)
    d = par.model_dim(name)
    if d is not None and par.n_model > 1:
        t = _all_gather(t.detach(), d, par.model_group, par.n_model)
    return t.detach()


def full_grads(state) -> Dict[str, torch.Tensor]:
    """Each trainable leaf's gradient, whole (a collective under a mesh:
    every rank calls it)."""
    par = state.parallel
    return {name: _full(par, name, leaf.grad,
                        par is not None and name in par.shards)
            for name, leaf in state.trainable()}


def full_state(state) -> Dict[str, object]:
    """The single-process layout of `state`: the model's state_dict in its
    single-process dtypes, the fp32 masters of its low-precision trainable
    leaves and the optimizer's state_dict over `trainable()` order. A
    collective under a mesh: every rank calls it."""
    par = state.parallel
    if par is None:
        return {"model": state.model.state_dict(), "masters": state.masters,
                "optimizer": state.optimizer.state_dict()}
    params = dict(state.model.named_parameters())
    model = {}
    for name, t in state.model.state_dict().items():
        full = _full(par, name, t, False) if name in params else t.detach()
        model[name] = full.to(par.dtypes.get(name, full.dtype)).cpu()
    masters, opt_state = {}, {}
    for i, (name, leaf) in enumerate(state.trainable()):
        on_data = name in par.shards
        full = _full(par, name, leaf, on_data).float().cpu()
        if par.dtypes[name] != torch.float32:
            masters[name] = full
            if on_data:
                model[name] = full.to(par.dtypes[name])
        elif on_data:
            model[name] = full
        moments = state.optimizer.state.get(leaf)
        if moments:
            opt_state[i] = {k: v.clone().cpu() if k == "step"
                            else _full(par, name, v, on_data).cpu()
                            for k, v in moments.items()}
    groups = [dict(g, params=list(range(len(g["params"]))))
              for g in state.optimizer.param_groups]
    return {"model": model, "masters": masters,
            "optimizer": {"state": opt_state, "param_groups": groups}}


@contextlib.contextmanager
def full_params(state):
    """The model's parameters whole on every rank inside the block (zero3:
    FSDP2 all-gathers them; otherwise nothing to do), e.g. for evaluation
    through methods other than forward."""
    par = state.parallel
    modules = par.fsdp_modules if par is not None else []
    for m in modules:
        m.unshard()
    try:
        yield
    finally:
        for m in reversed(modules):
            m.reshard()
