"""The process runtime of the port: one rank per process.

JAX needs no runtime of its own (`jax.distributed.initialize` and the
mesh); the port opens a `torch.distributed` process group. `init` reads
the variables `torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), puts the process on its card before any CUDA work and opens
the group: NCCL for CUDA, gloo for the CPU. `spawn` starts ranks on one
machine over a `FileStore` in a directory (no port is opened), for tests
and the smoke run.

Ranks are processes, never threads: a process holds one group and one
current card, so `init` refuses a second group in a process and any thread
but the main one. (The kernels themselves launch on any card and from any
thread: ops/_build.py `launch_device`.)
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """NCCL for CUDA, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise RuntimeError(f"{name} is not set: start the ranks with "
                           "torchrun, or give init rank= and world_size=")
    return int(os.environ[name])


def init(device="cuda", backend: Optional[str] = None,
         store: Optional[dist.Store] = None, rank: Optional[int] = None,
         world_size: Optional[int] = None,
         local_rank: Optional[int] = None) -> None:
    """Open this process's group. Without a store the rendezvous is
    torchrun's (`env://`: MASTER_ADDR, MASTER_PORT); rank, world size and
    local rank default to RANK, WORLD_SIZE and LOCAL_RANK. On CUDA the
    process takes card `local_rank` first."""
    if threading.current_thread() is not threading.main_thread():
        raise RuntimeError("runtime.init from a thread other than the main "
                           "one: a rank is a process, with one process "
                           "group and one card made current")
    if dist.is_initialized():
        raise RuntimeError("a process group is already open in this "
                           "process: one rank per process")
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank)
    backend = backend or backend_for(device)
    if store is None:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size)
    else:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world(group=None) -> int:
    """Ranks in `group` (the whole group by default); 1 without one."""
    return dist.get_world_size(group) if initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if initialized() else 0


def is_main() -> bool:
    return rank() == 0


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's `obj`, in rank order ([obj] without a group)."""
    if not initialized():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank `src`'s `obj` on every rank (`obj` without a group)."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def shutdown() -> None:
    if initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# spawn: ranks on one machine
# ---------------------------------------------------------------------------

def _child(rank_: int, world_size: int, fn: Callable, args: Sequence,
           device: str, backend: Optional[str], store_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        local = 0
        if torch.device(device).type == "cuda":
            local = rank_ % torch.cuda.device_count()
        store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
        init(device, backend, store, rank_, world_size, local)
        try:
            result = fn(*args)
            torch.save(result, os.path.join(store_dir, f"result_{rank_}.pt"))
        finally:
            shutdown()
    except BaseException:
        with open(os.path.join(store_dir, f"error_{rank_}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def spawn(fn: Callable, world_size: int, device: str, store_dir: str,
          args: Sequence = (), backend: Optional[str] = None,
          timeout: float = 600.0) -> List[Any]:
    """Run fn(*args) in `world_size` new processes, one rank each, over a
    FileStore in `store_dir` (an empty directory); returns each rank's
    result (saved with torch.save), in rank order. `fn` must be importable
    by name (a module's top-level function). Raises with the ranks'
    tracebacks if any rank fails; once one has failed, or after `timeout`
    seconds, the ranks still running are killed."""
    import multiprocessing

    os.makedirs(store_dir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, world_size, fn, args, device,
                                              backend, store_dir))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    while any(p.is_alive() for p in procs):
        if time.monotonic() > deadline or any(
                p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.05)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(store_dir, f"error_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if hung:
        errors.append(f"ranks {hung} killed: still running after another "
                      f"rank failed or {timeout} s passed")
    if errors:
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
    return [torch.load(os.path.join(store_dir, f"result_{r}.pt"),
                       weights_only=False) for r in range(world_size)]
