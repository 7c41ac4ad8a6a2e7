"""Tracing / timing harness, ported from prismer_tpu/train/profiling.py.

  with trace("logging/trace"):      # torch.profiler: a Chrome trace file
      step(state, batch)            # in the directory (chrome://tracing,
                                    # Perfetto)

  t = timeit_readback(fn, *args)    # per-call seconds that include a host
                                    # readback of a checksum of the outputs

On CUDA `trace` records CPU and CUDA activity; without a CUDA device it
records the CPU only.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Iterator

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block; writes `trace_<pid>_<n>.json` into log_dir."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _checksum(tree: Any) -> float:
    """The fp32 sum over every numeric tensor or array leaf, read back to
    the host."""
    total = 0.0
    for x in _leaves(tree):
        if (isinstance(x, torch.Tensor) and x.dtype != torch.bool
                and not x.dtype.is_complex):
            total = total + x.detach().float().sum()
        elif isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.number):
            total = total + torch.from_numpy(x.astype(np.float32)).sum()
    return float(total)


def timeit_readback(fn: Callable, *args, repeats: int = 3,
                    warmup: int = 1) -> Dict[str, float]:
    """Times fn(*args) end to end, including a host readback of a checksum
    over its outputs. Returns {'min', 'mean', 'max'} seconds."""
    cuda = torch.cuda.is_available()
    for _ in range(warmup):
        _checksum(fn(*args))
    times = []
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _checksum(fn(*args))
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"min": float(np.min(times)), "mean": float(np.mean(times)),
            "max": float(np.max(times))}
