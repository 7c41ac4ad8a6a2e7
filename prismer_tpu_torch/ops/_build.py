"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Every `*.cu` file under `prismer_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`), one `nvcc` process per source, all started together, and
the objects are linked into one shared library under `build/kernels/` at the
repo root, at first use. The file name carries a hash of the sources
(headers included) and flags, so an edited source rebuilds and a stale
library is never loaded. Nothing here
runs at import time: the CPU tests import every module of the package, and
only a kernel wrapper handed a CUDA tensor reaches this code.

A process may launch on any of its cards and from any thread. Every wrapper
launches inside `launch_device(name, *tensors)`, which checks that the
kernel's tensors lie on one CUDA device and makes that device current for
the launch (the C entries read it with `cudaGetDevice` and keep their
shared-memory grants, SM counts and tensor-map caches per device, under a
lock). `build()` and the first `kernels()` run under one lock, so threads
that reach them together build and load the library once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
# build() and the first kernels(); re-entrant, since kernels() builds
_LOCK = threading.RLock()
_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libprismer_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the current sources have no library yet."""
    with _LOCK:
        return _build()


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # files named by process and thread: pytest workers and ranks build at
    # once, and no two builders write one file
    tag = f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                          f"\n{stdout}\n{stderr}")
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    if not errors:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            errors.append(f"nvcc link failed ({res.returncode}):\n"
                          f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    os.replace(tmp, out)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built and loaded once, on first call."""
    global _LIB
    lib = _LIB
    if lib is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _load()
            lib = _LIB
    return lib


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.prismer_flash_attention.argtypes = (
        [_P] * 6 + [_I] * 5 + [_L] * 13 + [_I, _I, _F, _P])
    lib.prismer_flash_attention.restype = _I
    lib.prismer_beam_update.argtypes = (
        [_P] * 13 + [_I] * 4 + [_F, _I, _I, _P])
    lib.prismer_beam_update.restype = _I
    lib.prismer_fused_decode_step.argtypes = (
        [_P] * 17 + [_I] * 11 + [_F, _F, _P])
    lib.prismer_fused_decode_step.restype = _I
    lib.prismer_fused_decode_launches.argtypes = []
    lib.prismer_fused_decode_launches.restype = _I
    lib.prismer_lm_topk.argtypes = [_P] * 8 + [_I] * 9 + [_P]
    lib.prismer_lm_topk.restype = _I
    for name, outs in (("prismer_flash_attention_bwd_dq", 1),
                       ("prismer_flash_attention_bwd_dkv", 2)):
        fn = getattr(lib, name)
        fn.argtypes = ([_P] * (7 + outs) + [_I] * 5
                       + [ctypes.POINTER(_L), _L, _I, _I, _F, _P])
        fn.restype = _I
    lib.prismer_ce_stats.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.prismer_ce_stats.restype = _I
    lib.prismer_ce_grads.argtypes = [_P] * 10 + [_I] * 5 + [_F, _F, _I, _P]
    lib.prismer_ce_grads.restype = _I
    lib.prismer_ms_deform_attn.argtypes = [_P] * 5 + [_I] * 10 + [_P]
    lib.prismer_ms_deform_attn.restype = _I
    lib.prismer_layer_norm.argtypes = [_P] * 4 + [_I] * 2 + [_F, _I, _P]
    lib.prismer_layer_norm.restype = _I
    lib.prismer_ln_proj.argtypes = ([_P] * 12 + [_I] * 6
                                    + [_F, _I, _I, _P, _I, _I, _P])
    lib.prismer_ln_proj.restype = _I
    lib.prismer_adaptor_fused.argtypes = ([_P] * 8 + [_I] * 2
                                          + [_F, _I, _P, _I, _I, _P])
    lib.prismer_adaptor_fused.restype = _I
    lib.prismer_grouped_attention.argtypes = (
        [_P] * 4 + [_I] * 5 + [_L] * 6 + [_I, _I, _F, _P])
    lib.prismer_grouped_attention.restype = _I
    return lib


def launch_device(name: str, *tensors) -> torch.cuda.device:
    """The one CUDA device of a kernel's tensors (None entries skipped), as
    a context that makes it current for the launch; ValueError naming the
    devices when they are not all on one CUDA device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: the kernel's tensors lie on "
                         f"{sorted(map(str, devices))}; it takes them all on "
                         "one CUDA device")
    return torch.cuda.device(devices.pop())


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
