"""Kernels on any card and from any thread, held on the CPU.

* `_build.launch_device` refuses tensors that are not all on one CUDA
  device, naming the devices, and every kernel launch of the port's
  wrappers (`_build.kernels().prismer_*` in ops/ and experts/ops/) sits
  inside it (an AST scan);
* no source under csrc/ keeps a shared-memory grant, an SM count or the
  current device once per process, and the three tensor-map caches take a
  lock and hand out copies (a scan of the sources);
* `kernels()` reached from 8 threads at once builds and loads the library
  once; `build()` names its temporary files by process and thread.
"""

import ast
import os
import re
import threading
import time
from pathlib import Path

import pytest
import torch

from prismer_tpu_torch.ops import _build

PKG = Path(_build.__file__).resolve().parents[1]
KERNEL_DIRS = (PKG / "ops", PKG / "experts" / "ops")


@pytest.mark.parametrize("devices", [("cpu",), ("meta",), ("cpu", "meta"),
                                     ("meta", "cpu", "cpu")])
def test_launch_device_refuses_what_is_not_one_cuda_device(devices):
    tensors = [torch.zeros(2, device=d) for d in devices]
    with pytest.raises(ValueError) as err:
        _build.launch_device("some_kernel", *tensors, None)
    msg = str(err.value)
    assert msg.startswith("some_kernel:")
    for d in set(devices):
        assert f"'{d}'" in msg
    with pytest.raises(ValueError, match=r"lie on \[\]"):
        _build.launch_device("some_kernel", None)


def _kernel_calls(tree):
    """(call node, its enclosing With nodes) for each `_build.kernels()`."""
    found = []

    def walk(node, withs):
        if isinstance(node, ast.With):
            withs = withs + [node]
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "kernels"):
            found.append((node, withs))
        for child in ast.iter_child_nodes(node):
            walk(child, withs)

    walk(tree, [])
    return found


def _is_guard(with_node) -> bool:
    for item in with_node.items:
        call = item.context_expr
        if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                and call.func.attr == "launch_device"
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id == "_build"):
            return True
    return False


def test_every_kernel_launch_is_inside_the_device_guard():
    sites = []
    for d in KERNEL_DIRS:
        for path in sorted(d.glob("*.py")):
            if path.name == "_build.py":
                continue
            for call, withs in _kernel_calls(ast.parse(path.read_text())):
                sites.append((f"{path.name}:{call.lineno}",
                              any(_is_guard(w) for w in withs)))
    # the wrappers of the 15 kernels and 4b: flash forward, its backward
    # (one call for dq and dk/dv), grouped attention, fused decode,
    # lm_topk, beam_update, ce_stats, ce_grads, layer_norm, ln_proj,
    # adaptor_fused, ms_deform_attn
    assert len(sites) == 12, sites
    assert [s for s, guarded in sites if not guarded] == []


def _sources():
    return {p.name: p.read_text() for p in sorted((PKG / "csrc").glob("*.cu*"))}


def _function_body(src: str, signature: str) -> str:
    start = src.index(signature)
    depth, i = 0, src.index("{", start)
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i:j + 1]
    raise AssertionError(f"unbalanced {signature}")


def test_no_per_process_device_state_is_left_in_csrc():
    srcs = _sources()
    for name, src in srcs.items():
        for pat in (r"static\s+bool\s+granted", r"static\s+size_t\s+granted",
                    r"static\s+int\s+sms\s*=", r"static\s+int\s+granted"):
            assert not re.search(pat, src), (name, pat)
        if name != "hopper.cuh":
            # the device is read, a grant set and an SM count asked for
            # only by hopper.cuh's per-device helpers
            for call in ("cudaGetDevice", "cudaFuncSetAttribute",
                         "cudaDeviceGetAttribute", "grant_smem("):
                assert call not in src, (name, call)
    hopper = srcs["hopper.cuh"]
    assert "bytes_[kMaxDevices]" in hopper and "sms[kMaxDevices]" in hopper
    # a device past the tables is an error, not a silent miss
    assert "cudaErrorInvalidDevice" in _function_body(
        hopper, "inline cudaError_t current_device(")
    grants = sum(len(re.findall(r"static hopper::SmemGrant", s))
                 + len(re.findall(r"static SmemGrant", s))
                 for s in srcs.values())
    assert grants >= 20


@pytest.mark.parametrize("source,signature", [
    ("hopper.cuh", "inline bool cached_bf16_map("),
    ("lm_topk.cu", "bool embedding_map("),
    ("fused_decode.cu", "bool weight_maps("),
])
def test_tensor_map_caches_lock_and_copy_out(source, signature):
    body = _function_body(_sources()[source], signature)
    lock = body.index("std::lock_guard<std::mutex>")
    assert "static std::mutex" in body[:lock]
    # every return of a cached map copies it to the caller's buffer first
    assert body.count("*out = ") >= 2
    assert "return &" not in body


def test_fused_decode_launch_count_is_per_thread():
    src = _sources()["fused_decode.cu"]
    assert "thread_local int g_launches" in src


def test_kernels_from_eight_threads_build_and_load_once(monkeypatch):
    counts = {"build": 0, "load": 0}

    def build():
        counts["build"] += 1
        time.sleep(0.05)                 # widen the window for a second one
        return Path("/nonexistent/libprismer_kernels_test.so")

    class FakeLib:
        def __init__(self, path):
            counts["load"] += 1
            self.path = path

        def __getattr__(self, name):     # each entry point: argtypes etc.
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    start = threading.Barrier(8)
    got = []

    def run():
        start.wait()
        got.append(_build.kernels())

    threads = [threading.Thread(target=run) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts == {"build": 1, "load": 1}
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert got[0].prismer_lm_topk.restype is _build._I


def test_build_runs_once_and_names_its_files_by_process_and_thread(
        tmp_path, monkeypatch):
    """Four threads reach build() together: one compiles (every source, one
    object each, then the link into a temporary library named by pid and
    thread id, renamed into place); the others find the library."""
    out = tmp_path / "libprismer_kernels_test.so"
    commands = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            commands.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"obj")

        def communicate(self):
            time.sleep(0.02)
            return "", ""

    def run(cmd, **kw):
        commands.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return type("R", (), {"returncode": 0, "stdout": "", "stderr": ""})()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda: out)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build.subprocess, "run", run)
    start = threading.Barrier(4)
    results, idents = [], {}

    def go():
        start.wait()
        results.append(_build.build())
        idents[threading.get_ident()] = True

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    n_src = len(list((PKG / "csrc").glob("*.cu")))
    assert results == [out] * 4 and out.read_bytes() == b"lib"
    assert len(commands) == n_src + 1            # one build: nvcc -c each, link
    names = [Path(c[c.index("-o") + 1]).name for c in commands]
    tags = {re.match(r"libprismer_kernels_test\.(\d+)\.(\d+)\.", n).groups()
            for n in names}
    assert len(tags) == 1
    pid, ident = tags.pop()
    assert int(pid) == os.getpid() and int(ident) in idents
    assert not list(tmp_path.glob("*.o")) and not list(tmp_path.glob("*.tmp"))
