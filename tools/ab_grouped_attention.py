"""A/B of the grouped decode cross-attention kernel on one GPU.

    python3 tools/ab_grouped_attention.py [--check] [--costs] DIR [DIR ...]

Each DIR holds another `decode_attention.cu` (with the `common.cuh` and
`hopper.cuh` it includes), e.g. an earlier commit's source:

    mkdir -p build/ab/old && for f in decode_attention.cu common.cuh \\
        hopper.cuh; do git show <commit>:prismer_tpu_torch/csrc/$f \\
        > build/ab/old/$f; done

It is built as a second library beside the port's own and timed against
`ops.decode_attention.grouped_cross_attention` at the bf16 model shapes of
`chip_smoke.DECODE_ATTENTION_SHAPES`, both modes, in turns old, new, new,
old: device ms per call from CUDA-graph replays, warm (one K/V set, in L2)
and cold (cycling one set per cross layer, from HBM), beside the largest
difference of the outputs. A source whose C entry point takes no K/V
strides (before the strided entry) is called with contiguous K/V.
`--check` first runs `chip_smoke.check_decode_attention` (correctness,
timings, ptxas) on the port's own kernel. `--costs` times trivial kernels
of 768 blocks, alone and in clusters of 8 with 0, 1, 3 and 10 cluster
barriers: the launch and barrier costs that bound a split's exchanges.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

COSTS_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void k_plain(int* sink) {
  if (threadIdx.x == 1000) sink[0] = 1;
}
__global__ void __cluster_dims__(8, 1, 1) k_cluster(int* sink, int syncs) {
  cg::cluster_group c = cg::this_cluster();
  for (int i = 0; i < syncs; ++i) c.sync();
  if (threadIdx.x == 1000) sink[0] = 1;
}
extern "C" int costs(int syncs, int blocks, int smem, void* sink,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(k_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  if (syncs < 0) {
    k_plain<<<blocks, 128, 0, st>>>(static_cast<int*>(sink));
  } else {
    k_cluster<<<blocks, 128, smem, st>>>(static_cast<int*>(sink), syncs);
  }
  return cudaGetLastError();
}
"""


def build(src: Path, out: Path, nvcc: str, flags) -> subprocess.Popen:
    return subprocess.Popen([nvcc, *flags, "-shared", "-o", str(out),
                             str(src)], stderr=subprocess.PIPE, text=True)


def loaded(out: Path, proc: subprocess.Popen) -> ctypes.CDLL:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out}:\n{err[-3000:]}")
    return ctypes.CDLL(str(out))


def runner(lib: ctypes.CDLL, src: Path, mode: int):
    """Call another library's prismer_grouped_attention; with no K/V
    strides in its entry point (the one-block-per-head source), on
    contiguous K/V."""
    import torch
    P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                  ctypes.c_float)
    fn = lib.prismer_grouped_attention
    strided = "k_sb" in src.read_text()
    fn.argtypes = ([P] * 4 + [I] * 5 + [L] * 6 + [I, I, F, P] if strided
                   else [P] * 4 + [I] * 7 + [F, P])
    fn.restype = I

    def run(q, k, v):
        b, h, nq, dh = q.shape
        out = torch.empty_like(q)
        if not strided:
            k, v = k.contiguous(), v.contiguous()
        mid = [*k.stride()[:3], *v.stride()[:3]] if strided else []
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                 h, nq, k.shape[2], dh, *mid, mode, 1, dh ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib._name}: cudaError_t {err}")
        return out
    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="*", type=Path)
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--costs", action="store_true")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    import chip_smoke as cs
    from prismer_tpu_torch.ops import _build
    from prismer_tpu_torch.ops import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_info(), flush=True)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    jobs = {d: (d / "lib.so", build(d / "decode_attention.cu", d / "lib.so",
                                    nvcc, flags)) for d in args.dirs}
    costs = None
    if args.costs:
        src = _build.BUILD_DIR / "ab_costs.cu"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(COSTS_CU)
        costs = (src.with_suffix(".so"), build(src, src.with_suffix(".so"),
                                               nvcc, flags))
    _build.build()
    _build.kernels()
    if args.check:
        cs.check_decode_attention({n: {"max_abs_err": 0.0, "launches": 0}
                                   for n, _, _ in cs.KERNELS})
    libs = {d: loaded(*job) for d, job in jobs.items()}

    if costs is not None:
        lib = loaded(*costs)
        lib.costs.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        sink = torch.zeros(1, dtype=torch.int32, device="cuda")

        def launch(syncs, smem):
            return lambda: lib.costs(syncs, 768, smem, sink.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
        line = [f"no cluster {cs.graph_ms(launch(-1, 0)):.4f}"]
        for syncs in (0, 1, 3, 10):
            line.append(f"clusters of 8, 37 KB, {syncs} barriers "
                        f"{cs.graph_ms(launch(syncs, 37 * 1024)):.4f}")
        print("  768 blocks, graph ms: " + ", ".join(line), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(7)
    for label, b, h, l, nq, layers in cs.DECODE_ATTENTION_SHAPES:
        q = torch.randn(b, h, nq, 64, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        sets = [(q, *(torch.randn(b, h, l, 64, generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(2)))
                for _ in range(layers)]
        for mode, name in enumerate(da.MODES):
            def new(q, k, v):
                return da.grouped_cross_attention(q, k, v, name)
            for d, lib in libs.items():
                old = runner(lib, d / "decode_attention.cu", mode)
                diff = (new(*sets[0]).float() - old(*sets[0]).float()).abs()
                warm, cold = {"old": [], "new": []}, {"old": [], "new": []}
                for who in ("old", "new", "new", "old"):
                    fn = old if who == "old" else new
                    warm[who].append(cs.graph_ms(lambda: fn(*sets[0])))
                    cold[who].append(cs.cycle_ms(fn, sets))
                w = {k: sum(x) / 2 for k, x in warm.items()}
                c = {k: sum(x) / 2 for k, x in cold.items()}
                print(f"  {label} B={b} H={h} L={l} Q={nq} {name} vs {d}: "
                      f"warm old {w['old']:.4f} new {w['new']:.4f} ms "
                      f"({w['new'] / w['old']:.2f}x), cold old "
                      f"{c['old']:.4f} new {c['new']:.4f} ms "
                      f"({c['new'] / c['old']:.2f}x); runs warm "
                      f"{[round(x, 5) for x in warm['old'] + warm['new']]} "
                      f"cold {[round(x, 5) for x in cold['old'] + cold['new']]}"
                      f"; max|new - old| {diff.max().item():.3g}",
                      flush=True)
        del sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
