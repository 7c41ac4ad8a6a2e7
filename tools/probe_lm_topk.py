"""Phase timing inside lm_topk's kernels (kernel 5) on one GPU.

    python3 tools/probe_lm_topk.py [DIR]

Copies DIR's `lm_topk.cu` with the headers it includes (default: the
package's `csrc/`) into the git-ignored `build/probe/` and instruments the
copy: thread 0 of block 0 of `select_kernel` stamps %globaltimer and
clock64 after its programmatic-dependent-launch wait, before each comment
that opens a phase of its body (a comment line indented two spaces), and at
its end; every consumer warpgroup of `logits_kernel` stamps the latest end
of any block. The copy is built as a library with one more C entry point
that reads the stamps back, and called alone (a synchronize before and
after each call) at Prismer-BASE N 24 and at D 1024 N 24, bf16, V 50265,
on `tools/ab_decode_tail.py`'s inputs. Prints the card's name and power
limit, then per call: when the logits kernel's last block ended and the
selection's wait returned (us after the logits kernel's own wait), and
each selection phase's us and cycles; the medians of five calls after one
warm-up.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAMP = ("  if (threadIdx.x == 0 && blockIdx.x == 0) {{ g_probe[{i}] = "
         "probe_time(); g_clk[{i}] = clock64(); }}")
PRELUDE = """
__device__ unsigned long long g_probe[64];
__device__ long long g_clk[64];
__device__ __forceinline__ unsigned long long probe_time() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
"""
READER = """
extern "C" int probe_lm_topk_read(unsigned long long* t, long long* c) {
  cudaMemcpyFromSymbol(t, g_probe, sizeof(g_probe));
  cudaMemcpyFromSymbol(c, g_clk, sizeof(g_clk));
  unsigned long long zero[64] = {0};
  return cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
}
"""


def kernel_span(lines, name):
    """(first, last) line index of the __global__ kernel `name`'s body: its
    signature line and its closing brace at column 0."""
    start = next(i for i, l in enumerate(lines) if l.startswith(name + "("))
    end = next(i for i in range(start, len(lines)) if lines[i] == "}")
    return start, end


def instrument(src: str):
    """The instrumented source and the selection's phase labels."""
    lines = src.split("\n")
    lo, hi = kernel_span(lines, "logits_kernel")
    wait = next(i for i in range(lo, hi) if "grid_dep_wait();" in lines[i])
    lines.insert(hi, "  if (threadIdx.x % 128 == 0) "
                     "atomicMax(&g_probe[1], probe_time());")
    lines.insert(wait + 1, "  if (threadIdx.x == 0 && blockIdx.x == 0) "
                           "g_probe[0] = probe_time();")
    lo, hi = kernel_span(lines, "select_kernel")
    marks = [next(i for i in range(lo, hi)
                  if "grid_dep_launch();" in lines[i]) + 1]   # wait returned
    labels = ["wait"]
    for i in range(marks[0], hi):
        m = re.match(r"  // (\w+(?: \w+)?)", lines[i])
        if m and not lines[i - 1].lstrip().startswith("//"):
            marks.append(i)
            labels.append(m.group(1))
    marks.append(hi)
    labels.append("end")
    for slot, at in sorted(enumerate(marks), key=lambda e: -e[1]):
        lines.insert(at, STAMP.format(i=2 + slot))
    out = "\n".join(lines)
    out = out.replace("namespace {\n", "namespace {\n" + PRELUDE, 1)
    return out + READER, labels


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    import chip_smoke as cs
    from prismer_tpu_torch.ops import _build
    from tools import ab_decode_tail as ab

    argv = sys.argv[1:] if argv is None else argv
    src_dir = Path(argv[0]) if argv else _build.CSRC
    print(cs.card_info(), flush=True)
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    for f in ("common.cuh", "hopper.cuh"):
        shutil.copy(src_dir / f, out / f)
    text, labels = instrument((src_dir / "lm_topk.cu").read_text())
    (out / "lm_topk.cu").write_text(text)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(out / "lib.so"), str(out / "lm_topk.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        print(res.stderr[-3000:])
        return 1
    lib = ctypes.CDLL(str(out / "lib.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.prismer_lm_topk.argtypes = [P] * 8 + [I] * 9 + [P]
    lib.prismer_lm_topk.restype = I
    lib.probe_lm_topk_read.argtypes = [P, P]
    gen = torch.Generator(device="cuda").manual_seed(13)
    for d, b in ((768, 8), (1024, 8)):
        h, emb, bias, alive = ab.lm_case(gen, d, b)
        n, v = h.shape[0], emb.shape[0]
        tiles = -(-v // 64)
        work = torch.empty(n * v + 2 * n * tiles, device="cuda")
        outs = [torch.empty((b, 6), dtype=t, device="cuda")
                for t in (torch.float32, torch.int32, torch.int32)]
        t = (ctypes.c_ulonglong * 64)()
        c = (ctypes.c_longlong * 64)()
        runs = []
        for rep in range(6):
            torch.cuda.synchronize()
            lib.probe_lm_topk_read(ctypes.addressof(t), ctypes.addressof(c))
            err = lib.prismer_lm_topk(
                h.data_ptr(), emb.data_ptr(), bias.data_ptr(),
                alive.data_ptr(), work.data_ptr(),
                *(o.data_ptr() for o in outs), n, b, d, v, tiles, 6, 0, 2, 1,
                torch.cuda.current_stream().cuda_stream)
            if err:
                print(f"cudaError_t {err}")
                return 1
            torch.cuda.synchronize()
            lib.probe_lm_topk_read(ctypes.addressof(t), ctypes.addressof(c))
            if rep:
                runs.append((list(t), list(c)))
        med = statistics.median
        print(f"D={d} N={n}: logits kernel's last block ends "
              f"{med((T[1] - T[0]) / 1e3 for T, _ in runs):.2f} us after its "
              f"wait; the selection's wait returns "
              f"{med((T[2] - T[1]) / 1e3 for T, _ in runs):.2f} us later; "
              "selection phases (us / cycles): " + ", ".join(
                  f"{labels[i]} "
                  f"{med((T[3 + i] - T[2 + i]) / 1e3 for T, _ in runs):.2f} / "
                  f"{med(C[3 + i] - C[2 + i] for _, C in runs):.0f}"
                  for i in range(len(labels) - 1)) +
              "; wait to end "
              f"{med((T[1 + len(labels)] - T[2]) / 1e3 for T, _ in runs):.2f}"
              " us",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
