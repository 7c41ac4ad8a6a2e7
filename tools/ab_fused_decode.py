"""A/B of the fused decode step (kernels 4 and 4b) on one GPU.

    python3 tools/ab_fused_decode.py [--split] [--no-time] DIR [DIR ...]

Each DIR holds another `fused_decode.cu` with the headers it includes
(`common.cuh`, and `hopper.cuh` where it includes it), e.g. an earlier
commit's source:

    mkdir -p build/ab/old && for f in fused_decode.cu common.cuh \\
        hopper.cuh; do git show <commit>:prismer_tpu_torch/csrc/$f \\
        > build/ab/old/$f; done

It is built as a second library beside the port's own and called through
the same C entry point as `ops.fused_decode.fused_decode_step`, on the same
random bf16 inputs (`chip_smoke._fused_case`, with the beam reorder), at
Prismer-BASE N 24, 15 and 48 and the HUGE decoder at N 24, each with the
cross K/V in bf16 and in int8. Old and new are timed in turns (old, new,
new, old): device ms per step from CUDA-graph replays (`graph`, the device
alone) and from CUDA events around eager calls (`events`, the host's issue
of every launch included), beside the largest difference of the outputs.

`--split` adds, for each source at BASE N 24 and HUGE N 24 (int8 off and
on), a torch.profiler view of three steps: device ms per step by phase
(each projection by its matrix, the LayerNorm kernels, self- and
cross-attention), the kernels launched per step, the device span a step
covers (overlapping kernels counted once) and the projections' achieved
TB/s (the step's weight bytes over their summed device time). With
programmatic dependent launch a kernel's span starts when its first block
is resident, waiting included, so the summed times of such a step overlap.
`--no-time` skips the A/B timing. Prints the card's name and power limit
first; the whole record is also written to
`chiprun_out/ab_fused_decode.json`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

def build(src: Path, out: Path, nvcc: str, flags) -> subprocess.Popen:
    return subprocess.Popen([nvcc, *flags, "-shared", "-o", str(out),
                             str(src)], stderr=subprocess.PIPE, text=True)


def loaded(out: Path, proc: subprocess.Popen) -> ctypes.CDLL:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out}:\n{err[-3000:]}")
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.prismer_fused_decode_step.argtypes = [P] * 17 + [I] * 11 + [F, F, P]
    lib.prismer_fused_decode_step.restype = I
    return lib


def runner(lib: ctypes.CDLL, heads: int):
    """fused_decode_step's call into another library (bf16, reorder on)."""
    import torch

    def run(x, index, fb, outk, outv):
        n, d = x["hidden0"].shape
        nlc, b, l_enc, _ = x["cross_k"].shape
        nl, t = x["self_k"].shape[:2]
        f = (x["w_all"].numel() - (8 * nlc + 4) * d * d) // (2 * d * nl)
        quant = "cross_ks" in x
        hidden = torch.empty((n, d), dtype=torch.bfloat16, device="cuda")
        k_new = torch.empty((nl, n, d), dtype=torch.bfloat16, device="cuda")
        v_new = torch.empty_like(k_new)
        work = torch.empty(n * (7 * d + max(d, f)), dtype=torch.bfloat16,
                           device="cuda")
        err = lib.prismer_fused_decode_step(
            x["hidden0"].data_ptr(), x["w_all"].data_ptr(),
            x["b_all"].data_ptr(), x["self_k"].data_ptr(),
            x["self_v"].data_ptr(), outk.data_ptr(), outv.data_ptr(),
            fb.data_ptr(), x["key_mask"].data_ptr(), x["cross_k"].data_ptr(),
            x["cross_v"].data_ptr(),
            x["cross_ks"].data_ptr() if quant else None,
            x["cross_vs"].data_ptr() if quant else None, hidden.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), work.data_ptr(), n, b, d,
            heads, f, nl, nlc, t, l_enc, index, 1, 1e-5,
            1.0 / math.sqrt(d // heads),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib._name}: cudaError_t {err}")
        return hidden, k_new, v_new
    return run


def new_runner(heads: int):
    from prismer_tpu_torch.ops import fused_decode as fd

    def run(x, index, fb, outk, outv):
        return fd.fused_decode_step(
            x["hidden0"], x["w_all"], x["b_all"], x["self_k"], x["self_v"],
            x["key_mask"], x["cross_k"], x["cross_v"], index, fb, outk, outv,
            heads=heads, eps=1e-5, cross_ks=x.get("cross_ks"),
            cross_vs=x.get("cross_vs"))[:3]
    return run


def bf16_case(gen, b, dims, quant):
    """chip_smoke's fused-step inputs in bf16 (int8 cross K/V with their
    scales when `quant`)."""
    import torch
    import chip_smoke as cs
    case = cs._fused_case(gen, b, 3, 10, dims)
    index, fb = case.pop("index"), case.pop("flat_beam")
    x = {k: (v.to(torch.bfloat16) if v.is_floating_point() and k != "b_all"
             else v) for k, v in case.items()}
    if quant:
        x.update(cs._quantized(case, dims["heads"]))
    del case
    return x, index, fb


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="*", type=Path)
    parser.add_argument("--split", action="store_true")
    parser.add_argument("--no-time", action="store_true")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    import chip_smoke as cs
    from prismer_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_info()
    print(card, flush=True)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    jobs = {d: (d / "lib.so", build(d / "fused_decode.cu", d / "lib.so",
                                    nvcc, flags)) for d in args.dirs}
    _build.build()
    _build.kernels()
    libs = {d: loaded(*job) for d, job in jobs.items()}
    record = {"card": card, "time": [], "split": []}

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = [("BASE", cs.BASE, 8), ("BASE", cs.BASE, 5), ("BASE", cs.BASE, 16),
             ("HUGE", cs.HUGE_DEC, 8)]
    for label, dims, b in cases:
        for quant in (False, True):
            x, index, fb = bf16_case(gen, b, dims, quant)
            outk = torch.empty_like(x["self_k"])
            outv = torch.empty_like(x["self_v"])
            new = new_runner(dims["heads"])
            who = f"{label} N={3 * b} int8={quant}"
            if args.split and b == 8:
                for d, lib in [("new", None), *libs.items()]:
                    run = new if lib is None else runner(lib, dims["heads"])
                    s = cs.fused_step_split(
                        lambda: run(x, index, fb, outk, outv), x["w_all"],
                        dims["nlc"])
                    s.update(case=who, source=str(d))
                    record["split"].append(s)
                    print(f"  split {who} {d}: "
                          f"{s['profiled_launches_per_step']:.0f} launches per "
                          f"step, span {s['span_ms']:.4f} ms, summed "
                          f"{s['summed_ms']:.4f} ms, projections "
                          f"{s['projections_ms']:.4f} ms "
                          f"({s['projection_tb_s']:.3f} TB/s); "
                          + ", ".join(f"{k} {v:.4f}"
                                      for k, v in s["split_ms"].items()),
                          flush=True)
            if args.no_time:
                continue
            for d, lib in libs.items():
                old = runner(lib, dims["heads"])
                got = new(x, index, fb, outk, outv)
                ref = old(x, index, fb, outk.clone(), outv.clone())
                diff = max((g.float() - r.float()).abs().max().item()
                           for g, r in zip(got, ref))
                times = {"old": {"graph": [], "events": []},
                         "new": {"graph": [], "events": []}}
                for w in ("old", "new", "new", "old"):
                    fn = old if w == "old" else new

                    def call():
                        return fn(x, index, fb, outk, outv)
                    times[w]["graph"].append(cs.graph_ms(call, iters=10))
                    times[w]["events"].append(cs.cuda_ms(call, iters=10))
                m = {w: {k: sum(v) / 2 for k, v in t.items()}
                     for w, t in times.items()}
                record["time"].append(dict(case=who, old=str(d), runs=times,
                                           max_abs_diff=diff))
                print(f"  {who} vs {d}: graph old {m['old']['graph']:.4f} new "
                      f"{m['new']['graph']:.4f} ms "
                      f"({m['new']['graph'] / m['old']['graph']:.2f}x), "
                      f"events old {m['old']['events']:.4f} new "
                      f"{m['new']['events']:.4f} ms "
                      f"({m['new']['events'] / m['old']['events']:.2f}x); "
                      f"runs {times}; max|new - old| {diff:.3g}", flush=True)
            del x, outk, outv
            torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_fused_decode.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
