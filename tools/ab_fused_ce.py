"""A/B of the fused label-smoothed CE, `ce_stats` (kernel 8) and `ce_grads`
(kernel 9), on one GPU.

    python3 tools/ab_fused_ce.py [--split] DIR [DIR ...]

Each DIR holds another `fused_ce.cu` with the headers it includes
(`common.cuh`, `hopper.cuh`) and the wrapper that called it
(`fused_ce.py`), e.g. an earlier commit's:

    mkdir -p build/ab/old && for f in csrc/fused_ce.cu csrc/common.cuh \\
        csrc/hopper.cuh ops/fused_ce.py; do git show \\
        <commit>:prismer_tpu_torch/$f > build/ab/old/${f#*/}; done

The source is built as a second library beside the port's own; the old
wrapper is loaded from DIR and reaches that library in place of the port's
(`_build.kernels` is swapped around each old call), so the C entry points
keep their signatures. Old and new take the same random bf16 inputs
(V 50265; N 116, 464 and 37 at D 768, N 116 at D 1024: the caption
fine-tune at batch 4 and 16, a short batch, and the LARGE / HUGE decoder
width) and are timed in turns (old, new, new, old), each as device ms per
call from CUDA-graph replays (`graph`) and from CUDA events around eager
calls of the wrapper (`events`). Beside them, once per shape: the plain
versions (`ce_stats_reference`, `ce_grads_reference`) by graph replay, the
bf16 `torch.matmul(h, emb.t())` of the logits product alone (a yardstick,
not a call of the same function), and each output's rel L2 to the plain
version for old and new. `--split` adds, for each source and shape, a
torch.profiler view of ten calls: device ms per call by kernel, each kernel
charged the time by which it extends the span past the kernels before it
(under programmatic dependent launch a kernel's own time includes its
wait). Prints the card's name and power limit first; the whole record is
also written to `chiprun_out/ab_fused_ce.json`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from ab_decode_tail import kernel_split, old_call, wrapper_module  # noqa: E402

SHAPES = ((116, 768), (464, 768), (37, 768), (116, 1024))   # (N, D)
V, SMOOTHING = 50265, 0.1


def build(d: Path, nvcc: str, flags) -> subprocess.Popen:
    return subprocess.Popen(
        [nvcc, *flags, "-shared", "-o", str(d / "lib.so"),
         str(d / "fused_ce.cu")], stderr=subprocess.PIPE, text=True)


def loaded(d: Path, proc: subprocess.Popen) -> ctypes.CDLL:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {d}:\n{err[-3000:]}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.prismer_ce_stats.argtypes = [P] * 8 + [I] * 5 + [P]
    lib.prismer_ce_stats.restype = I
    lib.prismer_ce_grads.argtypes = [P] * 10 + [I] * 5 + [F, F, I, P]
    lib.prismer_ce_grads.restype = I
    return lib


def ce_case(gen, n, d):
    """chip_smoke.check_fused_ce's inputs in bf16: labels 0, V - 1 and
    V - 2 in the first rows, about a fifth of the rows with gv = 0."""
    import torch
    emb = (torch.randn(V, d, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    bias = torch.randn(V, generator=gen, device="cuda") * 0.1
    h = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    lab = torch.randint(0, V, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    lab[:3] = torch.tensor([0, V - 1, V - 2], dtype=torch.int32)[:n]
    valid = (torch.rand(n, generator=gen, device="cuda") > 0.2).float()
    return h, emb, bias, lab, (valid * 0.25).contiguous()


def rel_l2(got, want) -> float:
    g, w = got.double(), want.double()
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item()


def timed(cs, calls):
    """old, new, new, old: graph ms and events ms of each."""
    runs = {w: {"graph": [], "events": []} for w in calls}
    for w in ("old", "new", "new", "old"):
        fn = calls[w]
        runs[w]["graph"].append(cs.graph_ms(fn, iters=20))
        runs[w]["events"].append(cs.cuda_ms(fn, iters=20))
    mean = {w: {k: sum(v) / len(v) for k, v in r.items()}
            for w, r in runs.items()}
    return runs, mean


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="+", type=Path)
    parser.add_argument("--split", action="store_true")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from prismer_tpu_torch.ops import _build
    from prismer_tpu_torch.ops import fused_ce as fc

    card = cs.card_info()
    print(card, flush=True)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    jobs = {d: build(d, nvcc, flags) for d in args.dirs}
    _build.build()
    _build.kernels()
    libs = {d: loaded(d, p) for d, p in jobs.items()}
    olds = {d: wrapper_module(d / "fused_ce.py", f"old_fused_ce_{i}")
            for i, d in enumerate(args.dirs)}
    record = {"card": card, "cases": []}

    gen = torch.Generator(device="cuda").manual_seed(13)
    for n, d_model in SHAPES:
        h, emb, bias, lab, gv = ce_case(gen, n, d_model)
        who = f"N={n} D={d_model}"
        want_st = fc.ce_stats_reference(h, emb, bias, lab)
        lse = want_st[2]
        want_gr = fc.ce_grads_reference(h, emb, bias, lab, gv, lse,
                                        SMOOTHING)
        plain = {"stats": cs.graph_ms(
            lambda: fc.ce_stats_reference(h, emb, bias, lab), iters=5),
            "grads": cs.graph_ms(lambda: fc.ce_grads_reference(
                h, emb, bias, lab, gv, lse, SMOOTHING), iters=5)}
        matmul = cs.graph_ms(lambda: torch.matmul(h, emb.t()), iters=20)
        print(f"  {who}: plain stats {plain['stats']:.4f} grads "
              f"{plain['grads']:.4f} ms graph; bf16 matmul(h, emb^T) "
              f"{matmul:.4f} ms", flush=True)
        for d, lib in libs.items():
            calls = {}
            errs = {}
            for w, mod in (("old", olds[d]), ("new", fc)):
                st = old_call(lib, mod.ce_stats) if w == "old" else \
                    mod.ce_stats
                gr = old_call(lib, mod.ce_grads) if w == "old" else \
                    mod.ce_grads
                got_st = st(h, emb, bias, lab)
                got_gr = gr(h, emb, bias, lab, gv, lse, SMOOTHING)
                again = gr(h, emb, bias, lab, gv, lse, SMOOTHING)
                torch.cuda.synchronize()
                errs[w] = {
                    "xlab/sumx/lse": [rel_l2(g, r)
                                      for g, r in zip(got_st, want_st)],
                    "dh/demb/dbias": [rel_l2(g, r)
                                      for g, r in zip(got_gr, want_gr)],
                    "repeat": all(torch.equal(a, b)
                                  for a, b in zip(got_gr, again))}
                calls[w] = (lambda st=st: st(h, emb, bias, lab),
                            lambda gr=gr: gr(h, emb, bias, lab, gv, lse,
                                             SMOOTHING))
            runs_st, m_st = timed(cs, {w: c[0] for w, c in calls.items()})
            runs_gr, m_gr = timed(cs, {w: c[1] for w, c in calls.items()})
            split = {}
            if args.split:
                split = {w: {"stats": kernel_split(c[0]),
                             "grads": kernel_split(c[1])}
                         for w, c in calls.items()}
                print(f"  {who} split vs {d}: {split}", flush=True)
            record["cases"].append(dict(
                case=who, old=str(d), stats=dict(runs=runs_st, mean=m_st),
                grads=dict(runs=runs_gr, mean=m_gr), plain=plain,
                matmul=matmul, errors=errs, split=split))
            for name, m in (("ce_stats", m_st), ("ce_grads", m_gr)):
                print(f"  {who} {name} vs {d}: graph old "
                      f"{m['old']['graph']:.4f} new {m['new']['graph']:.4f} "
                      f"ms ({m['new']['graph'] / m['old']['graph']:.3f}x), "
                      f"events old {m['old']['events']:.4f} new "
                      f"{m['new']['events']:.4f} ms", flush=True)
            print(f"  {who} rel L2 to plain: {errs}; runs stats {runs_st} "
                  f"grads {runs_gr}", flush=True)
        del h, emb, bias, lab, gv, want_st, want_gr
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_fused_ce.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
