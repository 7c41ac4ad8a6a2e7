"""A/B of the decode loop's tail, `lm_topk` (kernel 5) and `beam_update`
(kernel 3), on one GPU.

    python3 tools/ab_decode_tail.py [--split] DIR [DIR ...]

Each DIR holds another `lm_topk.cu` and `beam_update.cu` with the headers
they include (`common.cuh`, `hopper.cuh`) and the wrappers that called them
(`lm_topk.py`, `beam_update.py`), e.g. an earlier commit's:

    mkdir -p build/ab/old && for f in csrc/lm_topk.cu csrc/beam_update.cu \\
        csrc/common.cuh csrc/hopper.cuh ops/lm_topk.py ops/beam_update.py; \\
        do git show <commit>:prismer_tpu_torch/$f > build/ab/old/${f#*/}; \\
        done

Both sources are built as a second library beside the port's own; the old
wrappers are loaded from DIR and reach that library in place of the port's
(`_build.kernels` is swapped around each old call). Old and new take the
same random inputs and are timed in turns (old, new, new, old):

  * lm_topk, bf16, V 50265: N 15, 24, 48 at D 768 (Prismer-BASE at batch
    5, 8, 16, beam 3) and N 24 at D 1024 (LARGE / HUGE);
  * beam_update: B 8, 5, 16 at K 3, T 20;

each as device ms per call from CUDA-graph replays (`graph`), ms per call
from CUDA events around eager calls of the wrapper (`events`), and the
host's microseconds to issue one call (`host_us`: perf_counter around 200
eager calls, then one synchronize), beside whether the outputs agree
(lm_topk: indices equal, values within chip_smoke.TOL_TOPK; beam_update:
bit-equal). lm_topk's `tb_s` is the embedding's bytes over the graph time.
`--split` adds, for each source and shape, a torch.profiler view of ten
calls: device ms per call by kernel, each kernel charged the time by which
it extends the span past the kernels before it (under programmatic
dependent launch a kernel's own time includes its wait).
Prints the card's name and power limit first; the whole record is also
written to `chiprun_out/ab_decode_tail.json`.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LM_SHAPES = ((768, 5), (768, 8), (768, 16), (1024, 8))   # (D, B), beam 3
BEAM_SHAPES = (8, 5, 16)                                   # B at K 3, T 20
V, BEAMS, T = 50265, 3, 20


def build(d: Path, nvcc: str, flags) -> subprocess.Popen:
    return subprocess.Popen(
        [nvcc, *flags, "-shared", "-o", str(d / "lib.so"),
         str(d / "lm_topk.cu"), str(d / "beam_update.cu")],
        stderr=subprocess.PIPE, text=True)


def loaded(d: Path, proc: subprocess.Popen) -> ctypes.CDLL:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {d}:\n{err[-3000:]}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.prismer_lm_topk.argtypes = [P] * 8 + [I] * 9 + [P]
    lib.prismer_lm_topk.restype = I
    lib.prismer_beam_update.argtypes = [P] * 13 + [I] * 4 + [F, I, I, P]
    lib.prismer_beam_update.restype = I
    return lib


def wrapper_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def old_call(lib, fn):
    """`fn` (an old wrapper) with `_build.kernels()` giving `lib`."""
    from prismer_tpu_torch.ops import _build

    def call(*args, **kw):
        keep = _build.kernels
        _build.kernels = lambda: lib
        try:
            return fn(*args, **kw)
        finally:
            _build.kernels = keep
    return call


def host_us(fn, calls: int = 200) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def timed(cs, calls):
    """old, new, new, old: graph ms, events ms and host us of each."""
    runs = {w: {"graph": [], "events": [], "host_us": []} for w in calls}
    for w in ("old", "new", "new", "old"):
        fn = calls[w]
        runs[w]["graph"].append(cs.graph_ms(fn, iters=50))
        runs[w]["events"].append(cs.cuda_ms(fn, iters=100))
        runs[w]["host_us"].append(host_us(fn))
    mean = {w: {k: sum(v) / len(v) for k, v in r.items()}
            for w, r in runs.items()}
    return runs, mean


def kernel_split(fn, calls: int = 10):
    """{kernel: device ms per call} from torch.profiler, each kernel charged
    the time by which it extends the span (see the module note)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    split, end = {}, -float("inf")
    for e in ops:
        m = re.search(r"(\w+_kernel)", e.name)
        name = m.group(1) if m else e.name[:40]
        extends = max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
        split[name] = split.get(name, 0.0) + extends / 1e3 / calls
    return split


def lm_case(gen, d, b):
    """chip_smoke's lm_topk inputs in bf16 (three tied embedding rows)."""
    import torch
    n = b * BEAMS
    emb = torch.randn(V, d, generator=gen, device="cuda") * 0.02
    bias = torch.randn(V, generator=gen, device="cuda") * 0.1
    h = torch.randn(n, d, generator=gen, device="cuda")
    alive = torch.randn(b, BEAMS, generator=gen, device="cuda")
    alive[1, 2] = -1.0e7
    emb[[1000, 2000, 40000]] = 0.2 * h[0] / h[0].norm()
    bias[[1000, 2000, 40000]] = 3.0
    return h.to(torch.bfloat16), emb.to(torch.bfloat16), bias, alive


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="+", type=Path)
    parser.add_argument("--split", action="store_true")
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    import chip_smoke as cs
    from prismer_tpu_torch.ops import _build
    from prismer_tpu_torch.ops import beam_update as bu
    from prismer_tpu_torch.ops import lm_topk as lt

    card = cs.card_info()
    print(card, flush=True)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    jobs = {d: build(d, nvcc, flags) for d in args.dirs}
    _build.build()
    _build.kernels()
    libs = {d: loaded(d, p) for d, p in jobs.items()}
    olds = {d: (wrapper_module(d / "lm_topk.py", f"old_lm_topk_{i}"),
                wrapper_module(d / "beam_update.py", f"old_beam_update_{i}"))
            for i, d in enumerate(args.dirs)}
    record = {"card": card, "lm_topk": [], "beam_update": []}

    gen = torch.Generator(device="cuda").manual_seed(13)
    kw = dict(beams=BEAMS, kk=2 * BEAMS, eos_token_id=2)
    for d_model, b in LM_SHAPES:
        h, emb, bias, alive = lm_case(gen, d_model, b)
        who = f"lm_topk N={b * BEAMS} D={d_model}"
        for mask_eos in (False, True):
            want = lt.lm_topk_reference(h, emb, bias, alive, mask_eos, **kw)
            got = lt.lm_topk(h, emb, bias, alive, mask_eos, **kw)
            ok = all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
            ok = ok and bool(((got[0] - want[0]).abs() <= cs.TOL_TOPK
                              + cs.TOL_TOPK * want[0].abs()).all())
            if not ok:
                print(f"  {who} mask_eos={mask_eos}: new differs from the "
                      f"plain version", flush=True)
                return 1
        for d, lib in libs.items():
            old = old_call(lib, olds[d][0].lm_topk)
            a = old(h, emb, bias, alive, False, **kw)
            c = lt.lm_topk(h, emb, bias, alive, False, **kw)
            agree = (all(torch.equal(x, y) for x, y in zip(a[1:], c[1:]))
                     and bool(((a[0] - c[0]).abs() <= 2 * cs.TOL_TOPK
                               * (1 + c[0].abs())).all()))
            runs, m = timed(cs, {
                "old": lambda: old(h, emb, bias, alive, False, **kw),
                "new": lambda: lt.lm_topk(h, emb, bias, alive, False, **kw)})
            tb = {w: emb.numel() * 2 / (m[w]["graph"] * 1e-3) / 1e12
                  for w in m}
            split = {}
            if args.split:
                split = {"old": kernel_split(
                    lambda: old(h, emb, bias, alive, False, **kw)),
                    "new": kernel_split(
                    lambda: lt.lm_topk(h, emb, bias, alive, False, **kw))}
                print(f"  {who} split vs {d}: {split}", flush=True)
            record["lm_topk"].append(dict(case=who, old=str(d), runs=runs,
                                          mean=m, tb_s=tb, agree=agree,
                                          split=split))
            print(f"  {who} vs {d}: graph old {m['old']['graph']:.4f} new "
                  f"{m['new']['graph']:.4f} ms "
                  f"({m['new']['graph'] / m['old']['graph']:.2f}x; "
                  f"embedding {tb['old']:.3f} / {tb['new']:.3f} TB/s), "
                  f"events old {m['old']['events']:.4f} new "
                  f"{m['new']['events']:.4f} ms, host old "
                  f"{m['old']['host_us']:.1f} new {m['new']['host_us']:.1f} "
                  f"us; outputs agree {agree}; runs {runs}", flush=True)
        del h, emb, bias, alive
        torch.cuda.empty_cache()

    rng = np.random.default_rng(17)
    bkw = dict(eos_token_id=2, pad_token_id=1)
    for b in BEAM_SHAPES:
        case = [torch.from_numpy(x).cuda()
                for x in cs._beam_case(rng, b, BEAMS, T, 3, 2, 1)]
        who = f"beam_update B={b} K={BEAMS} T={T}"
        for d, lib in libs.items():
            old = old_call(lib, olds[d][1].beam_update)
            a = old(*case, 10, 10.0, **bkw)
            c = bu.beam_update(*case, 10, 10.0, **bkw)
            agree = all(torch.equal(x, y) for x, y in zip(a, c))
            runs, m = timed(cs, {
                "old": lambda: old(*case, 10, 10.0, **bkw),
                "new": lambda: bu.beam_update(*case, 10, 10.0, **bkw)})
            record["beam_update"].append(dict(case=who, old=str(d),
                                              runs=runs, mean=m,
                                              agree=agree))
            print(f"  {who} vs {d}: graph old {m['old']['graph']:.4f} new "
                  f"{m['new']['graph']:.4f} ms, events old "
                  f"{m['old']['events']:.4f} new {m['new']['events']:.4f} "
                  f"ms, host old {m['old']['host_us']:.1f} new "
                  f"{m['new']['host_us']:.1f} us; bit-equal {agree}; runs "
                  f"{runs}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_decode_tail.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
