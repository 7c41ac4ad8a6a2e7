"""A/B of the multi-scale deformable attention, `ms_deform_attn` (kernel
10), on one GPU.

    python3 tools/ab_ms_deform_attn.py DIR [DIR ...]

Each DIR holds another `ms_deform_attn.cu` with the headers it includes
and the wrapper that called it (`deform_attn.py`), e.g. an earlier
commit's:

    mkdir -p build/ab/old && for f in csrc/ms_deform_attn.cu \\
        csrc/hopper.cuh experts/ops/deform_attn.py; do git show \\
        <commit>:prismer_tpu_torch/$f > build/ab/old/${f##*/}; done

(`hopper.cuh` only where that source includes it.) The source is built as
a second library beside the port's own; the old wrapper is loaded from DIR
and reaches that library in place of the port's (`_build.kernels` is
swapped around each old call), so its C entry keeps the signature it had.
Old and new take the same inputs, `chip_smoke.deform_case` at the pixel
decoder's shapes (levels 15 x 15, 30 x 30, 60 x 60; H 8, D 32, P 4; Lq =
S = 4,725) at N 16, 5 and 1 (the generator's batch, its last batch of 37
images, one image), on both location families ("uniform" over
[-0.15, 1.15]; "local", shaped as Mask2Former's), and are timed in turns
(old, new, new, old), each warm as device ms per call from CUDA-graph
replays (`graph`) and from CUDA events around eager calls (`events`), and
L2-cold (`cold`: a 256 MB write before each call, `cold_ms`).
Beside them, once per case: the plain version's events ms, the byte
bound, and for old and new the largest difference to the plain version
and whether two calls give the same bits. Prints the card's name and power
limit first; the whole record is also written to
`chiprun_out/ab_ms_deform_attn.json`.
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

from ab_decode_tail import old_call, wrapper_module  # noqa: E402

BATCHES = (16, 5, 1)


def cold_ms(fn, flush, iters: int = 10) -> float:
    """Mean device ms per call with the L2 flushed before each: a CUDA graph
    of `iters` (flush, call) pairs, less one of `iters` flushes alone."""
    import chip_smoke as cs

    def pairs():
        flush()
        fn()
    return cs.graph_ms(pairs, iters) - cs.graph_ms(flush, iters)


def build(d: Path, nvcc: str, flags) -> subprocess.Popen:
    return subprocess.Popen(
        [nvcc, *flags, "-I", str(d), "-shared", "-o", str(d / "lib.so"),
         str(d / "ms_deform_attn.cu")], stderr=subprocess.PIPE, text=True)


def loaded(d: Path, proc: subprocess.Popen) -> ctypes.CDLL:
    """The library built from DIR, its C entry declared as DIR's wrapper
    calls it (`entry_argtypes`)."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {d}:\n{err[-3000:]}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    lib.prismer_ms_deform_attn.argtypes = entry_argtypes(d)
    lib.prismer_ms_deform_attn.restype = ctypes.c_int
    return lib


def entry_argtypes(d: Path):
    """ctypes argtypes of DIR's C entry: (value, loc, attn, out, shapes, N,
    S, Lq, H, D, L, P, stream) for the first form of the kernel; a wrapper
    with a launch plan (`deform_plan`) also passes the plan's chunks,
    staged levels and shared-memory bytes before the stream."""
    P, I = ctypes.c_void_p, ctypes.c_int
    if "deform_plan" in (d / "deform_attn.py").read_text():
        return [P] * 5 + [I] * 10 + [P]
    return [P] * 5 + [I] * 7 + [P]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="+", type=Path)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from prismer_tpu_torch.experts.ops import deform_attn as da
    from prismer_tpu_torch.ops import _build

    card = cs.card_info()
    print(card, flush=True)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    jobs = {d: build(d, nvcc, flags) for d in args.dirs}
    _build.build()
    _build.kernels()
    libs = {d: loaded(d, p) for d, p in jobs.items()}
    olds = {d: wrapper_module(d / "deform_attn.py", f"old_deform_attn_{i}")
            for i, d in enumerate(args.dirs)}
    flush_buf = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    flush = flush_buf.zero_
    record = {"card": card, "cases": []}

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    for n in BATCHES:
        for family in cs.DEFORM_FAMILIES:
            value, loc, w = cs.deform_case(gen, n, family)
            args_ = (value, cs.SEG_LEVELS, loc, w)
            who = f"N={n} {family}"
            want = da.ms_deform_attn_reference(*args_)
            plain = cs.cuda_ms(lambda: da.ms_deform_attn_reference(*args_),
                               iters=3, warmup=1)
            bound = {}
            cs.set_bound(bound, cs.nbytes(value, loc, w, want),
                         2.0 * w.numel() * 4 * value.shape[-1],
                         torch.float32)
            for d, lib in libs.items():
                calls, errs = {}, {}
                for which, fn in (("old", old_call(lib,
                                                   olds[d].ms_deform_attn)),
                                  ("new", da.ms_deform_attn)):
                    got, again = fn(*args_), fn(*args_)
                    torch.cuda.synchronize()
                    errs[which] = {
                        "max_abs_err": (got - want).abs().max().item(),
                        "repeat": bool(torch.equal(got, again)),
                        "finite": bool(torch.isfinite(got).all())}
                    calls[which] = lambda fn=fn: fn(*args_)
                    del got, again
                runs = {k: {"graph": [], "events": [], "cold": []}
                        for k in calls}
                for which in ("old", "new", "new", "old"):
                    fn = calls[which]
                    runs[which]["graph"].append(cs.graph_ms(fn, iters=20))
                    runs[which]["events"].append(cs.cuda_ms(fn, iters=20))
                    runs[which]["cold"].append(cold_ms(fn, flush, iters=10))
                mean = {k: {m: sum(v) / len(v) for m, v in r.items()}
                        for k, r in runs.items()}
                record["cases"].append(dict(
                    case=who, old=str(d), runs=runs, mean=mean, errors=errs,
                    plain_ms=plain, **bound))
                o, nw = mean["old"], mean["new"]
                print(f"  {who} vs {d}: graph old {o['graph']:.4f} new "
                      f"{nw['graph']:.4f} ms ({nw['graph'] / o['graph']:.3f}"
                      f"x); events old {o['events']:.4f} new "
                      f"{nw['events']:.4f}; cold old {o['cold']:.4f} new "
                      f"{nw['cold']:.4f}; plain {plain:.4f}; bound "
                      f"{bound['bound_ms']:.4f} ({bound['bound_by']}); "
                      f"errors {errs}", flush=True)
            del value, loc, w, want
            torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_ms_deform_attn.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
