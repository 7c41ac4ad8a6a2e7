"""A/B of the encoder's fused LayerNorm kernels, `ln_proj` (kernel 14) and
`adaptor_fused` (kernel 15), on one GPU.

    python3 tools/ab_ln_proj.py [--probe] DIR [DIR ...]

Each DIR holds another `ln_proj.cu` with the headers it includes
(`layer_norm.cuh`, `common.cuh`, `hopper.cuh`) and the wrapper that called
it (`ln_proj.py`), e.g. an earlier commit's:

    mkdir -p build/ab/old && for f in csrc/ln_proj.cu csrc/layer_norm.cuh \\
        csrc/common.cuh csrc/hopper.cuh ops/ln_proj.py; do git show \\
        <commit>:prismer_tpu_torch/$f > build/ab/old/${f##*/}; done

The source is built as a second library beside the port's own; the old
wrapper is loaded from DIR and reaches that library in place of the port's
(`_build.kernels` is swapped around each old call), so its C entries keep
the signatures they had (`probe_ln_proj.entry_argtypes`). Old and new take
the same bf16 inputs (`chip_smoke.ln_proj_case`) at `chip_smoke.LN_SHAPES`
(BASE, LARGE, HUGE at batch 8) and at batch 1 (R 964, D 768): q/k/v,
c_fc + quick_gelu and the adaptor, timed in turns (old, new, new, old),
each warm as device ms per call from CUDA-graph replays (`graph`) and from
CUDA events around eager calls (`events`), and L2-cold (`cold`: a 256 MB
write before each call). At batch 1 the host's microseconds a call are
events less graph. Beside them, once per case: the flag-off composition's
graph ms (the yardstick), the bound, and for old and new the largest
difference to the plain version, whether it is within
`chip_smoke.TOL_LN_BF16_*` and whether two calls give the same bits.
`--probe` then runs `tools/probe_ln_proj.py` on each DIR and on a copy of
the port's own source. Prints the card's name and power limit first; the
whole record is also written to `chiprun_out/ab_ln_proj.json`.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from ab_ms_deform_attn import cold_ms  # noqa: E402
from probe_ln_proj import build, loaded, wrappers  # noqa: E402
import probe_ln_proj  # noqa: E402

SOURCES = ("csrc/ln_proj.cu", "csrc/layer_norm.cuh", "csrc/common.cuh",
           "csrc/hopper.cuh", "ops/ln_proj.py")


def held(cs, fn, call, x):
    """(max abs error, within tolerance, repeat bit-identical) of one of
    `ln_proj_calls`' kernels against its plain version."""
    import torch
    kernel, plain = call[0], call[1]
    got, again, want = cs._outs(kernel()), cs._outs(kernel()), cs._outs(
        plain())
    torch.cuda.synchronize()
    name = "adaptor_fused" if fn == "adaptor" else "ln_proj"
    errs = [cs._ln_errors(g, w, name, False, x.double().abs()
                          + w.double().abs() if fn == "adaptor" else None)
            for g, w in zip(got, want)]
    return {"max_abs_err": max(e for e, _ in errs),
            "ok": all(o for _, o in errs),
            "repeat": all(torch.equal(g, a) for g, a in zip(got, again))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="+", type=Path)
    parser.add_argument("--probe", action="store_true")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from prismer_tpu_torch.ops import _build
    from prismer_tpu_torch.ops import ln_proj as lp

    card = cs.card_info()
    print(card, flush=True)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    jobs = {d: build(d, nvcc, flags) for d in args.dirs}
    _build.build()
    _build.kernels()
    olds = {d: wrappers(d, loaded(d, p), f"old_ln_proj_{i}")
            for i, (d, p) in enumerate(jobs.items())}
    flush_buf = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    flush = flush_buf.zero_
    record = {"card": card, "cases": []}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 14)
    for label, r, d in cs.LN_SHAPES + (("batch 1", 964, cs.ENC_DIM),):
        case = cs.ln_proj_case(gen, r, d)
        x = case["x"].to(torch.bfloat16)
        new = cs.ln_proj_calls(case, torch.bfloat16, lp.ln_proj,
                               lp.adaptor_fused)
        for fn, call in new.items():
            bound = {}
            cs.set_bound(bound, call[4], call[3], torch.bfloat16)
            off = cs.graph_ms(call[2])
            for d_, fns in olds.items():
                old = cs.ln_proj_calls(case, torch.bfloat16, *fns)[fn]
                calls = {"old": old[0], "new": call[0]}
                errors = {w: held(cs, fn, c, x)
                          for w, c in (("old", old), ("new", call))}
                runs = {w: {"graph": [], "events": [], "cold": []}
                        for w in calls}
                for w in ("old", "new", "new", "old"):
                    runs[w]["graph"].append(cs.graph_ms(calls[w]))
                    runs[w]["events"].append(cs.cuda_ms(calls[w]))
                    runs[w]["cold"].append(cold_ms(calls[w], flush))
                mean = {w: {m: sum(v) / len(v) for m, v in ru.items()}
                        for w, ru in runs.items()}
                for w in mean:
                    mean[w]["host_us"] = 1e3 * (mean[w]["events"]
                                                - mean[w]["graph"])
                    mean[w]["tflops"] = call[3] / mean[w]["graph"] / 1e9
                record["cases"].append(dict(
                    shape=label, R=r, D=d, fn=fn, old=str(d_), runs=runs,
                    mean=mean, errors=errors, flag_off_graph=off, **bound))
                o, n = mean["old"], mean["new"]
                print(f"  {label} R={r} D={d} {fn} vs {d_}: graph old "
                      f"{o['graph']:.4f} new {n['graph']:.4f} ms "
                      f"({n['graph'] / o['graph']:.3f}x); events old "
                      f"{o['events']:.4f} new {n['events']:.4f}; cold old "
                      f"{o['cold']:.4f} new {n['cold']:.4f}; host us old "
                      f"{o['host_us']:.1f} new {n['host_us']:.1f}; TFLOP/s "
                      f"old {o['tflops']:.0f} new {n['tflops']:.0f}; flag-off"
                      f" {off:.4f}; bound {bound['bound_ms']:.4f} "
                      f"({bound['bound_by']}); errors {errors}", flush=True)
        del case, new
        torch.cuda.empty_cache()
    del flush_buf
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_ln_proj.json").write_text(json.dumps(record, indent=1))
    if args.probe:
        own = ROOT / "build" / "ab" / "port_source"
        own.mkdir(parents=True, exist_ok=True)
        for f in SOURCES:
            shutil.copy(ROOT / "prismer_tpu_torch" / f, own)
        for d in (*args.dirs, own):
            print(f"probe of {d}", flush=True)
            probe_ln_proj.main([str(d)])
            (out / "probe_ln_proj.json").rename(
                out / f"probe_ln_proj_{d.name}.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
