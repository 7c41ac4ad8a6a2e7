"""Where the time of the encoder's fused LayerNorm kernels (14 `ln_proj`, 15
`adaptor_fused`) goes on one GPU.

    python3 tools/probe_ln_proj.py DIR

DIR holds a form of `ln_proj.cu`, the headers it includes (`layer_norm.cuh`,
`common.cuh`, and `hopper.cuh` where it includes it) and the wrapper that
called it (`ln_proj.py`), e.g. the mma.sync form from the commit before the
redesign, or the current one:

    mkdir -p build/ab/old && for f in csrc/ln_proj.cu csrc/layer_norm.cuh \\
        csrc/common.cuh csrc/hopper.cuh ops/ln_proj.py; do git show \\
        <commit>:prismer_tpu_torch/$f > build/ab/old/${f##*/}; done

The tool builds the source as it is and variants of it, each a library of
its own (the variants exist only here, never in the port). Of the mma.sync
form (a block normalises its rows into shared memory, then its eight warps
run mma.sync over cp.async weight stages):

  * `ln_only`: the LayerNorm prologue alone (no product, no store);
  * `no_ln`: the products and stores on whatever the row tile holds (the
    prologue skipped): the mainloop and epilogue alone;
  * `no_store`: no output written (a store only for a value no input
    gives): the prologue and mainloop alone.

Of the wgmma form (a row-statistics launch, then TMA-fed wgmma mainloops
that apply the LayerNorm to their A operand: ln_proj in place in the
stage's x box, the adaptor's first product in its A fragments):

  * `stats_only`: the statistics launch, and main launches that return at
    once;
  * `no_ln`: the fragments go to wgmma as loaded, not normalised: the
    LayerNorm's arithmetic;
  * `no_ln_pass`: no pass over x (ln_proj's products read the x box as
    loaded, the adaptor's whatever its fragment registers hold);
  * `no_mma`: no product issued in either kernel;
  * `no_load`: no TMA load (stages are marked full at once, the products
    run on whatever shared memory holds): the compute alone;
  * `no_store`: the epilogue computes and stages its values but stores
    none;
  * `no_epilogue`: the epilogue computes and stages nothing (its barriers
    and stores stay);
  * `skeleton`: no load, product, fragment or epilogue arithmetic: the
    ring's handshakes, barriers and per-tile work alone;
  * `regs56`: ln_proj's producer warpgroup at 56 registers a thread and
    its consumers at 224 (24 and 240 as it is);
  * `stages2`: ln_proj with two ring stages instead of three;
  * `bn128`: ln_proj with 128-column tiles and four stages.

Each build prints its bf16 kernels' registers and spills (ptxas -v). Each
runs through its own copy of the wrapper (`_build.kernels` swapped
around the call) at `chip_smoke.LN_SHAPES` (BASE, LARGE, HUGE at batch 8),
bf16, for q/k/v, c_fc + quick_gelu and the adaptor, timed as device ms per
call from CUDA-graph replays (`graph`), and for the source as it is also
from CUDA events around eager calls (`events`), with its TFLOP/s and its
largest difference to the plain version. Beside them, once a case: the
flag-off composition's graph and events ms (`chip_smoke.ln_proj_calls`)
and the bound. Prints the card's name and power limit first; the whole
record is written to `chiprun_out/probe_ln_proj.json`.
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

# (file, text in it, its replacement, occurrences) for each variant of each
# form of the kernels
VARIANTS = {
    "mma": {
        "ln_only": (("ln_proj.cu",
                     "col0 = group * kGroup * kBn; col0 < col_end;",
                     "col0 = group * kGroup * kBn; col0 < 0;", 1),
                    ("ln_proj.cu", "for (int col0 = 0; col0 < D; col0",
                     "for (int col0 = 0; col0 < 0; col0", 2)),
        "no_ln": (("ln_proj.cu",
                   "  ln_tile<T>(x, scale, bias, R, D, eps, row0, BM, xs, "
                   "ldx);\n", "", 1),
                  ("ln_proj.cu",
                   "  ln_tile<T>(x, scale, bias, R, D, eps, row0, BM, ys, "
                   "ldx);\n", "", 1)),
        "no_store": (("ln_proj.cu",
                      "        o[static_cast<size_t>(row) * F + col] = ",
                      "        if (y == 1.2345e-30f) o[static_cast<size_t>"
                      "(row) * F + col] = ", 1),
                     ("ln_proj.cu", "        out[i] = from_f<T>(to_f(x[i]) "
                      "+ u);",
                      "        if (u == 1.2345e-30f) out[i] = from_f<T>("
                      "to_f(x[i]) + u);", 1)),
    },
    "wgmma": {
        "stats_only": (("ln_proj.cu",
                        "  extern __shared__ __align__(16) unsigned char "
                        "smem_raw[];\n",
                        "  if (a.R > 0) return;\n  extern __shared__ "
                        "__align__(16) unsigned char smem_raw[];\n", 2),),
        "no_ln": (("ln_proj.cu",
                   "  const float lo = (__uint_as_float(v << 16) - st.x) * "
                   "st.y * s0 + b0;\n  const float hi = (__uint_as_float(v & "
                   "0xffff0000u) - st.x) * st.y * s1 + b1;\n  return "
                   "hopper::pack_bf16(lo, hi);", "  return v;", 1),),
        "no_ln_pass": (("ln_proj.cu", "      ln_in_place(st + w * kBox, c, "
                        "wi, lane, sa, sb, af);\n", "", 1),
                       ("ln_proj.cu", "    ln_fragments(st, c, wi, lane, sa, "
                        "sb, af, cur);\n", "", 1)),
        "no_mma": (("ln_proj.cu", "hopper::wgmma_sst<kProjBn, 0, 0>(",
                    "if (a.R < 0) hopper::wgmma_sst<kProjBn, 0, 0>(", 1),
                   ("ln_proj.cu", "hopper::wgmma_rsk_n128(",
                    "if (a.R < 0) hopper::wgmma_rsk_n128(", 1),
                   ("ln_proj.cu", "hopper::wgmma_sst<kAdBn, 0, 0>(",
                    "if (a.R < 0) hopper::wgmma_sst<kAdBn, 0, 0>(", 1)),
        "no_load": (("ln_proj.cu",
                     "        hopper::mbar_arrive_expect_tx(full + s, "
                     "kProjStage);",
                     "        hopper::mbar_arrive(full + s);", 1),
                    ("ln_proj.cu", "          hopper::mbar_arrive_expect_tx("
                     "full + s, p == 0 ? kAdStage\n", "          hopper::"
                     "mbar_arrive(full + s);\n          (void)(p == 0 ? "
                     "kAdStage\n", 1),
                    ("ln_proj.cu", "hopper::mbar_arrive_expect_tx(res, "
                     "boxes * kBox);", "hopper::mbar_arrive(res);", 1),
                    ("ln_proj.cu", "hopper::tma_load_4d(",
                     "if (a.R < 0) hopper::tma_load_4d(", 5)),
        "no_store": (("ln_proj.cu", "hopper::tma_store_4d(",
                      "if (a.R < 0) hopper::tma_store_4d(", 2),),
        "no_epilogue": (("ln_proj.cu", "    for (int j = 0; j < kProjBn / 8; "
                         "++j) {\n      const int cl",
                         "    for (int j = 0; j < (a.R < 0 ? kProjBn / 8 : 0);"
                         " ++j) {\n      const int cl", 1),
                        ("ln_proj.cu", "    for (int j = 0; j < kAdBn / 8; "
                         "++j) {\n", "    for (int j = 0; j < (a.R < 0 ? "
                         "kAdBn / 8 : 0); ++j) {\n", 2)),
        "skeleton": "no_load+no_mma+no_ln_pass+no_epilogue",
        "regs56": (("ln_proj.cu", "setmaxnreg_dec<24>", "setmaxnreg_dec<56>",
                    1),
                   ("ln_proj.cu", "setmaxnreg_inc<240>", "setmaxnreg_inc<224>",
                    1)),
        "stages2": (("ln_proj.cu", "constexpr int kProjStages = 3;",
                     "constexpr int kProjStages = 2;", 1),
                    ("ln_proj.py", "rows, bn, stages = 128, 256, 3",
                     "rows, bn, stages = 128, 256, 2", 1)),
        "bn128": (("ln_proj.cu", "constexpr int kProjBn = 256;",
                   "constexpr int kProjBn = 128;", 1),
                  ("ln_proj.cu", "constexpr int kProjStages = 3;",
                   "constexpr int kProjStages = 4;", 1),
                  ("ln_proj.py", "rows, bn, stages = 128, 256, 3",
                   "rows, bn, stages = 128, 128, 4", 1)),
    },
}


def entry_argtypes(d: Path):
    """ctypes argtypes of DIR's two C entries: the mma.sync form's, or with
    a launch plan (`ln_proj_plan` in the wrapper) the statistics scratch,
    the plan's block count and shared-memory bytes before the stream."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if "ln_proj_plan" in (d / "ln_proj.py").read_text():
        return ([P] * 12 + [I] * 6 + [F, I, I] + [P, I, I, P],
                [P] * 8 + [I] * 2 + [F, I] + [P, I, I, P])
    return [P] * 12 + [I] * 6 + [F, I, I, P], [P] * 8 + [I] * 2 + [F, I, P]


def build(d: Path, nvcc: str, flags) -> subprocess.Popen:
    return subprocess.Popen(
        [nvcc, *flags, "-Xptxas", "-v", "-I", str(d), "-shared", "-o",
         str(d / "lib.so"), str(d / "ln_proj.cu")], stderr=subprocess.PIPE,
        text=True)


def spills(err: str) -> dict:
    """{kernel: (registers, bytes spilled)} of the bf16 kernels in a ptxas
    -v listing."""
    import re
    out, name = {}, None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]*_kernel)E",
                      line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = [None, int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()
            if k in ("ln_proj_kernel", "adaptor_kernel")}


def loaded(d: Path, proc: subprocess.Popen) -> ctypes.CDLL:
    """The library built from DIR, its C entries declared as DIR's wrapper
    calls them; prints the bf16 kernels' registers and spills."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {d}:\n{err[-3000:]}")
    print(f"  {d.name}: ptxas (registers, bytes spilled) {spills(err)}",
          flush=True)
    lib = ctypes.CDLL(str(d / "lib.so"))
    proj, adaptor = entry_argtypes(d)
    lib.prismer_ln_proj.argtypes = proj
    lib.prismer_ln_proj.restype = ctypes.c_int
    lib.prismer_adaptor_fused.argtypes = adaptor
    lib.prismer_adaptor_fused.restype = ctypes.c_int
    return lib


def wrappers(d: Path, lib, name: str):
    """(ln_proj, adaptor_fused) of DIR's wrapper, reaching `lib`."""
    mod = wrapper_module(d / "ln_proj.py", name)
    return old_call(lib, mod.ln_proj), old_call(lib, mod.adaptor_fused)


def variant_dirs(src_dir: Path, out: Path):
    """{name: directory holding its copy of the files of `src_dir` with its
    edits}, "base" unedited."""
    files = {f.name: f.read_text() for f in src_dir.iterdir()
             if f.is_file() and f.suffix in (".cu", ".cuh", ".py")}
    form = "wgmma" if "wgmma" in files["ln_proj.cu"] else "mma"
    variants = VARIANTS[form]

    def edits_of(v):   # a variant's edits, a combination's resolved
        edits = variants[v]
        if isinstance(edits, str):
            return sum((edits_of(w) for w in edits.split("+")), ())
        return edits

    dirs = {}
    for name in ("base", *variants):
        edits = () if name == "base" else edits_of(name)
        texts = dict(files)
        for fname, old, new, count in edits:
            if texts[fname].count(old) != count:
                raise RuntimeError(f"{name}: {old!r} occurs "
                                   f"{texts[fname].count(old)} times in "
                                   f"{fname}, not {count}")
            texts[fname] = texts[fname].replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        dirs[name] = d
    return dirs


def first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dir", type=Path)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from prismer_tpu_torch.ops import _build

    card = cs.card_info()
    print(card, flush=True)
    dirs = variant_dirs(args.dir, ROOT / "build" / "probe_ln_proj")
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    jobs = {name: build(d, nvcc, flags) for name, d in dirs.items()}
    fns = {name: wrappers(d, loaded(d, jobs[name]), f"probe_ln_proj_{name}")
           for name, d in dirs.items()}
    record = {"card": card, "cases": []}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 14)
    for label, r, d in cs.LN_SHAPES:
        case = cs.ln_proj_case(gen, r, d)
        calls = {name: cs.ln_proj_calls(case, torch.bfloat16, *f)
                 for name, f in fns.items()}
        for fn in calls["base"]:
            kernel, plain, off, flops, n_bytes = calls["base"][fn]
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
            del got, want
            bound = {}
            cs.set_bound(bound, n_bytes, flops, torch.bfloat16)
            row = {"shape": label, "R": r, "D": d, "fn": fn,
                   "max_abs_err": err, **bound,
                   "off_graph": cs.graph_ms(off), "off_events":
                   cs.cuda_ms(off)}
            for name in calls:
                def call(k=calls[name][fn][0]):
                    first(k())
                row[name] = {"graph": cs.graph_ms(call)}
                if name == "base":
                    row[name]["events"] = cs.cuda_ms(call)
                    row[name]["tflops"] = flops / row[name]["graph"] / 1e9
            print(f"  {label} R={r} D={d} {fn}: max|err| {err:.3g}; bound "
                  f"{bound['bound_ms']:.4f} ({bound['bound_by']}); flag-off "
                  f"{row['off_graph']:.4f} graph {row['off_events']:.4f} "
                  f"events; " + "; ".join(
                      f"{name} " + " ".join(f"{k} {v:.4f}" for k, v in
                                             row[name].items())
                      for name in calls) + " ms", flush=True)
            record["cases"].append(row)
        del case, calls
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_ln_proj.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
