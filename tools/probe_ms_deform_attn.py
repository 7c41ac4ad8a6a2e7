"""Where the time of the deformable attention (kernel 10) goes on one GPU.

    python3 tools/probe_ms_deform_attn.py [--segment] DIR

DIR holds a form of the kernel's `ms_deform_attn.cu`, the headers it
includes and the wrapper that called it (`deform_attn.py`), e.g. the first
form (one warp per (sample, query, head), lanes over D) from the commit
before its redesign, or the current one:

    mkdir -p build/ab/warp && for f in csrc/ms_deform_attn.cu \\
        experts/ops/deform_attn.py; do git show <commit>:prismer_tpu_torch/$f \\
        > build/ab/warp/${f##*/}; done

The tool builds the source as it is and variants of it, each a library of
its own (the variants exist only here, never in the port). Of the first
form:

  * `one_row`: every gather reads row 0 of its (sample, head): the cost of
    issuing the loads, shuffles and FMAs with every row in L1;
  * `no_fine`: the last level's points (60 x 60 at the pixel decoder's
    shapes) skipped;
  * `no_coarse`: every level's points but the last skipped.

Of the staged form (coarse levels in shared memory, 8 lanes of float4
columns a query; its fixed-shape path, which the pixel decoder's shapes
take):

  * `one_row`: as above, in shared memory for the staged levels;
  * `no_fine`: the points of the levels not staged skipped;
  * `no_staged`: the points of the staged levels skipped;
  * `no_tma`: nothing staged and no wait for it (the staged rows read
    whatever shared memory holds): the cost of the staging;
  * `prep_only`: no row loaded or summed: the cost of the walk, the
    locations, the corner tables and the stores;
  * `zero_skip`: a corner of weight 0 (outside its level) not loaded (an
    active mask per group instead of every group's row);
  * `float2_loc`: a point's location read as one 8-byte load;
  * `warps24`, `warps32`: 24 or 32 warps a block (so at most 85 or 64
    registers a thread) instead of 16.

Each runs through its own copy of the wrapper (`_build.kernels` swapped
around the call) at N 16, 5 and 1 on both location families of
`chip_smoke.deform_case` ("uniform" over [-0.15, 1.15], "local" shaped as
Mask2Former's), timed warm by CUDA-graph replay (`graph`) and by CUDA
events around eager calls (`events`), and L2-cold (`cold`: the L2 flushed
by a 256 MB write before each call, `ab_ms_deform_attn.cold_ms`). The
source as it is is also held to the plain version. `--segment` then runs
`chip_smoke.phase_segment_parity` and `phase_segment(profile=True)` with
the port's own kernel: the in-model ms of kernel 10 in one batch-16 fp32
forward. `--sass` prints, for each library, the instructions of its
fixed-shape kernel and a count of its loads, stores, shuffles and FMAs
(`cuobjdump -sass`; straight-line counts, not executed ones). Prints the
card's name and power limit first; the whole record is written to
`chiprun_out/probe_ms_deform_attn.json`.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from ab_decode_tail import old_call, wrapper_module  # noqa: E402
from ab_ms_deform_attn import build, cold_ms, loaded  # noqa: E402

# (file, text in it, its replacement, occurrences) for each variant of each
# form of the kernel
VARIANTS = {
    # one warp per (n, q, h), lanes over D
    "warp": {
        "one_row": (("ms_deform_attn.cu",
                     "static_cast<long long>(idx) * row",
                     "static_cast<long long>(idx == 0x7fffffff ? idx : 0) "
                     "* row", 1),),
        "no_fine": (("ms_deform_attn.cu",
                     "const int count = min(32, lp - j0);",
                     "const int count = min(32, lp - j0) - P;", 1),),
        "no_coarse": (("ms_deform_attn.cu",
                       "for (int j = 0; j < count; ++j) {",
                       "for (int j = lp - P; j < count; ++j) {", 1),),
    },
    # staged coarse levels, a group of 8 lanes (float4 columns) a query,
    # each point's corners once into a per-warp table
    "staged": {
        "one_row": (("ms_deform_attn.cu",
                     "    const Corners e = mine[jj * kQuads];\n",
                     "    Corners e = mine[jj * kQuads];\n    for (int k = 0; "
                     "k < 4; ++k) e.idx[k] = e.idx[k] == 0x7fffffff ? "
                     "e.idx[k] : 0;\n", 1),
                    ("ms_deform_attn.cu", "val + e.idx[k] * hd32 + colc));",
                     "val + (e.idx[k] == 0x7fffffff ? e.idx[k] : 0) * hd32 + "
                     "colc));", 1)),
        "no_fine": (("ms_deform_attn.cu",
                     "            if (i >= from && i < from + 2) {",
                     "            if (false) {", 1),
                    ("ms_deform_attn.cu",
                     "far_acc.add(e.w[k], far[i % 2][k]);", ";", 1)),
        "no_staged": (("ms_deform_attn.cu",
                       "          gather(acc, j, j / NP, colc);\n", "", 1),),
        "no_tma": (("ms_deform_attn.cu",
                    "  if (prm.staged) hopper::mbar_wait(&bar, 0);\n", "", 1),
                   ("ms_deform_attn.cu",
                    "    hopper::mbar_arrive_expect_tx(&bar, prm.stage_bytes);"
                    "\n    for (int l = 0; l < L; ++l) {",
                    "    for (int l = 0; l < 0; ++l) {", 1)),
        "prep_only": (("ms_deform_attn.cu",
                       "            if (i >= from && i < from + 2) {",
                       "            if (false) {", 1),
                      ("ms_deform_attn.cu",
                       "far_acc.add(e.w[k], far[i % 2][k]);", ";", 1),
                      ("ms_deform_attn.cu",
                       "          gather(acc, j, j / NP, colc);\n", "", 1)),
        "zero_skip": (("ms_deform_attn.cu",
                       "        acc.fma(e.w[k], stage + e.idx[k] * D + colc);",
                       "        if (e.w[k] != 0.0f) acc.fma(e.w[k], stage + "
                       "e.idx[k] * D + colc);", 1),
                      ("ms_deform_attn.cu",
                       "                far[i % 2][k] = __ldg(reinterpret_cast<"
                       "const float4*>(",
                       "                far[i % 2][k] = e.w[k] == 0.0f ? "
                       "make_float4(0.f, 0.f, 0.f, 0.f) : __ldg("
                       "reinterpret_cast<const float4*>(", 1)),
        "float2_loc": (("ms_deform_attn.cu",
                        "      *x = __ldg(prm.loc + (task * lp + j) * 2);\n"
                        "      *y = __ldg(prm.loc + (task * lp + j) * 2 + 1);"
                        "\n",
                        "      const float2 xy = __ldg(reinterpret_cast<const "
                        "float2*>(prm.loc + (task * lp + j) * 2));\n"
                        "      *x = xy.x;\n      *y = xy.y;\n", 1),),
        "warps24": (("ms_deform_attn.cu", "constexpr int kWarps = 16;",
                     "constexpr int kWarps = 24;", 1),
                    ("deform_attn.py", "WARPS = 16", "WARPS = 24", 1)),
        "warps32": (("ms_deform_attn.cu", "constexpr int kWarps = 16;",
                     "constexpr int kWarps = 32;", 1),
                    ("deform_attn.py", "WARPS = 16", "WARPS = 32", 1)),
    },
}


def variant_dirs(src_dir: Path, out: Path):
    """{name: directory holding its copy of the files of `src_dir` (the
    source, the headers, the wrapper) with its edits}, "base" unedited."""
    files = {f.name: f.read_text() for f in src_dir.iterdir()
             if f.is_file() and f.suffix in (".cu", ".cuh", ".py")}
    form = "staged" if "mbar_wait" in files["ms_deform_attn.cu"] else "warp"
    dirs = {}
    for name, edits in (("base", ()), *VARIANTS[form].items()):
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


def sass_counts(lib: Path):
    """{kernel: (instructions, {opcode: count} of the loads, stores,
    shuffles and FMAs)} from `cuobjdump -sass` of the library, for its
    fixed-shape kernel (the one the pixel decoder's shapes take)."""
    import re
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if not re.search(r"ms_deform_attn_kernelILi4ELi3ELi4E", name):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                         block)
        hist = {}
        for op in ops:
            key = op.split(".")[0]
            if key in ("LDS", "LDG", "LD", "STS", "STG", "SHFL", "FFMA",
                       "LDGSTS", "BAR", "WARPSYNC", "IMAD", "LEA", "F2I"):
                hist[op] = hist.get(op, 0) + 1
        counts[name[-40:]] = (len(ops), hist)
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dir", type=Path)
    parser.add_argument("--segment", action="store_true")
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from prismer_tpu_torch.experts.ops.deform_attn import \
        ms_deform_attn_reference
    from prismer_tpu_torch.ops import _build

    card = cs.card_info()
    print(card, flush=True)
    dirs = variant_dirs(args.dir, ROOT / "build" / "probe_deform")
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    jobs = {name: build(d, nvcc, flags) for name, d in dirs.items()}
    libs = {name: loaded(d, jobs[name]) for name, d in dirs.items()}
    calls = {name: old_call(lib, wrapper_module(
        dirs[name] / "deform_attn.py", f"probe_deform_attn_{name}")
        .ms_deform_attn) for name, lib in libs.items()}
    if args.sass:
        for name, d in dirs.items():
            print(f"  {name} SASS: {sass_counts(d / 'lib.so')}", flush=True)
    flush_buf = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    flush = flush_buf.zero_
    record = {"card": card, "cases": []}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    for n in (cs.SEG_BATCH, 5, 1):
        for family in cs.DEFORM_FAMILIES:
            value, loc, w = cs.deform_case(gen, n, family)
            args_ = (value, cs.SEG_LEVELS, loc, w)
            want = ms_deform_attn_reference(*args_)
            got = calls["base"](*args_)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            case = {"n": n, "family": family, "max_abs_err": err}
            for name, fn in calls.items():
                def call(fn=fn):
                    fn(*args_)
                t = {"graph": cs.graph_ms(call, iters=20),
                     "cold": cold_ms(call, flush, iters=10)}
                if name == "base":
                    t["events"] = cs.cuda_ms(call, iters=20)
                case[name] = t
            print(f"  N={n} {family}: max|err| {err:.3g}; " + "; ".join(
                f"{name} " + " ".join(f"{k} {v:.4f}" for k, v in
                                       case[name].items())
                for name in calls) + " ms", flush=True)
            record["cases"].append(case)
            del value, loc, w, want, got
            torch.cuda.empty_cache()
    del flush_buf
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_ms_deform_attn.json").write_text(
        json.dumps(record, indent=1))
    if args.segment:
        results = {name: {"max_abs_err": 0.0, "launches": 0}
                   for name, _, _ in cs.KERNELS}
        _build.build()
        _build.kernels()
        cs.phase_segment_parity(results)
        cs.phase_segment(results, card, True, (False, False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
