"""A/B of phase "serve" (Prismer-BASE bf16 captioning through
`build_generate_fn`, fused decode on) between two checkouts, on one GPU.

    python3 tools/ab_serve.py [--pairs N] DIR

DIR is another checkout of the repo, e.g. the parent commit's:

    mkdir -p build/ab/parent && git archive <commit> | tar -x -C build/ab/parent

Both checkouts' kernels are built first, at once (each into its own
git-ignored build/kernels/); then each checkout's `chip_smoke.phase_serve`
runs in a process of its own, rooted at that checkout, N pairs of runs
(default 2) alternating which side runs first (old, new, new, old, ...):
the same seeded BASE model and requests (batch 8, 8, 8, 5 after two
warm-ups), ms/request by CUDA events. Then, in this checkout, the host's
microseconds for one enter and exit of `ops/_build.launch_device` over 12
tensors on the card (the device guard every launch goes through; mean of
20,000). Prints the card's name and power limit first, then each run's
batch-8 ms/request (mean and the three requests) and batch-5 ms, and the
medians of each side; the record is also written to
`chiprun_out/ab_serve.json`.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_BUILD = ("import sys; sys.path.insert(0, '.'); "
          "from prismer_tpu_torch.ops import _build; _build.build()")
_SERVE = ("import sys, torch; sys.path.insert(0, '.'); "
          "import chip_smoke as cs; "
          "torch.backends.cuda.matmul.allow_tf32 = False; "
          "torch.backends.cudnn.allow_tf32 = False; "
          "r = {n: {'launches': 0} for n, _, _ in cs.KERNELS}; "
          "cs.phase_serve(r, cs.card_info(), False)")
_GUARD = """
import sys, time, torch
sys.path.insert(0, '.')
from prismer_tpu_torch.ops import _build
ts = [torch.zeros(8, device='cuda') for _ in range(12)]
n = 20000
t0 = time.perf_counter()
for _ in range(n):
    with _build.launch_device('x', *ts):
        pass
print((time.perf_counter() - t0) / n * 1e6)
"""
_MS8 = re.compile(r"fused decode, batch 8: ([\d.]+) ms/request \(([\d. ]+)\)"
                  r".*batch 5: ([\d.]+) ms/request")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("other", help="the other checkout's root")
    args = ap.parse_args(argv)
    trees = {"old": Path(args.other).resolve(), "new": ROOT}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    builds = {k: subprocess.Popen([sys.executable, "-c", _BUILD], cwd=d)
              for k, d in trees.items()}
    for k, proc in builds.items():
        if proc.wait() != 0:
            print(f"{k}: the build failed", flush=True)
            return 1
    runs = []
    order = [k for i in range(args.pairs)
             for k in (("old", "new") if i % 2 == 0 else ("new", "old"))]
    for k in order:
        res = subprocess.run([sys.executable, "-c", _SERVE], cwd=trees[k],
                             capture_output=True, text=True)
        m = _MS8.search(res.stdout)
        if res.returncode != 0 or m is None:
            print(f"{k}: phase serve failed\n{res.stdout[-4000:]}\n"
                  f"{res.stderr[-4000:]}", flush=True)
            return 1
        rec = {"tree": k, "ms8": float(m.group(1)),
               "ms8_each": [float(x) for x in m.group(2).split()],
               "ms5": float(m.group(3))}
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    medians = {k: statistics.median(r["ms8"] for r in runs
                                    if r["tree"] == k) for k in trees}
    guard = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT,
                           capture_output=True, text=True, check=True)
    guard_us = float(guard.stdout.strip().splitlines()[-1])
    print(f"batch-8 ms/request, median of {args.pairs} runs a side: old "
          f"{medians['old']}, new {medians['new']}; launch_device over 12 "
          f"tensors {guard_us:.2f} us a launch ({card})", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_serve.json").write_text(json.dumps(
        {"card": card, "other": str(trees["old"]), "runs": runs,
         "median_ms8": medians, "launch_device_us": guard_us}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
