"""Two probes of the port's fused CE kernels (kernels 8 and 9) on one GPU.

    python3 tools/probe_fused_ce.py [--waves] [--fresh REPS]

`--waves`: `ce_stats` and `ce_grads` in bf16 by CUDA-graph replay
(`chip_smoke.graph_ms`, best of three) at N 1 and 116, D 768, with
V = 132, 264, 393 and 528 vocab tiles of 128 rows, and the time a tile.
The logits kernels run one tile a block, two blocks an SM: 264 tiles fill
one wave of the 132 SMs, 393 (V 50265) fill 1.49, so the time a tile shows
what the partly filled last wave costs.

`--fresh REPS`: REPS rounds of `chip_smoke._check_fused_ce` at N 37, 1 and
116 (its graph timings allocate and free scratch many times), each round
followed by three calls at that N on freshly allocated inputs; every
output of those calls must be finite. Counts the bad calls. A tensor-map
cache that handed out pointers to its own entries once read another
tensor here within two calls.

Prints the card's name and power limit first; exits 1 if a call was bad.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

D, V = 768, 50265


def waves(cs, fc, gen) -> None:
    import torch
    for n in (1, 116):
        for tiles in (132, 264, 393, 528):
            v = tiles * 128
            emb = (torch.randn(v, D, generator=gen, device="cuda")
                   * 0.02).to(torch.bfloat16)
            bias = torch.randn(v, generator=gen, device="cuda") * 0.1
            h = torch.randn(n, D, generator=gen, device="cuda").to(
                torch.bfloat16)
            lab = torch.randint(0, v, (n,), generator=gen, device="cuda",
                                dtype=torch.int32)
            gv = torch.full((n,), 0.25, device="cuda")
            lse = fc.ce_stats(h, emb, bias, lab)[2]
            st = min(cs.graph_ms(lambda: fc.ce_stats(h, emb, bias, lab))
                     for _ in range(3))
            gr = min(cs.graph_ms(lambda: fc.ce_grads(h, emb, bias, lab, gv,
                                                     lse, 0.1))
                     for _ in range(3))
            cs.log(f"  N={n} tiles={tiles} V={v}: stats {st:.4f} ms "
                   f"({st / tiles * 1e3:.3f} us a tile), grads {gr:.4f} ms "
                   f"({gr / tiles * 1e3:.3f} us a tile)")
            del emb, bias
            torch.cuda.empty_cache()


def fresh(cs, fc, gen, reps: int) -> int:
    import torch
    results = {n: {"max_abs_err": 0.0} for n, _, _ in cs.KERNELS}
    st_e, gr_e = results["ce_stats"], results["ce_grads"]
    st_e["shapes"], gr_e["shapes"] = [], []
    emb32 = torch.randn(V, D, generator=gen, device="cuda") * 0.02
    bias = torch.randn(V, generator=gen, device="cuda") * 0.1
    bad = calls = 0
    for rep in range(reps):
        for n in (37, 1, 116):
            cs._check_fused_ce(gen, st_e, gr_e, emb32, bias, n)
            for it in range(3):
                h = torch.randn(n, D, generator=gen, device="cuda").to(
                    torch.bfloat16)
                emb = emb32.to(torch.bfloat16)
                lab = torch.randint(0, V, (n,), generator=gen, device="cuda",
                                    dtype=torch.int32)
                gv = torch.full((n,), 0.25, device="cuda")
                st = fc.ce_stats(h, emb, bias, lab)
                gr = fc.ce_grads(h, emb, bias, lab, gv, st[2], 0.1)
                torch.cuda.synchronize()
                calls += 1
                if not all(bool(torch.isfinite(t.float()).all())
                           for t in (*st, *gr)):
                    bad += 1
                    cs.log(f"  round {rep} N={n} call {it}: non-finite")
    cs.log(f"  fresh inputs after each check: {bad} bad of {calls} calls "
           f"in {reps} rounds")
    return bad


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--waves", action="store_true")
    parser.add_argument("--fresh", type=int, default=0, metavar="REPS")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from prismer_tpu_torch.ops import _build
    from prismer_tpu_torch.ops import fused_ce as fc

    cs.log(cs.card_info())
    _build.build()
    _build.kernels()
    gen = torch.Generator(device="cuda").manual_seed(3)
    if args.waves:
        waves(cs, fc, gen)
    bad = fresh(cs, fc, gen, args.fresh) if args.fresh else 0
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
