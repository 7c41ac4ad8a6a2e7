"""Time the port's data-parallel train step and sharded generation over
several cards.

    python3 tools/multi_gpu_steps.py [--ranks N] [--model prismer_base]
                                     [--batch 4] [--device cuda|cpu]

Spawns N ranks (one a card, NCCL; gloo with --device cpu) with
`parallel.runtime.spawn`. Each rank builds the same bf16 model from the
seed with the six experts at 480 px (fp32 on the CPU), then:
  * the train step (freeze_vision, AdamW) in modes "dp", "zero2" and
    "zero3" on a ("data",) mesh, `--batch` rows a rank: ms/step (CUDA
    events, median of 5 after 2 warm-up steps), the loss, peak GiB;
  * "dp" with tensor parallelism on a (N / 2, 2) mesh when N is even;
  * `build_sharded_generate_fn` over 8 rows a rank (beam 3, 20 tokens):
    ms a global batch and images/s.
Rank 0 prints one line per measurement and the JSON of all of them, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STEPS, WARM = 5, 2


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device, n):
    """Median ms of n calls (CUDA events on the card, host clock else)."""
    import torch
    times, out = [], None
    for _ in range(n):
        _sync(device)
        t0 = time.perf_counter()
        if device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = fn()
        if device == "cuda":
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times, out


def rank_main(model_name: str, batch: int, device: str):
    import dataclasses

    import torch
    import chip_smoke as cs
    from prismer_tpu_torch.config import CAPTION_EXPERTS, build_prismer_config
    from prismer_tpu_torch.models.caption import build_sharded_generate_fn
    from prismer_tpu_torch.models.prismer import (build_random_prismer,
                                                  random_masters)
    from prismer_tpu_torch.parallel import runtime
    from prismer_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from prismer_tpu_torch.train import TrainState, build_train_step
    from prismer_tpu_torch.train.schedules import per_step_cosine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = runtime.world()
    res = 480 if model_name != "prismer_tiny" else 64
    cfg = build_prismer_config({
        "experts": CAPTION_EXPERTS, "image_resolution": res,
        "prismer_model": model_name, "freeze": "freeze_vision",
        "dtype": "bfloat16" if device == "cuda" else "float32"})
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, hidden_dropout_prob=0.1))
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 20)
    global_batch = cs.caption_batch(cfg, batch * n, gen, device)
    out = []
    cases = [("dp", 1), ("zero2", 1), ("zero3", 1)]
    if n % 2 == 0 and n > 1:
        cases.append(("dp", 2))
    for mode, n_model in cases:
        model = build_random_prismer(cfg, cs.SEED, device)
        state = TrainState.create(model, per_step_cosine(5e-5, 0.0, 10, 1),
                                  0.05, cfg.freeze,
                                  random_masters(model, cs.SEED), seed=0)
        mesh = make_mesh(n // n_model, n_model, device)
        step = build_train_step(model, mesh, mode)
        rows = shard_batch(global_batch, mesh)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _timed(lambda: step(state, rows), device, WARM)
        ms, times, (_, metrics) = _timed(lambda: step(state, rows), device,
                                         STEPS)
        label = mode if n_model == 1 else f"{mode}+tp{n_model}"
        out.append({"what": f"train {label}", "ms": ms, "times": times,
                    "loss": float(metrics["loss"]),
                    "global_batch": batch * n,
                    "images_s": batch * n * 1e3 / ms,
                    "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                 if device == "cuda" else None)})
        del state, model, step
        if device == "cuda":
            torch.cuda.empty_cache()

    model = build_random_prismer(
        dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, hidden_dropout_prob=0.0)), cs.SEED, device)
    mesh = make_mesh(n, 1, device)
    raw = cs.raw_batch(cfg, 8 * n, gen, device)
    prompt = torch.randint(4, min(1000, cfg.decoder.vocab_size), (8 * n, 4),
                           generator=gen, device=device, dtype=torch.int32)
    generate = build_sharded_generate_fn(model, mesh)
    call = lambda: generate(raw, prompt, torch.ones_like(prompt))
    _timed(call, device, 1)
    ms, times, ids = _timed(call, device, 3)
    out.append({"what": "sharded generate", "ms": ms, "times": times,
                "global_batch": 8 * n, "images_s": 8 * n * 1e3 / ms,
                "ids_shape": list(ids.shape)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--model", default="prismer_base")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch
    from prismer_tpu_torch.parallel import runtime
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            ap.error(f"{args.ranks} ranks need as many cards, "
                     f"{torch.cuda.device_count()} found")
        from prismer_tpu_torch.ops import _build
        _build.build()
    card = _card()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks = runtime.spawn(rank_main, args.ranks, args.device, d,
                              args=(args.model, args.batch, args.device),
                              timeout=1800)
    for rec in ranks[0]:
        print(f"{rec['what']}: {rec['ms']:.1f} ms (median; "
              f"{' '.join(f'{t:.1f}' for t in rec['times'])}), global batch "
              f"{rec['global_batch']}, {rec['images_s']:.1f} images/s"
              + (f", loss {rec['loss']:.4f}" if "loss" in rec else "")
              + (f", peak {rec['peak_gib']:.1f} GiB"
                 if rec.get("peak_gib") is not None else "")
              + f" ({args.ranks} ranks, {card})", flush=True)
    print(json.dumps({"card": card, "ranks": args.ranks,
                      "model": args.model, "batch_per_rank": args.batch,
                      "seconds": time.perf_counter() - t0,
                      "results": ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
