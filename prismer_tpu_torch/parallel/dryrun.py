"""Driver entry points, ported from __graft_entry__.py.

entry()              the caption training loss at Prismer-BASE (six experts,
                     480 px, bf16) on one device, as (fn, args).
dryrun_multichip(n)  JAX's multi-device checks on the tiny configuration
                     with n ranks: ZeRO-3 (+ tensor parallelism on a
                     ('data', 'model') = (n / 2, 2) mesh when n is even and
                     at least 4) cuts the per-rank parameters below 0.45 of
                     the whole, and ZeRO-2 the optimizer state; one step of
                     each gives a finite loss; sharded generation gives
                     (n, 12) ids, and with fused decode forced on (kernels
                     1-5 on CUDA, their plain versions on the CPU, as JAX
                     runs its kernels in interpret mode) and with int8
                     cross K/V, exactly one process's ids.

  python -m prismer_tpu_torch.parallel.dryrun N [--device cpu|cuda]

On CUDA each rank takes a card (NCCL); on the CPU the ranks talk over gloo.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from prismer_tpu_torch.config import (PrismerConfig, TextDecoderConfig,
                                      VisionEncoderConfig,
                                      build_prismer_config)
from prismer_tpu_torch.data.device import materialize_experts
from prismer_tpu_torch.models.prismer import (build_random_prismer,
                                              compute_dtype, random_masters)
from prismer_tpu_torch.parallel import runtime

SEED = 0


def _expert_batch(rng, vis_cfg, batch: int) -> Dict[str, Any]:
    """Random reference-schema expert inputs (NHWC), as JAX's."""
    res = vis_cfg.label_resolution
    out = {}
    for exp, ch in vis_cfg.experts:
        if exp == "rgb":
            r = vis_cfg.image_resolution
            out[exp] = rng.standard_normal((batch, r, r, ch)).astype(
                np.float32)
        elif exp == "obj_detection":
            out[exp] = {
                "label": rng.standard_normal((batch, res, res, ch)).astype(
                    np.float32),
                "instance": rng.integers(0, 8, (batch, res, res, 1)).astype(
                    np.int32)}
        else:
            out[exp] = rng.standard_normal((batch, res, res, ch)).astype(
                np.float32)
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return torch.from_numpy(tree).to(device)


def entry(device="cuda"):
    """(fn, args): fn(*args) is the mean label-smoothed caption loss of
    Prismer-BASE (weights from seed 0) on a batch of 2, in eval mode."""
    cfg = build_prismer_config({
        "experts": ["depth", "normal", "seg_coco", "edge", "obj_detection",
                    "ocr_detection"],
        "image_resolution": 480, "prismer_model": "prismer_base",
        "freeze": "freeze_vision", "dtype": "bfloat16"})
    model = build_random_prismer(cfg, SEED, device)
    rng = np.random.default_rng(0)
    batch = 2
    experts = _to(_expert_batch(rng, cfg.vision, batch), device)
    ids = rng.integers(4, cfg.decoder.vocab_size, (batch, 30)).astype(
        np.int64)
    targets = ids.copy()
    targets[:, :4] = -100
    dtype = compute_dtype(cfg)

    @torch.no_grad()
    def fwd(experts, ids, mask, targets):
        return model.forward_loss(materialize_experts(experts, dtype), ids,
                                  mask, targets).mean()

    return fwd, (experts, torch.from_numpy(ids).to(device),
                 torch.ones((batch, 30), dtype=torch.int64, device=device),
                 torch.from_numpy(targets).to(device))


def tiny_config(device: str = "cpu") -> PrismerConfig:
    """__graft_entry__.py's dry-run configuration; on CUDA with one head
    of 64 where JAX has four of 16 (the attention kernels take head widths
    of 64 and up)."""
    heads = 1 if torch.device(device).type == "cuda" else 4
    vis = VisionEncoderConfig(
        name="ViT-Tiny-Test", image_resolution=64, label_resolution=64,
        patch_size=16, width=64, layers=2, heads=heads,
        experts=(("rgb", 3), ("depth", 1), ("seg", 64),
                 ("obj_detection", 64)),
        resampler_layers=2, resampler_heads=heads, resampler_latents=8)
    dec = TextDecoderConfig(
        vocab_size=512, hidden_size=64, vision_hidden_size=64,
        num_hidden_layers=2, num_attention_heads=heads,
        intermediate_size=128, hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1)
    return PrismerConfig(vision=vis, decoder=dec,
                         prismer_model="prismer_tiny",
                         freeze="freeze_vision", dtype="float32")


def _state(cfg, device):
    from prismer_tpu_torch.train import TrainState
    model = build_random_prismer(cfg, SEED, device)
    return TrainState.create(model, lambda s: 1e-4, 0.05, cfg.freeze,
                             random_masters(model, SEED), seed=2)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _local_elements(tensors) -> int:
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               for t in tensors)


def _opt_elements(optimizer) -> int:
    return _local_elements(v for s in optimizer.state.values()
                           for k, v in s.items() if k != "step")


def dryrun_rank(n: int, device: str) -> Dict[str, Any]:
    """One rank of `dryrun_multichip(n)`."""
    from prismer_tpu_torch.models import caption
    from prismer_tpu_torch.models import roberta as rb
    from prismer_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from prismer_tpu_torch.parallel.zero import shard_state
    from prismer_tpu_torch.train import build_train_step

    cfg = tiny_config(device)
    rng = np.random.default_rng(0)
    batch = n
    experts = _to(_expert_batch(rng, cfg.vision, batch), device)
    ids = torch.from_numpy(rng.integers(4, 512, (batch, 8))).to(device)
    mask = torch.ones((batch, 8), dtype=torch.int64, device=device)
    targets = ids.clone()
    targets[:, :2] = -100
    global_batch = {"experts": experts, "input_ids": ids,
                    "attention_mask": mask, "targets": targets}
    out: Dict[str, Any] = {}

    # ZeRO-3 (+ TP): the per-rank parameters must fall to ~1/n of the
    # whole (plus the replicated small leaves), then one step
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n // n_model, n_model, device)
    state = _state(cfg, device)
    total = sum(p.numel() for p in state.model.parameters())
    shard_state(state, mesh, "zero3", min_size=512)
    out["zero3_ratio"] = _local_elements(state.model.parameters()) / total
    _check(out["zero3_ratio"] < 0.45,
           f"ZeRO-3 per-rank footprint {out['zero3_ratio']:.3f} (n={n})")
    step = build_train_step(state.model, mesh, "zero3")
    _, metrics = step(state, shard_batch(global_batch, mesh))
    out["loss"] = float(metrics["loss"])
    _check(np.isfinite(out["loss"]), f"non-finite loss {out['loss']}")

    # ZeRO-2 on a pure data mesh: the optimizer state falls to ~1/n
    data_mesh = make_mesh(n, 1, device)
    state = _state(cfg, device)
    step = build_train_step(state.model, data_mesh, "zero2")
    whole = sum(2 * leaf.numel() for _, leaf in state.trainable())
    shard_state(state, data_mesh, "zero2", min_size=512)
    _, metrics = step(state, shard_batch(global_batch, data_mesh))
    out["zero2_loss"] = float(metrics["loss"])
    out["zero2_ratio"] = _opt_elements(state.optimizer) / whole
    _check(np.isfinite(out["zero2_loss"]),
           f"non-finite zero2 loss {out['zero2_loss']}")
    _check(out["zero2_ratio"] < 0.45,
           f"ZeRO-2 per-rank optimizer state {out['zero2_ratio']:.3f} (n={n})")

    # serving: sharded generation over the data axis, the model replicated
    model = build_random_prismer(cfg, SEED, device)
    gen = caption.build_sharded_generate_fn(model, data_mesh, num_beams=3,
                                            max_length=12, min_length=6)
    seqs = gen(experts, ids[:, :4], mask[:, :4])
    _check(tuple(seqs.shape) == (batch, 12), f"ids {tuple(seqs.shape)}")

    # the serving default stack forced on (fused decode, lm_topk, in-kernel
    # beam reorder), then int8 cross K/V: the sharded ids equal one
    # process's exactly
    rb.set_fused_decode("on")
    try:
        for kv in ("off", "int8"):
            rb.set_kv_quant(kv)
            one = caption.build_generate_fn(model, num_beams=3,
                                            max_length=12, min_length=6)
            want = one(experts, ids[:, :4], mask[:, :4])
            got = caption.build_sharded_generate_fn(
                model, data_mesh, num_beams=3, max_length=12,
                min_length=6)(experts, ids[:, :4], mask[:, :4])
            _check(torch.equal(got, want),
                   f"sharded generate (kv {kv}) differs from one process")
            out[f"ids_{kv}"] = got.cpu().numpy()
    finally:
        rb.set_fused_decode("auto")
        rb.set_kv_quant("off")
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict[str, Any]:
    """Run the checks on `n_devices` spawned ranks, one card each unless
    `device` is "cpu" (gloo); rank 0's record."""
    if torch.device(device).type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                f"{n_devices} ranks need {n_devices} CUDA devices, "
                f"{torch.cuda.device_count()} found (device='cpu' runs them "
                "over gloo on the CPU)")
        from prismer_tpu_torch.ops import _build
        _build.build()               # once, before the ranks load it
    with tempfile.TemporaryDirectory() as d:
        results = runtime.spawn(dryrun_rank, n_devices, device, d,
                                args=(n_devices, device))
    r = results[0]
    print(f"dryrun_multichip({n_devices}): ok, loss={r['loss']:.4f}, "
          f"zero3 params {r['zero3_ratio']:.3f} / zero2 optimizer "
          f"{r['zero2_ratio']:.3f} of the whole per rank, sharded generate "
          f"ok, kernel-stack generate ok (fp32 K/V + int8-KV)")
    return r


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.n:
        ap.error(f"{args.n} ranks need {args.n} CUDA devices, "
                 f"{torch.cuda.device_count()} found (--device cpu runs "
                 "them over gloo on the CPU)")
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
