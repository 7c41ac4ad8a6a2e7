"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `prismer_tpu_torch/csrc/`, checks each
against its plain PyTorch version at the shapes the captioning path gives it,
checks the fp32 model on the card against the same model on the CPU, then
serves a few captioning requests through `build_generate_fn` in bf16 and
checks that they went through every kernel. Exits non-zero if any phase
fails or if there is no CUDA device; the last line of standard output is a
JSON object with the device.

The slice: Prismer-BASE, all six experts, 480 px, bf16, beam 3, max length
20, fused decode off. Weights are random, drawn from a fixed seed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
ROOT = Path(__file__).resolve().parent

# stated tolerances: max-abs error of a kernel against its plain version run
# on the card on the same inputs upcast to fp32 (TF32 off)
TOL_FP32 = 1e-4
TOL_BF16_OUT = 2e-2
TOL_BF16_LSE = 1e-3
TOL_SLICE_REL_L2 = 1e-3   # fp32 model, card vs CPU


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def card_info() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise Failed(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_attention(results):
    import torch
    from prismer_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    packed = results["flash_attention_packed"]
    # encoder self-attention and resampler cross-attention
    for name, b, lq, lk, h, dh in (("encoder", 8, 964, 964, 12, 64),
                                    ("resampler", 8, 64, 1240, 8, 96)):
        q32, k32, v32 = randn(b, lq, h * dh), randn(b, lk, h * dh), \
            randn(b, lk, h * dh)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            out, lse = fa.flash_attention_packed_lse(q, k, v, h)
            r_out, r_lse = fa._reference_with_lse(
                *(fa._heads(t.float(), h) for t in (q, k, v)))
            r_out = r_out.permute(0, 2, 1, 3).reshape(out.shape)
            e_out = (out.float() - r_out).abs().max().item()
            e_lse = (lse - r_lse).abs().max().item()
            fp32 = dtype == torch.float32
            tol_o = TOL_FP32 if fp32 else TOL_BF16_OUT
            tol_l = TOL_FP32 if fp32 else TOL_BF16_LSE
            ms = cuda_ms(lambda: fa.flash_attention_packed_lse(q, k, v, h))
            plain = cuda_ms(lambda: fa._reference_with_lse(
                fa._heads(q, h), fa._heads(k, h), fa._heads(v, h)))
            log(f"  packed {name} B={b} Lq={lq} Lk={lk} H={h} Dh={dh} "
                f"{str(dtype)[6:]}: max|out err|={e_out:.3g} (tol {tol_o}) "
                f"max|lse err|={e_lse:.3g} (tol {tol_l}) kernel {ms:.4f} ms "
                f"plain {plain:.4f} ms")
            expect(e_out <= tol_o and e_lse <= tol_l,
                   f"packed attention {name} {dtype} out of tolerance")
            packed["max_abs_err"] = max(packed["max_abs_err"], e_out)
            if dtype == torch.bfloat16 and name == "encoder":
                packed["ms"], packed["plain_ms"] = ms, plain

    flash = results["flash_attention"]
    # decoder prefill self-attention: N = 8 * 3 beams, right-padded prompts
    for p_len in (4, 40):
        n, h, dh = 24, 12, 64
        q32, k32, v32 = (randn(n, h, p_len, dh) for _ in range(3))
        mask = torch.ones(n, p_len, dtype=torch.int32, device=dev)
        for i in range(0, n, 5):  # some right-padded rows
            mask[i, p_len - 1 - (i % max(p_len - 1, 1)):] = 0
        mask[:, 0] = 1
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            out, lse = fa.flash_attention_lse(q, k, v, mask, causal=True)
            r_out, r_lse = fa._reference_with_lse(
                q.float(), k.float(), v.float(), mask, causal=True)
            e_out = (out.float() - r_out).abs().max().item()
            e_lse = (lse - r_lse).abs().max().item()
            fp32 = dtype == torch.float32
            tol_o = TOL_FP32 if fp32 else TOL_BF16_OUT
            tol_l = TOL_FP32 if fp32 else TOL_BF16_LSE
            ms = cuda_ms(lambda: fa.flash_attention_lse(q, k, v, mask, True))
            plain = cuda_ms(lambda: fa._reference_with_lse(q, k, v, mask,
                                                           True))
            log(f"  masked causal N={n} H={h} P={p_len} Dh={dh} "
                f"{str(dtype)[6:]}: max|out err|={e_out:.3g} (tol {tol_o}) "
                f"max|lse err|={e_lse:.3g} (tol {tol_l}) kernel {ms:.4f} ms "
                f"plain {plain:.4f} ms")
            expect(e_out <= tol_o and e_lse <= tol_l,
                   f"masked causal attention P={p_len} {dtype} out of "
                   "tolerance")
            flash["max_abs_err"] = max(flash["max_abs_err"], e_out)
            if dtype == torch.bfloat16 and p_len == 4:
                flash["ms"], flash["plain_ms"] = ms, plain


def _beam_case(rng, b, k, t, n_eos, n_neg, n_done):
    """Random bookkeeping inputs with exact ties, NEG_INF candidates, EOS
    candidates and done samples (the cases of tests/test_beam_update.py)."""
    import numpy as np
    from prismer_tpu_torch.ops.beam_update import NEG_INF
    kk, eos, vocab = 2 * k, 2, 50
    vals = rng.standard_normal((b, kk)).astype(np.float32) * 3.0
    vals[:, 1] = vals[:, 0]
    if n_neg:
        vals.reshape(-1)[rng.choice(b * kk, n_neg, replace=False)] = NEG_INF
    beam = rng.integers(0, k, (b, kk)).astype(np.int32)
    tok = rng.integers(3, vocab, (b, kk)).astype(np.int32)
    if n_eos:
        tok.reshape(-1)[rng.choice(b * kk, n_eos, replace=False)] = eos
    aseq = rng.integers(0, vocab, (b * k, t)).astype(np.int32)
    fseq = rng.integers(0, vocab, (b * k, t)).astype(np.int32)
    ascore = rng.standard_normal((b, k)).astype(np.float32)
    fscore = rng.standard_normal((b, k)).astype(np.float32) - 1.0
    fscore[:, -1] = NEG_INF
    fscore[:n_done] = 100.0
    return vals, beam, tok, aseq, ascore, fseq, fscore


def check_beam_update(results):
    import numpy as np
    import torch
    from prismer_tpu_torch.ops.beam_update import (beam_bookkeeping,
                                                   beam_update)

    rng = np.random.default_rng(SEED)
    entry = results["beam_update"]
    n_cases = 0
    for b in (8, 5):
        for n_eos, n_neg, n_done in ((0, 0, 0), (3, 2, 0), (5, 4, 1),
                                     (8, 6, 2), (2 * b * 3, 0, b)):
            for index in (4, 11, 19):
                case = _beam_case(rng, b, 3, 20, n_eos, n_neg, n_done)
                gpu = [torch.from_numpy(x).cuda() for x in case]
                kw = dict(eos_token_id=2, pad_token_id=1)
                pen = float(np.float32(index))
                want = beam_bookkeeping(*gpu, index, pen, **kw)
                got = beam_update(*gpu, index, pen, **kw)
                for w, g in zip(want, got):
                    expect(torch.equal(w, g),
                           f"beam_update differs at B={b} index={index}")
                n_cases += 1
    gpu = [torch.from_numpy(x).cuda()
           for x in _beam_case(rng, 8, 3, 20, 3, 2, 1)]
    entry["ms"] = cuda_ms(lambda: beam_update(
        *gpu, 10, 10.0, eos_token_id=2, pad_token_id=1), iters=100)
    entry["plain_ms"] = cuda_ms(lambda: beam_bookkeeping(
        *gpu, 10, 10.0, eos_token_id=2, pad_token_id=1), iters=100)
    entry["max_abs_err"] = 0.0
    log(f"  beam_update: {n_cases} cases at B in (8, 5), K=3, T=20 "
        f"bit-identical (tol: exact) kernel {entry['ms']:.4f} ms plain "
        f"{entry['plain_ms']:.4f} ms")


# ---------------------------------------------------------------------------
# phases 3 and 4: the model
# ---------------------------------------------------------------------------

def slice_config(dtype: str):
    from prismer_tpu_torch.config import CAPTION_EXPERTS, build_prismer_config
    return build_prismer_config({
        "experts": CAPTION_EXPERTS, "image_resolution": 480,
        "prismer_model": "prismer_base", "freeze": "freeze_vision",
        "dtype": dtype})


def raw_batch(cfg, batch: int, gen, device):
    """Seeded random raw expert batch as materialize_experts takes it: uint8
    rgb frames, dense maps in [-1, 1], uint8 id maps with (256, 64) tables
    and an instance map for obj_detection."""
    import torch
    r, lr = cfg.vision.image_resolution, cfg.vision.label_resolution

    def uniform(*shape):
        return torch.rand(*shape, generator=gen, device=device) * 2 - 1

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=device,
                             dtype=torch.uint8)

    raw = {"rgb": u8(batch, r, r, 3)}
    for exp, ch in cfg.vision.experts:
        if exp in ("depth", "normal", "edge"):
            raw[exp] = uniform(batch, lr, lr, ch)
        elif exp != "rgb":
            raw[exp] = {"ids": u8(batch, lr, lr),
                        "table": uniform(batch, 256, ch)}
    raw["obj_detection"]["instance"] = u8(batch, lr, lr)
    return raw


def rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def phase_slice_parity(results):
    """fp32 Prismer-BASE at batch 1: card (kernels) vs CPU (plain)."""
    import torch
    from prismer_tpu_torch.data.device import materialize_experts
    from prismer_tpu_torch.models.prismer import build_random_prismer

    cfg = slice_config("float32")
    t0 = time.perf_counter()
    cpu = build_random_prismer(cfg, SEED, "cpu")
    gpu = build_random_prismer(cfg, SEED, "cuda")
    log(f"  built fp32 Prismer-BASE twice in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in cpu.parameters()) / 1e6:.1f} M params)")
    gen = torch.Generator().manual_seed(SEED)
    raw = raw_batch(cfg, 1, gen, "cpu")
    to_gpu = lambda x: ({k: v.cuda() for k, v in x.items()}
                        if isinstance(x, dict) else x.cuda())
    raw_gpu = {k: to_gpu(v) for k, v in raw.items()}
    prompt = torch.tensor([[0, 250, 1000, 7]], dtype=torch.int32)
    mask = torch.ones_like(prompt)
    beams = 3
    outs = {}
    for name, model, r, dev in (("cpu", cpu, raw, "cpu"),
                                ("cuda", gpu, raw_gpu, "cuda")):
        t0 = time.perf_counter()
        with torch.no_grad():
            enc = model.encode(materialize_experts(r, torch.float32))
            logits, _ = model.init_cache(
                prompt.repeat_interleave(beams, 0).to(dev),
                mask.repeat_interleave(beams, 0).to(dev), enc, 20, beams)
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[name] = (enc, logits)
        log(f"  {name}: encode + init_cache {time.perf_counter() - t0:.2f} s,"
            f" encode {tuple(enc.shape)}")
    e_enc = rel_l2(outs["cuda"][0], outs["cpu"][0])
    e_log = rel_l2(outs["cuda"][1], outs["cpu"][1])
    log(f"  fp32 card vs CPU: encode rel L2 {e_enc:.3g}, last logits rel L2 "
        f"{e_log:.3g} (tol {TOL_SLICE_REL_L2})")
    expect(tuple(outs["cuda"][0].shape) == (1, 964, 768), "encode shape")
    expect(bool(torch.isfinite(outs["cuda"][0]).all()), "encode not finite")
    expect(e_enc <= TOL_SLICE_REL_L2 and e_log <= TOL_SLICE_REL_L2,
           "card vs CPU fp32 out of tolerance")
    del cpu, gpu, outs
    torch.cuda.empty_cache()


def phase_serve(results, card: str):
    """bf16 captioning requests through build_generate_fn."""
    import torch
    from prismer_tpu_torch.models.caption import build_generate_fn
    from prismer_tpu_torch.models.prismer import build_random_prismer

    cfg = slice_config("bfloat16")
    model = build_random_prismer(cfg, SEED, "cuda")
    generate = build_generate_fn(model)
    vocab = cfg.decoder.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    requests = []
    for batch in (8, 8, 8, 5):
        raw = raw_batch(cfg, batch, gen, "cuda")
        prompt = torch.randint(4, 1000, (batch, 4), generator=gen,
                               device="cuda", dtype=torch.int32)
        requests.append((raw, prompt, torch.ones_like(prompt)))

    wrap = wrappers()
    for fn in wrap.values():
        fn.launches = 0
    outs, times = [], []
    generate(*requests[0])             # warm-up, one per batch shape
    generate(*requests[3])
    torch.cuda.synchronize()
    for req in [requests[0]] + requests:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        seqs = generate(*req)
        end.record()
        torch.cuda.synchronize()
        outs.append(seqs)
        times.append(start.elapsed_time(end))
    for name, fn in wrap.items():
        results[name]["launches"] = fn.launches

    for i, (req, seqs) in enumerate(zip([requests[0]] + requests, outs)):
        b = req[1].shape[0]
        expect(tuple(seqs.shape) == (b, 20), f"request {i}: shape "
               f"{tuple(seqs.shape)}")
        expect(torch.equal(seqs[:, :4], req[1].long()),
               f"request {i}: prompt not preserved")
        expect(bool(((seqs >= 0) & (seqs < vocab)).all()),
               f"request {i}: ids out of range")
    expect(torch.equal(outs[0], outs[1]), "same request gave different ids")
    for name, entry in results.items():
        expect(entry["launches"] > 0, f"{name} never launched on the path")
    b8 = times[1:4]
    ms8 = sum(b8) / len(b8)
    log(f"  4 requests (+1 repeat, +2 warm-up) of (8, 8, 8, 5) images: "
        f"shapes, prompts, id range and determinism ok; sample ids "
        f"{outs[1][0].tolist()}")
    log(f"  launches on the path: " + ", ".join(
        f"{n}={e['launches']}" for n, e in results.items()))
    log(f"  batch 8: {ms8:.1f} ms/request ({' '.join(f'{t:.1f}' for t in b8)})"
        f", {8000.0 / ms8:.1f} images/s; batch 5: {times[4]:.1f} ms/request, "
        f"{5000.0 / times[4]:.1f} images/s ({card})")


# ---------------------------------------------------------------------------

KERNELS = (
    ("flash_attention_packed", "prismer_tpu_torch/csrc/flash_attention.cu",
     "prismer_tpu/ops/flash_attention.py:666"),
    ("flash_attention", "prismer_tpu_torch/csrc/flash_attention.cu",
     "prismer_tpu/ops/flash_attention.py:311"),
    ("beam_update", "prismer_tpu_torch/csrc/beam_update.cu",
     "prismer_tpu/ops/beam_update.py:209"),
)


def wrappers():
    from prismer_tpu_torch.ops import beam_update as bu
    from prismer_tpu_torch.ops import flash_attention as fa
    return {"flash_attention_packed": fa.flash_attention_packed,
            "flash_attention": fa.flash_attention,
            "beam_update": bu.beam_update}


def main() -> int:
    try:
        import torch
    except ImportError:
        log("torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("no CUDA device: this smoke run needs one GPU")
        return 2
    if not (ROOT / "prismer_tpu_torch").is_dir():
        log(f"prismer_tpu_torch not found beside {Path(__file__).name}")
        return 2
    sys.path.insert(0, str(ROOT))

    # phase 0: card and settings
    card = card_info()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    results = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "launches": 0, "max_abs_err": 0.0,
                      "ms": None, "plain_ms": None}
               for name, src, rep in KERNELS}
    phases = (("build", phase_build), ("kernels", phase_kernels),
              ("slice parity", phase_slice_parity),
              ("serve", lambda r: phase_serve(r, card)))
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn(results)
        except Failed as e:
            log(f"FAILED phase {name}: {e}")
            return 1
        log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase_build(results):
    from prismer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.kernels()
    log(f"  built and loaded {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_kernels(results):
    check_attention(results)
    check_beam_update(results)


if __name__ == "__main__":
    sys.exit(main())
