"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from `prismer_tpu_torch/csrc/`, checks each
against its plain PyTorch version at the shapes the captioning path gives it,
checks the fp32 model on the card against the same model on the CPU and the
fp32 fused decode path against the per-layer path, then serves captioning
requests through `build_generate_fn` in bf16, fused decode on (the default on
CUDA) and then off, and checks that the fused requests went through every
kernel. Exits non-zero if any phase fails or if there is no CUDA device; the
last line of standard output is a JSON object with the device.

The slice: Prismer-BASE, all six experts, 480 px, bf16, beam 3, max length
20, min length 8, 4-token prompt, batch 8 and 5. Weights are random, drawn
from a fixed seed. `--profile` adds a torch.profiler view and an
encode / beam-search split of one batch-8 request on each decode path.
"""

from __future__ import annotations

import argparse
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
# fused decode step, kernel vs plain on the same inputs. fp32: sums taken in
# another order over 13 layers (max abs). bf16: every rounding that the sum
# order flips propagates through the later layers, so after 13 layers two
# bf16 runs that differ only in sum order are a few percent apart (rel L2),
# and each is as far from the fp32 run on the same bf16 values. The kernel
# must be within 1e-2 of the plain version where no depth compounds (layer
# 0's k/v_new, one projection) and, at full depth, no further from the fp32
# run than the plain bf16 version is, with 25 % to spare.
TOL_FUSED_FP32 = 2e-4     # max abs
TOL_FUSED_BF16 = 1e-2     # rel L2, layer-0 k_new / v_new
TOL_FUSED_BF16_DEPTH = 1.25   # rel L2 to fp32, kernel over plain
# lm_topk, as tests/test_lm_topk.py holds the TPU kernel: indices exact,
# values 2e-5 relative + 2e-5 absolute
TOL_TOPK = 2e-5
# fp32 beam scores, fused vs per-layer path: sums of ~16 log-probs taken in
# another order
TOL_SCORES = 1e-3


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


# Prismer-BASE decoder shapes: D, heads, F, cross layers, max length, L
BASE = dict(d=768, heads=12, f=3072, nlc=12, t=20, l_enc=964)


def _fused_case(gen, b, beams, index):
    """Random fused-step inputs at Prismer-BASE widths (fp32, on the card):
    packed weights scaled like lecun-normal Dense kernels, LN scales near 1,
    caches and cross K/V of unit scale, a key mask valid through `index`
    with a pad hole, and a beam permutation within each sample."""
    import torch
    from prismer_tpu_torch.ops.fused_decode import layer_views, packed_sizes
    d, f, nlc, t = BASE["d"], BASE["f"], BASE["nlc"], BASE["t"]
    n = b * beams
    dev = "cuda"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    nw, nb = packed_sizes(d, f, nlc)
    w_all, b_all = randn(nw), randn(nb) * 0.05
    for layer in layer_views(w_all, b_all, d, f, nlc):
        for name, x in layer.items():
            if name.startswith("w_"):
                x.mul_(x.shape[1] ** -0.5)
            elif name.startswith("b_ln"):
                x[:d].add_(1.0)
    key_mask = torch.zeros((n, t), dtype=torch.int32, device=dev)
    key_mask[:, :index + 1] = 1
    key_mask[beams:2 * beams, 2] = 0
    flat_beam = (torch.randint(0, beams, (b, beams), generator=gen,
                               device=dev)
                 + torch.arange(b, device=dev)[:, None] * beams)
    return dict(hidden0=randn(n, d), w_all=w_all, b_all=b_all,
                self_k=randn(nlc + 1, t, n, d), self_v=randn(nlc + 1, t, n, d),
                key_mask=key_mask, cross_k=randn(nlc, b, BASE["l_enc"], d),
                cross_v=randn(nlc, b, BASE["l_enc"], d), index=index,
                flat_beam=flat_beam.reshape(-1).to(torch.int32))


def check_fused_decode(results):
    import torch
    from prismer_tpu_torch.ops import fused_decode as fd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    entry = results["fused_decode_step"]
    kw = dict(heads=BASE["heads"], eps=1e-5)
    # batch 8 and 5 are the slice's; 16 (N = 48) takes the kernels' second
    # 32-row block
    for b in (8, 5, 16):
        case = _fused_case(gen, b, 3, 10)
        index = case.pop("index")
        fb = case.pop("flat_beam")
        for dtype in (torch.float32, torch.bfloat16):
            x = {k: (v.to(dtype) if v.is_floating_point() and k != "b_all"
                     else v) for k, v in case.items()}
            fp32 = dtype == torch.float32
            if not fp32:
                # the fp32 run on the same bf16 values (biases rounded too)
                x32 = {k: (v.float() if v.is_floating_point() else v)
                       for k, v in x.items()}
                x32["b_all"] = x["b_all"].to(dtype).float()
            for perm in (False, True):
                def args(t):  # fresh caches for each call
                    return (t["hidden0"], t["w_all"], t["b_all"],
                            t["self_k"].clone(), t["self_v"].clone(),
                            t["key_mask"], t["cross_k"], t["cross_v"], index,
                            fb if perm else None)
                got = fd.fused_decode_step(*args(x), **kw)
                want = fd.fused_decode_step_reference(*args(x), **kw)
                torch.cuda.synchronize()
                errs = [(g.float() - w.float()).abs().max().item()
                        for g, w in zip(got[:3], want[:3])]
                rels = [rel_l2(g, w) for g, w in zip(got[:3], want[:3])]
                for g in got[:3]:
                    expect(bool(torch.isfinite(g.float()).all()),
                           "fused_decode_step output not finite")
                # caches: copies except column `index`, which holds k/v_new
                cols = torch.arange(BASE["t"], device="cuda") != index
                same = all(torch.equal(gc[:, cols], wc[:, cols])
                           for gc, wc in zip(got[3:], want[3:]))
                same &= torch.equal(got[3][:, index], got[1])
                same &= torch.equal(got[4][:, index], got[2])
                line = (f"  fused_decode_step N={3 * b} {str(dtype)[6:]} "
                        f"perm={perm}: max|err| hidden/k_new/v_new "
                        f"{'/'.join(f'{e:.3g}' for e in errs)}, rel L2 "
                        f"{'/'.join(f'{r:.3g}' for r in rels)}")
                if fp32:
                    ok = max(errs) <= TOL_FUSED_FP32
                    line += f" (tol max abs {TOL_FUSED_FP32})"
                else:
                    exact = fd.fused_decode_step_reference(*args(x32), **kw)
                    shallow = max(rel_l2(got[i][0], want[i][0])
                                  for i in (1, 2))
                    k_err = rel_l2(got[0], exact[0])
                    p_err = rel_l2(want[0], exact[0])
                    ok = (shallow <= TOL_FUSED_BF16
                          and k_err <= TOL_FUSED_BF16_DEPTH * p_err)
                    line += (f"; layer-0 k/v_new rel L2 {shallow:.3g} (tol "
                             f"{TOL_FUSED_BF16}); hidden rel L2 to the fp32 "
                             f"run: kernel {k_err:.3g}, plain {p_err:.3g} "
                             f"(tol kernel <= {TOL_FUSED_BF16_DEPTH} x "
                             f"plain)")
                    del exact
                log(line + f", caches bit-equal {same}")
                expect(ok and same, f"fused_decode_step N={3 * b} {dtype} "
                       f"perm={perm} out of tolerance")
                if fp32:
                    entry["max_abs_err"] = max(entry["max_abs_err"], *errs)
                if not fp32 and perm:
                    outk = torch.empty_like(x["self_k"])
                    outv = torch.empty_like(x["self_v"])
                    ms = cuda_ms(lambda: fd.fused_decode_step(
                        x["hidden0"], x["w_all"], x["b_all"], x["self_k"],
                        x["self_v"], x["key_mask"], x["cross_k"],
                        x["cross_v"], index, fb, outk, outv, **kw), iters=10)
                    plain = cuda_ms(lambda: fd.fused_decode_step_reference(
                        x["hidden0"], x["w_all"], x["b_all"], x["self_k"],
                        x["self_v"], x["key_mask"], x["cross_k"],
                        x["cross_v"], index, fb, outk, outv, **kw), iters=10)
                    log(f"    bf16 N={3 * b} with reorder: kernel {ms:.4f} ms "
                        f"plain {plain:.4f} ms")
                    if b == 8:
                        entry["ms"], entry["plain_ms"] = ms, plain
        del case, x
        torch.cuda.empty_cache()


def check_lm_topk(results):
    import torch
    from prismer_tpu_torch.ops import lm_topk as lt

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    entry = results["lm_topk"]
    v, d, beams = 50265, 768, 3
    emb32 = torch.randn(v, d, generator=gen, device="cuda") * 0.02
    bias = torch.randn(v, generator=gen, device="cuda") * 0.1
    for b in (8, 5, 16):         # 16: a second 32-row block, as above
        n = b * beams
        h32 = torch.randn(n, d, generator=gen, device="cuda")
        alive = torch.randn(b, beams, generator=gen, device="cuda")
        alive[1, 2] = -1.0e7
        # exact ties: three identical embedding rows and biases on top of
        # beam 0, and two identical beams in sample 2
        e = emb32.clone()
        bb = bias.clone()
        e[[1000, 2000, 40000]] = 0.2 * h32[0] / h32[0].norm()
        bb[[1000, 2000, 40000]] = 3.0
        h32[7] = h32[6]
        alive[2, 1] = alive[2, 0]
        for dtype in (torch.float32, torch.bfloat16):
            h, emb = h32.to(dtype), e.to(dtype)
            for mask_eos in (False, True):
                kw = dict(beams=beams, kk=2 * beams, eos_token_id=2)
                got = lt.lm_topk(h, emb, bb, alive, mask_eos, **kw)
                again = lt.lm_topk(h, emb, bb, alive, mask_eos, **kw)
                want = lt.lm_topk_reference(h, emb, bb, alive, mask_eos, **kw)
                torch.cuda.synchronize()
                exact = all(torch.equal(g, w) for g, w in zip(got[1:],
                                                               want[1:]))
                repeat = all(torch.equal(g, a) for g, a in zip(got, again))
                err = (got[0] - want[0]).abs().max().item()
                ok_v = bool(((got[0] - want[0]).abs()
                             <= TOL_TOPK + TOL_TOPK * want[0].abs()).all())
                ties = got[2][0, :3].tolist()
                log(f"  lm_topk N={n} V={v} {str(dtype)[6:]} mask_eos="
                    f"{mask_eos}: indices exact {exact}, max|val err| "
                    f"{err:.3g} (tol {TOL_TOPK} rel + {TOL_TOPK} abs), "
                    f"repeat bit-identical {repeat}, tied tokens {ties}")
                expect(exact and ok_v and repeat,
                       f"lm_topk N={n} {dtype} mask_eos={mask_eos} differs")
                expect(ties == [1000, 2000, 40000], "lm_topk tie order")
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if dtype == torch.bfloat16 and b == 8:
                entry["ms"] = cuda_ms(lambda: lt.lm_topk(
                    h, emb, bb, alive, False, **kw), iters=20)
                entry["plain_ms"] = cuda_ms(lambda: lt.lm_topk_reference(
                    h, emb, bb, alive, False, **kw), iters=20)
                log(f"    bf16 N={n}: kernel {entry['ms']:.4f} ms plain "
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


def phase_fused_parity(results):
    """fp32 Prismer-BASE at batch 2: the fused decode path (fused_decode_step
    + lm_topk kernels) and the per-layer path give the same ids."""
    import torch
    from prismer_tpu_torch.data.device import materialize_experts
    from prismer_tpu_torch.models import roberta
    from prismer_tpu_torch.models.generation import beam_search
    from prismer_tpu_torch.models.prismer import (build_random_prismer,
                                                  prepare_serving_variables)
    from prismer_tpu_torch.ops import fused_decode, lm_topk

    cfg = slice_config("float32")
    model = build_random_prismer(cfg, SEED, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    raw = raw_batch(cfg, 2, gen, "cuda")
    prompt = torch.tensor([[0, 250, 1000, 7], [0, 31, 1, 1]],
                          dtype=torch.int32, device="cuda")
    mask = (prompt != 1).to(torch.int32)         # row 1 right-padded
    kw = dict(num_beams=3, max_length=20, min_length=8, eos_token_id=2,
              pad_token_id=1)
    with torch.no_grad():
        enc = model.encode(materialize_experts(raw, torch.float32))
    out = {}
    try:
        for mode in ("on", "off"):
            roberta.set_fused_decode(mode)
            fused_decode.fused_decode_step.launches = 0
            lm_topk.lm_topk.launches = 0
            serving = prepare_serving_variables(model)
            out[mode] = beam_search(model, enc, prompt, mask, serving=serving,
                                    **kw)
            torch.cuda.synchronize()
            used = (fused_decode.fused_decode_step.launches,
                    lm_topk.lm_topk.launches)
            expect((min(used) > 0) == (mode == "on"),
                   f"fused {mode}: fused_decode_step/lm_topk launches {used}")
    finally:
        roberta.set_fused_decode("auto")
    (seq_f, sc_f), (seq_p, sc_p) = out["on"], out["off"]
    err = (sc_f - sc_p).abs().max().item()
    log(f"  fp32 batch 2: fused ids {seq_f.tolist()}")
    log(f"  per-layer ids {seq_p.tolist()}; ids identical "
        f"{torch.equal(seq_f, seq_p)}, max|score diff| {err:.3g} "
        f"(tol {TOL_SCORES})")
    expect(torch.equal(seq_f, seq_p), "fused and per-layer ids differ")
    expect(err <= TOL_SCORES, "fused and per-layer scores differ")
    del model, enc
    torch.cuda.empty_cache()


_SERVE = {}


def serve_setup():
    """The bf16 model and the requests (batch 8, 8, 8, 5), built once."""
    import torch
    from prismer_tpu_torch.models.prismer import build_random_prismer

    if not _SERVE:
        cfg = slice_config("bfloat16")
        _SERVE["cfg"] = cfg
        _SERVE["model"] = build_random_prismer(cfg, SEED, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        requests = []
        for batch in (8, 8, 8, 5):
            raw = raw_batch(cfg, batch, gen, "cuda")
            prompt = torch.randint(4, 1000, (batch, 4), generator=gen,
                                   device="cuda", dtype=torch.int32)
            requests.append((raw, prompt, torch.ones_like(prompt)))
        _SERVE["requests"] = requests
    return _SERVE["cfg"], _SERVE["model"], _SERVE["requests"]


def timed_requests(generate, reqs):
    """(outputs, CUDA-event ms) of each request, one after another."""
    import torch
    outs, times = [], []
    for req in reqs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        seqs = generate(*req)
        end.record()
        torch.cuda.synchronize()
        outs.append(seqs)
        times.append(start.elapsed_time(end))
    return outs, times


def check_requests(reqs, outs, vocab):
    import torch
    for i, (req, seqs) in enumerate(zip(reqs, outs)):
        b = req[1].shape[0]
        expect(tuple(seqs.shape) == (b, 20), f"request {i}: shape "
               f"{tuple(seqs.shape)}")
        expect(torch.equal(seqs[:, :4], req[1].long()),
               f"request {i}: prompt not preserved")
        expect(bool(((seqs >= 0) & (seqs < vocab)).all()),
               f"request {i}: ids out of range")


def profile_request(generate, req, label: str, card: str) -> None:
    """torch.profiler over one request: wall ms, device-busy ms (the sum of
    device op times; one stream, so they do not overlap) and device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(*req)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    by_name = {}
    for e in ops:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"  profile {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {1 - busy / wall:.2f}), {len(ops)} device ops per "
        f"request ({card})")
    for name, (t, c) in top:
        log(f"    {t:8.2f} ms {c:6d}x {name[:90]}")


def split_request(model, req, label: str, card: str) -> None:
    """CUDA-event ms of one request's encode (expert gather included) and
    beam search (prefill + decode loop), on the path the mode selects."""
    import torch
    from prismer_tpu_torch.data.device import materialize_experts
    from prismer_tpu_torch.models.generation import beam_search
    from prismer_tpu_torch.models.prismer import (compute_dtype,
                                                  prepare_serving_variables)

    serving = prepare_serving_variables(model)
    dec = model.cfg.decoder
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.no_grad():
        ev[0].record()
        enc = model.encode(materialize_experts(req[0],
                                               compute_dtype(model.cfg)))
        ev[1].record()
        beam_search(model, enc, req[1], req[2], num_beams=3, max_length=20,
                    min_length=8, eos_token_id=dec.eos_token_id,
                    pad_token_id=dec.pad_token_id, serving=serving)
        ev[2].record()
    torch.cuda.synchronize()
    log(f"  split {label}: encode {ev[0].elapsed_time(ev[1]):.1f} ms, "
        f"beam search {ev[1].elapsed_time(ev[2]):.1f} ms ({card})")


def phase_serve(results, card: str, profile: bool):
    """The main path: bf16 captioning requests through build_generate_fn,
    fused decode on (the default on CUDA)."""
    import torch
    from prismer_tpu_torch.models import roberta
    from prismer_tpu_torch.models.caption import build_generate_fn

    cfg, model, requests = serve_setup()
    expect(roberta.use_fused_decode("cuda"), "fused decode is not the "
           "default on CUDA")
    generate = build_generate_fn(model)
    wrap = wrappers()
    for fn in wrap.values():
        fn.launches = 0
    generate(*requests[0])             # warm-up, one per batch shape
    generate(*requests[3])
    torch.cuda.synchronize()
    reqs = [requests[0]] + requests
    outs, times = timed_requests(generate, reqs)
    for name, fn in wrap.items():
        results[name]["launches"] = fn.launches

    check_requests(reqs, outs, cfg.decoder.vocab_size)
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
    log(f"  fused decode, batch 8: {ms8:.1f} ms/request "
        f"({' '.join(f'{t:.1f}' for t in b8)}), {8000.0 / ms8:.1f} images/s; "
        f"batch 5: {times[4]:.1f} ms/request, {5000.0 / times[4]:.1f} "
        f"images/s ({card})")
    if profile:
        split_request(model, requests[0], "fused decode, batch 8", card)
        profile_request(generate, requests[0], "fused decode, batch 8", card)


def phase_serve_per_layer(results, card: str, profile: bool):
    """The per-layer decode path (fused decode off), fewer requests."""
    import torch
    from prismer_tpu_torch.models import roberta
    from prismer_tpu_torch.models.caption import build_generate_fn

    cfg, model, requests = serve_setup()
    wrap = wrappers()
    roberta.set_fused_decode("off")
    try:
        generate = build_generate_fn(model)
        for fn in wrap.values():
            fn.launches = 0
        generate(*requests[0])         # warm-up
        torch.cuda.synchronize()
        reqs = requests[:2]
        outs, times = timed_requests(generate, reqs)
        counts = {name: fn.launches for name, fn in wrap.items()}
        if profile:
            split_request(model, requests[0], "per-layer decode, batch 8",
                          card)
            profile_request(generate, requests[0],
                            "per-layer decode, batch 8", card)
    finally:
        roberta.set_fused_decode("auto")
    check_requests(reqs, outs, cfg.decoder.vocab_size)
    per_layer = ("flash_attention_packed", "flash_attention", "beam_update")
    expect(all(counts[n] > 0 for n in per_layer)
           and counts["fused_decode_step"] == counts["lm_topk"] == 0,
           f"per-layer path launches {counts}")
    ms8 = sum(times) / len(times)
    log(f"  launches on the per-layer path: " + ", ".join(
        f"{n}={c}" for n, c in counts.items()))
    log(f"  per-layer decode, batch 8: {ms8:.1f} ms/request "
        f"({' '.join(f'{t:.1f}' for t in times)}), {8000.0 / ms8:.1f} "
        f"images/s ({card})")


# ---------------------------------------------------------------------------

KERNELS = (
    ("flash_attention_packed", "prismer_tpu_torch/csrc/flash_attention.cu",
     "prismer_tpu/ops/flash_attention.py:666"),
    ("flash_attention", "prismer_tpu_torch/csrc/flash_attention.cu",
     "prismer_tpu/ops/flash_attention.py:311"),
    ("beam_update", "prismer_tpu_torch/csrc/beam_update.cu",
     "prismer_tpu/ops/beam_update.py:209"),
    ("fused_decode_step", "prismer_tpu_torch/csrc/fused_decode.cu",
     "prismer_tpu/ops/fused_decode.py:637"),
    ("lm_topk", "prismer_tpu_torch/csrc/lm_topk.cu",
     "prismer_tpu/ops/lm_topk.py:263"),
)


def wrappers():
    from prismer_tpu_torch.ops import beam_update as bu
    from prismer_tpu_torch.ops import flash_attention as fa
    from prismer_tpu_torch.ops import fused_decode as fd
    from prismer_tpu_torch.ops import lm_topk as lt
    return {"flash_attention_packed": fa.flash_attention_packed,
            "flash_attention": fa.flash_attention,
            "beam_update": bu.beam_update,
            "fused_decode_step": fd.fused_decode_step,
            "lm_topk": lt.lm_topk}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one batch-8 request on each decode path")
    args = parser.parse_args(argv)
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
              ("fused parity", phase_fused_parity),
              ("serve", lambda r: phase_serve(r, card, args.profile)),
              ("serve fused off",
               lambda r: phase_serve_per_layer(r, card, args.profile)))
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
    check_fused_decode(results)
    check_lm_topk(results)


if __name__ == "__main__":
    sys.exit(main())
