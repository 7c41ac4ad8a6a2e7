"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from `prismer_tpu_torch/csrc/`, checks each
against its plain PyTorch version at the shapes the captioning and
fine-tune paths give it, checks the fp32 model on the card against the same
model on the CPU and the fp32 fused decode path against the per-layer path,
then serves captioning requests through `build_generate_fn` in bf16, fused
decode on (the default on CUDA) and then off, and checks that the fused
requests went through every serving kernel. Then the encoder's fused
LayerNorm path (`models.layers.set_ln_proj(True)`, off by default as in
JAX): the fp32 encode at batch 2 on the card against the CPU, and the bf16
requests again with the flag on, each of which must launch `ln_proj` 24
times and `adaptor_fused` 12 times (12 blocks), timed beside the flag off. Then the per-layer decode path's
grouped cross-attention kernel (`models.roberta.set_decode_cross("kernel")`)
and the fused path's int8 cross K/V (`set_kv_quant("int8")`), both off by
default as in JAX: each as an fp32 decoder at batch 2 on the card against
the CPU (step logits and beam ids), and the first as bf16 batch-8 requests
beside the switch off. Then Prismer-LARGE (ViT-L/14, 336 px) and
Prismer-HUGE (ViT-H/14, 480 px, int8 off and on) serve batch-8 requests at
full depth. Then VQA and answer ranking: "vqa parity" (fp32 BASE at
batch 2, the card's encoder states copied to the CPU: `rank_answers`'
pass-1 candidates, pass-2 scores and choice over 3,000 answers whose first
tokens tie, and VQA beam search over right-padded questions, card against
CPU), "serve vqa rank" (bf16 `build_rank_fn` at batch 1 and 32 with
bench.py's shapes, 30 requests each: p50 / p90 ms, kernels 1 and 2 the
only ones launched), "serve vqa generate" (bf16 `build_answer_fn` at batch
8, every serving kernel launched) and "convert" (a synthetic BASE
checkpoint in the reference's layout through `python -m
prismer_tpu_torch.convert.cli`, loaded into the port, one caption request
served). Then the caption fine-tune step: one fp32 train step on the card against the CPU, and ten bf16 AdamW
steps through `build_train_step` that must lower the loss, move every
trainable leaf, keep every frozen one and launch every training kernel,
timed at batch 4 and 16. Then the segmentation expert's label generation:
the fp32 Swin-L Mask2Former at 480 px on the card against the CPU, and the
generator's entry point (`prismer_tpu_torch.experts.generate.main`) over 37
synthetic PNGs at batch 16, with TF32 at torch's defaults (the
generator pins fp32 itself), which must launch the deformable-attention
kernel 18 times and write every label map at its image's size. The data
path from files on disk (ROADMAP §1 items 5-6) sits between the train and
the segmentation phases: "jpeg" (the port's C++ JPEG decoder, built with
g++, decodes every fixture of tests/data/jpeg (Huffman, arithmetic,
lossless, smoothed) to the sha256 that Pillow gave, through decode_jpeg and
the loader's read_rgb, and the host's median decode ms of each 640x480
fixture), "data" (a
COCO-Karpathy tree of 64 train and 16 test records made from the 640x480
fixtures, with label PNGs for the six experts and their sidecars, read by
`Caption(train=True)` at 480 px through `create_loader` at batch 16 with 1
and min(8, cores) workers: records/s and every batch's keys, shapes and
dtypes), "train from files" (five bf16 steps of the BASE train step fed by
that loader, captions tokenized as cli/train_caption.py does: ms/step,
images/s and the device's idle share beside the same steps on one fixed
batch), "eval from files" (`Caption(train=False)` at batch 8 through
`build_generate_fn`, `decode_captions` and `coco_caption_eval`: 16
distinct image ids, finite scores), then the command-line drivers, each
`main` called in process from a copy of the repo's task YAML with only
paths, `datasets` and `max_epoch: 1` set, read by the port's YAML reader:
"cli caption" (480 px, batch 4, eval and CIDEr, then `--from_checkpoint
--evaluate`), "cli vqa" (480 px, batch 8 with sample weights, rank over
3,000 answers), "cli classification" (384 px from a reference-layout
.bin, rank over 1,000 class names), "cli pretrain" (224 px,
freeze_lang_vision, batch 32, peak memory) and "cli demo" (16 images at
batch 1, then `demo_vis`), each with ms/step, images/s, eval s and the
launches (every training kernel in the train steps, kernels 1-5 in
caption eval), and after "segment", "segment jpeg"
(the generator over 4 fixtures as .jpg and the same pixels as PNG: equal
label maps), "image formats" (every fixture of tests/data/webp, gif and bmp
decodes through decode_webp / decode_gif / bmp.decode_bmp, in RGB and in
Pillow's own mode, and through read_rgb, to the sha256 Pillow gave; the
host's median decode ms of each 640x480 kind beside the JPEG's; then the
generator over the 640x480 WebP, GIF and BMP fixtures under .jpg names and
over their PNG twins, one model, equal label maps with kernel 10 launched,
and one BASE bf16 beam-3 caption batch of those records through
load_expert_labels, experts_to_device and build_generate_fn, equal ids from
both trees with kernels 1-5 launched), then the other five label experts:
"experts parity" (each of DPT-hybrid, NNET, DexiNed, UniDet and CharNet at
full width from the seed, fp32 at 480 px, card against CPU, UniDet stage by
stage, and the CLIP text encoder at ViT-L/14's text width), "experts
generate" (the generator's depth, normal, edge, obj_detection,
ocr_detection and seg_coco tasks over 16 images, every label file where
`data.labels` reads it, images/s, device and host time, peak memory) and
"experts demo" (`cli.demo` at BASE captioning those images from those
labels, kernels 1-5 launched). Then "multi-gpu" (the parallel/ package at
NCCL world size 1 and over two gloo ranks on the card), "devices" (with two
or more cards: captioning and a train step on cuda:1 from a process whose
current device is 0 equal cuda:0's, requests alternating between the cards;
on one card it logs that it did not run), "threads" (two threads on streams
of their own serve, then train, at once: ids and losses equal a serial
run), "png" (every fixture of tests/data/png decodes to the sha256 Pillow
gave) and "label cache" (PRISMER_LABEL_CACHE: records/s off, cold and warm,
batches bit-equal, train steps fed warm). Exits non-zero if any phase fails
or if there is no CUDA device; the last line of standard output is a JSON
object with the device.

The slice: Prismer-BASE, all six experts, 480 px, bf16; serving with beam
3, max length 20, min length 8, 4-token prompt, batch 8 and 5; fine-tuning
with freeze_vision, AdamW (wd 0.05) over fp32 masters, ragged captions of
at most 30 tokens with the 4-token prompt masked, batch 4 (and 16 for
time). The segmentation slice: MaskFormer(num_classes=133) as
`load_expert_model('seg_coco')` builds it (Swin-L, 6 deformable encoder
layers, 200 queries x 9 decoder layers), fp32, 480 px, batch 16. Weights
are random, drawn from a fixed seed. `--profile` adds a torch.profiler view
and an encode / beam-search split of one batch-8 request on each decode
path, the same for one train step with its encoder / decoder / optimizer
split, and for one batch-16 segmentation forward its backbone / pixel
decoder / decoder / post split and the deformable-attention kernel's share.

The fused decode step (kernels 4 and 4b) is also timed as CUDA-graph
replays beside CUDA events, checked for bit-identical repeats and for the
kernels the C entry launched per step (`ops.fused_decode.step_launches`),
and split by phase with torch.profiler at N 24 (`fused_step_split`); the
records sit under `step` in its `kernels` entries.

The grouped decode cross-attention (kernels 11-12) is held to its plain
version also at its key split's edge shapes and on the prefill's head-split
K/V views, and timed twice: L2-warm (one input set, replayed) and L2-cold
(a graph cycling through one K/V set per cross layer, as the decode loop
reads another layer's cache on every call); its `kernels` entries carry the
cold times.

The encoder's fused LayerNorm kernels (14 `ln_proj`, 15 `adaptor_fused`)
are held to their plain versions at Prismer-BASE, LARGE and HUGE's widths
at batch 8 (`LN_SHAPES`), at ragged row counts (`LN_RAGGED`) and at output
widths no TMA store takes (`LN_ODD`), fp32 and bf16, repeats bit-identical;
bf16 is timed by graph replay and events beside the plain version and the
composition the model runs with the flag off (their `library_ms`, marked
a yardstick), and ptxas fails the run on a spill in a bf16 kernel or a
product kernel without HGMMA in its SASS.

The multi-scale deformable attention (kernel 10) is held to its plain
version at the pixel decoder's shapes at N 16, 5 and 1 on two families of
sampling locations, uniform over [-0.15, 1.15] and shaped as Mask2Former's
(`deform_case`), and at the odd shapes of its launch plan
(`DEFORM_EDGES`); its entry's `ms` is the N 16 uniform time, `ms_local`
the Mask2Former-shaped one.

Every kernel's entry in the `kernels` line carries `bound_ms`, the least
time the card could take for the timed call: the larger of its bytes (each
input read once, each output written once) over 3.35 TB/s and its
operations over the H100's dense peak for their type (989 TFLOP/s bf16, 67
fp32); `bound_by` says which. `library_ms` times one PyTorch call that
computes the same function where there is one
(`F.scaled_dot_product_attention` for the attention forward and its
autograd backward), else null; the port itself never calls it.
"""

from __future__ import annotations

import argparse
import atexit
import json
import math
import re
import statistics
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
# flash backward and fused CE, kernel vs plain on the same inputs: fp32 max
# abs over the reference's largest magnitude (sums in another order); bf16
# rel L2 (the kernels round p and ds to bf16 where JAX does, but the sums'
# order flips some of those roundings)
TOL_BWD_FP32 = 1e-4
TOL_BWD_BF16 = 2e-2
# segmentation expert, fp32 MaskFormer card (kernel) vs CPU (plain) at 480
# px: semantic map rel L2; argmax ids must agree wherever the top-2 gap of
# the CPU's semantic logits exceeds SEG_GAP
TOL_SEG_REL_L2 = 1e-3
SEG_GAP = 1e-4
# the encoder's LayerNorm kernels (13-15), kernel vs plain on the same
# inputs: fp32 max abs over the reference's largest magnitude; bf16
# elementwise |err| <= atol + 2e-2 |ref| with the atol of
# tests/test_ln_proj.py (2e-2, the adaptor 3e-2): the two sides sum the
# statistics and each product in another order, so a bf16 rounding of an
# intermediate can flip by one ulp (2^-8 to 2^-7 relative). The adaptor's
# residual add x + u can cancel, so its relative part is taken of
# |x| + |ref| (>= |u|): a one-ulp flip of u then stays within it
TOL_LN_BF16_REL = 2e-2
TOL_LN_BF16_ABS = {"fused_layer_norm": 2e-2, "ln_proj": 2e-2,
                   "adaptor_fused": 3e-2}
# fp32 Prismer-BASE encode with set_ln_proj(True), card vs CPU (rel L2)
TOL_LNPROJ_ENCODE = 1e-4
ENC_ROWS, ENC_DIM = 8 * 964, 768    # the encoder's rows at batch 8
# the LayerNorm kernels' shapes: Prismer-BASE's, then ViT-H/14's at 480 px
ENC_SHAPES = ((ENC_ROWS, ENC_DIM), (8 * 1220, 1280))
LN_PROJ_PER_ENCODE = {"ln_proj": 24, "adaptor_fused": 12}   # 12 blocks

# the beam-grouped decode cross-attention (kernels 11, 12), kernel vs plain
# on the same inputs: max abs, fp32 TOL_FP32 and bf16 TOL_BF16_OUT (one
# bf16 ulp of an output near 1 is 2^-8)
# fp32 per-layer decode with set_decode_cross("kernel") and fp32 fused
# decode with int8 cross K/V, card vs CPU: the step logits' rel L2
TOL_DECODE_LOGITS = 1e-4

# the H100 SXM's published rates (NVIDIA data sheet): HBM bytes/s and dense
# FLOP/s by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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


def nbytes(*tensors) -> int:
    """Bytes of the tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def set_bound(entry, n_bytes: float, flops: float, dtype) -> None:
    """entry['bound_ms'] / ['bound_by']: the larger of bytes over the HBM
    rate and operations over the dense peak of `dtype`."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[str(dtype)[6:]] * 1e3
    entry["bound_ms"] = max(by_bytes, by_ops)
    entry["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"


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


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call from CUDA events around one replay
    of a CUDA graph of `iters` calls: the device's time without the host's
    dispatch of each call, which is longer than a few-microsecond kernel."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def forward_attention():
    """Kernels 1 and 2's shapes as (name, packed, B, Lq, Lk, H, Dh, key
    mask, causal, views): serving at batch 8 (the encoder, the resampler,
    the LARGE / HUGE head dims of wide_attention, the decoder's masked
    causal prefill at prompt lengths 4 and 40 over N = 8 x 3 beams), the
    VQA rank path at batch 1 and 32 (pass 1's self-attention over the
    12-token question and its cross-attention over the 964 encoder states;
    pass 2's over [question ; answer] for N = B x k_test rows), VQA
    generation's prefill (BOS + 12 question tokens, N = 8 x 3 beams), the
    classification driver's rank eval at 384 px (cli_eval_attention), then
    the train steps' (train_attention). Key masks: "prefill"
    (right-padded prompts, the first key always kept), "rank" (a
    right-padded question, then the answer's keys all kept) or "captions"
    (right-padded captions, one sample with no valid key). views: the
    head-split operands are the decoder's split_heads views of (B, L, H*Dh)
    projections, as the model passes them, not contiguous (B, H, L, Dh)."""
    q_len, a_len, k = RANK_Q_LEN, RANK_ANSWER_LEN, RANK_K
    return [("encoder", True, 8, 964, 964, 12, 64, None, False, False),
            ("resampler", True, 8, 64, 1240, 8, 96, None, False, False),
            *[(name, True, b, lq, lk, h, dh, None, False, False)
              for name, b, lq, lk, h, dh in wide_attention()],
            *[(f"prefill P{n}", False, 24, n, n, 12, 64, "prefill", True,
               False) for n in (4, 40)],
            *[row for b in (1, 32) for row in (
                (f"rank pass 1 self B{b}", False, b, q_len, q_len, 12, 64,
                 "prefill", True, True),
                (f"rank pass 1 cross B{b}", False, b, q_len, 964, 12, 64,
                 None, False, True),
                (f"rank pass 2 self N{b * k}", False, b * k, q_len + a_len,
                 q_len + a_len, 12, 64, "rank", True, True))],
            ("vqa prefill P13", False, VQA_GEN_BATCH * 3, 13, 13, 12, 64,
             "prefill", True, True),
            *cli_eval_attention(),
            *[(f"train {name}", packed, b, lq, lk, h, dh,
               "captions" if masked else None, causal, False)
              for name, packed, b, lq, lk, h, dh, masked, causal
              in train_attention()]]


def _caption_lens(b: int, lk: int):
    """Right-padded captions' key counts, one sample with no valid key:
    lk, lk - 7, 5, 0, repeated over the batch."""
    import torch
    lens = (lk, lk - 7, 5, 0)
    return torch.tensor([lens[i % 4] for i in range(b)], device="cuda")


def _forward_mask(kind, b, lk):
    import torch
    if kind is None:
        return None
    if kind == "captions":
        lens = _caption_lens(b, lk)
        return (torch.arange(lk, device="cuda")[None] < lens[:, None]).to(
            torch.int32)
    if kind == "rank":  # questions of 1 .. P tokens, then the answer's
        p = lk - RANK_ANSWER_LEN
        lens = 1 + torch.arange(b, device="cuda") % p
        pos = torch.arange(lk, device="cuda")[None]
        return ((pos < lens[:, None]) | (pos >= p)).to(torch.int32)
    mask = torch.ones(b, lk, dtype=torch.int32, device="cuda")
    for i in range(0, b, 5):  # some right-padded rows
        mask[i, lk - 1 - (i % max(lk - 1, 1)):] = 0
    mask[:, 0] = 1
    return mask


def check_attention(results):
    """Kernels 1 (packed entry) and 2 (head-split entry, masks and causal)
    against their plain versions at every shape of forward_attention, fp32
    and bf16; two launches on the same inputs bit-identical. At every bf16
    shape: kernel and plain ms (CUDA events), device ms (graph replay), the
    bound, achieved TFLOP/s on 4 x Dh x the (query, key) pairs the masks
    keep (the count set_bound uses) and SDPA on the same inputs. Then ptxas
    -v's registers and spills of every forward instantiation."""
    import torch
    import torch.nn.functional as F
    from prismer_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entries = {True: results["flash_attention_packed"],
               False: results["flash_attention"]}
    for name, packed, b, lq, lk, h, dh, mask_kind, causal, views in \
            forward_attention():
        if packed or views:
            shapes = ((b, lq, h * dh), (b, lk, h * dh), (b, lk, h * dh))
        else:
            shapes = ((b, h, lq, dh), (b, h, lk, dh), (b, h, lk, dh))
        base = [torch.randn(*s, generator=gen, device="cuda") for s in shapes]
        if views:
            base = [fa._heads(t, h) for t in base]
        mask = _forward_mask(mask_kind, b, lk)
        keep = torch.ones(lq, lk, dtype=torch.bool, device="cuda")
        if causal:
            keep = keep.tril(lk - lq)
        if mask is not None:
            keep = mask[:, None, None, :].bool() & keep
        pairs = keep.expand(b, h, lq, lk).sum().item()
        entry = entries[packed]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in base)
            if packed:
                heads = [fa._heads(t, h) for t in (q, k, v)]

                def kernel():
                    return fa.flash_attention_packed_lse(q, k, v, h)

                def plain():
                    return fa._reference_with_lse(*heads)
            else:
                heads = [q, k, v]

                def kernel():
                    return fa.flash_attention_lse(q, k, v, mask, causal)

                def plain():
                    return fa._reference_with_lse(q, k, v, mask, causal)
            out, lse = kernel()
            out2, lse2 = kernel()
            r_out, r_lse = fa._reference_with_lse(
                *(t.float() for t in heads), mask, causal)
            if packed:
                r_out = r_out.permute(0, 2, 1, 3).reshape(out.shape)
            torch.cuda.synchronize()
            e_out = (out.float() - r_out).abs().max().item()
            e_lse = (lse - r_lse).abs().max().item()
            repeat = torch.equal(out, out2) and torch.equal(lse, lse2)
            fp32 = dtype == torch.float32
            tol_o = TOL_FP32 if fp32 else TOL_BF16_OUT
            tol_l = TOL_FP32 if fp32 else TOL_BF16_LSE
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            log(f"  attention {name} {'packed' if packed else 'head-split'}"
                f" B={b} Lq={lq} Lk={lk} H={h} Dh={dh}"
                f"{f' {mask_kind} mask' if mask_kind else ''}"
                f"{' causal' if causal else ''} {str(dtype)[6:]}: "
                f"max|out err|={e_out:.3g} (tol {tol_o}) max|lse err|="
                f"{e_lse:.3g} (tol {tol_l}), repeat bit-identical {repeat}; "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            expect(e_out <= tol_o and e_lse <= tol_l and repeat,
                   f"attention {name} {dtype} out of tolerance")
            entry["max_abs_err"] = max(entry["max_abs_err"], e_out)
            if fp32:
                continue
            bound = {}
            flops = 4.0 * pairs * dh
            set_bound(bound, nbytes(q, k, v, mask, out, lse), flops, dtype)
            dev = graph_ms(kernel)
            sdpa_mask = None if mask is None and not causal else keep
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                *(fa._heads(t, h) if packed else t for t in (q, k, v)),
                attn_mask=sdpa_mask))
            log(f"    bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})"
                f", graph replay {dev:.4f} ms; achieved "
                f"{flops / ms / 1e9:.1f} TFLOP/s (events), "
                f"{flops / dev / 1e9:.1f} (graph); "
                f"F.scaled_dot_product_attention {lib:.4f} ms")
            if name in ("encoder", "prefill P4"):
                entry.update(ms=ms, plain_ms=plain_ms, library_ms=lib,
                             **bound)
            del out, out2, lse, lse2, r_out, r_lse
        del base
        torch.cuda.empty_cache()
    # the bf16 ring and single-tile kernels of Dh 64 .. 160, and the fp32
    # FMA kernel, whose spills (the same as before the bf16 redesign) are
    # listed but not failed: it serves the parity checks only
    report_ptxas("flash_attention", 15, ungated=("fwd_f32",))


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
    for b in (8, 5, 16):
        for n_eos, n_neg, n_done in ((0, 0, 0), (3, 2, 0), (5, 4, 1),
                                     (8, 6, 2), (2 * b * 3, 0, b)):
            for index in (4, 11, 19):
                case = _beam_case(rng, b, 3, 20, n_eos, n_neg, n_done)
                gpu = [torch.from_numpy(x).cuda() for x in case]
                kw = dict(eos_token_id=2, pad_token_id=1)
                pen = float(np.float32(index))
                want = beam_bookkeeping(*gpu, index, pen, **kw)
                got = beam_update(*gpu, index, pen, **kw)
                again = beam_update(*gpu, index, pen, **kw)
                for w, g, a in zip(want, got, again):
                    expect(torch.equal(w, g) and torch.equal(g, a),
                           f"beam_update differs at B={b} index={index}")
                n_cases += 1
    log(f"  beam_update: {n_cases} cases at B in (8, 5, 16), K=3, T=20 "
        f"bit-identical to the plain version and across repeats (tol: "
        f"exact)")
    for b in (8, 5, 16):
        gpu = [torch.from_numpy(x).cuda()
               for x in _beam_case(rng, b, 3, 20, 3, 2, 1)]

        def kernel():
            return beam_update(*gpu, 10, 10.0, eos_token_id=2,
                               pad_token_id=1)
        events, graph = cuda_ms(kernel, iters=100), graph_ms(kernel, 100)
        plain = cuda_ms(lambda: beam_bookkeeping(
            *gpu, 10, 10.0, eos_token_id=2, pad_token_id=1), iters=100)
        bound = {}
        set_bound(bound, nbytes(*gpu, *kernel()), 0.0, torch.float32)
        log(f"    B={b}: kernel graph {graph:.4f} ms, events {events:.4f} "
            f"ms, plain {plain:.4f} ms, bound {bound['bound_ms']:.6f} ms "
            f"(bytes)")
        if b == 8:   # the main path's shape
            entry.update(bound, ms=graph, events_ms=events, plain_ms=plain,
                         max_abs_err=0.0)
    report_ptxas("beam_update", 2)


# Prismer-BASE decoder shapes: D, heads, F, cross layers, max length, L
BASE = dict(d=768, heads=12, f=3072, nlc=12, t=20, l_enc=964)
# Prismer-HUGE's (roberta-large, 24 + 1 layers; LARGE's but for L = 640)
HUGE_DEC = dict(d=1024, heads=16, f=4096, nlc=24, t=20, l_enc=1220)


def _fused_case(gen, b, beams, index, dims=BASE):
    """Random fused-step inputs at the decoder widths `dims` (fp32, on the
    card): packed weights scaled like lecun-normal Dense kernels, LN scales
    near 1, caches and cross K/V of unit scale, a key mask valid through
    `index` with a pad hole, and a beam permutation within each sample."""
    import torch
    from prismer_tpu_torch.ops.fused_decode import layer_views, packed_sizes
    d, f, nlc, t = dims["d"], dims["f"], dims["nlc"], dims["t"]
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
                key_mask=key_mask, cross_k=randn(nlc, b, dims["l_enc"], d),
                cross_v=randn(nlc, b, dims["l_enc"], d), index=index,
                flat_beam=flat_beam.reshape(-1).to(torch.int32))

# the projections of one fused step in launch order (csrc/fused_decode.cu
# run_step): each cross layer's, then the output layer's
FUSED_CROSS_MATS = ("qkv", "self_out", "cross_q", "cross_out", "ad_down",
                    "ad_up", "mlp_in", "mlp_out")
FUSED_OUT_MATS = ("qkv", "self_out", "mlp_in", "mlp_out")


def fused_step_split(call, w_all, nlc: int, calls: int = 3):
    """torch.profiler over `calls` fused steps: device ms per step by phase
    (each projection by its matrix, in launch order; the LayerNorm, self-
    and cross-attention kernels), kernels per step, the device span of a
    step and the projections' TB/s (the step's weight bytes over their
    time). With programmatic dependent launch a kernel's time starts when
    its first block is resident, its wait on the kernel before included, so
    a kernel is charged only the time by which it extends the span past the
    kernels before it (the phases add up to the span); `summed_ms` is the
    plain sum of the kernels' times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    mats = list(FUSED_CROSS_MATS) * nlc + list(FUSED_OUT_MATS)
    phases, proj_i, end = {}, 0, -math.inf
    for e in ops:
        if "ln_kernel" in e.name:
            kind = "ln"
        elif "self_attn" in e.name:
            kind = "self"
        elif "cross_attn" in e.name:
            kind = "cross"
        else:
            kind = "proj " + mats[proj_i % len(mats)]
            proj_i += 1
        extends = max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
        phases[kind] = phases.get(kind, 0.0) + extends
    per = {k: v / 1e3 / calls for k, v in sorted(phases.items())}
    proj = sum(v for k, v in per.items() if k.startswith("proj"))
    summed = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / calls
    return {"profiled_launches_per_step": len(ops) / calls,
            "split_ms": per, "projections_ms": proj, "summed_ms": summed,
            "span_ms": sum(per.values()),
            "projection_tb_s": nbytes(w_all) / (proj * 1e-3) / 1e12}


def time_fused_step(label, entry, x, index, fb, kw, nlc, plain_iters,
                    split):
    """The bf16 step with the reorder on `x`: CUDA-event ms (the host's
    issue of every launch included) and graph-replay ms (the device alone),
    the plain version's ms, the kernels the C entry launched per step, two
    calls bit-identical (the split-K order is fixed), and with `split` the
    profiler's device split. Stored under entry["step"][label]."""
    import torch
    from prismer_tpu_torch.ops import _build
    from prismer_tpu_torch.ops import fused_decode as fd
    outk, outv = torch.empty_like(x["self_k"]), torch.empty_like(x["self_v"])
    args = (x["hidden0"], x["w_all"], x["b_all"], x["self_k"], x["self_v"],
            x["key_mask"], x["cross_k"], x["cross_v"], index, fb, outk, outv)
    k = dict(kw, cross_ks=x.get("cross_ks"), cross_vs=x.get("cross_vs"))

    def call():
        return fd.fused_decode_step(*args, **k)
    first = [t.clone() for t in call()]
    launches = _build.kernels().prismer_fused_decode_launches()
    same = all(torch.equal(a, b) for a, b in zip(first, call()))
    del first
    rec = {"events_ms": cuda_ms(call, iters=10),
           "graph_ms": graph_ms(call, iters=10),
           "plain_ms": cuda_ms(lambda: fd.fused_decode_step_reference(
               *args, **k), iters=plain_iters),
           "launches_per_step": launches, "repeat_bit_identical": same}
    if split:
        rec.update(fused_step_split(call, x["w_all"], nlc))
    entry.setdefault("step", {})[label] = rec
    line = (f"    bf16 {label} with reorder: kernel {rec['events_ms']:.4f} ms "
            f"events, {rec['graph_ms']:.4f} ms graph; plain "
            f"{rec['plain_ms']:.4f} ms; {launches} launches per step; two "
            f"calls bit-identical {same}")
    if split:
        line += (f"\n      split (profiler, ms per step): span "
                 f"{rec['span_ms']:.4f}, summed {rec['summed_ms']:.4f}, "
                 f"projections {rec['projections_ms']:.4f} "
                 f"({rec['projection_tb_s']:.3f} TB/s); "
                 + ", ".join(f"{name} {t:.4f}"
                             for name, t in rec["split_ms"].items()))
    log(line)
    expect(same, f"fused_decode_step {label}: two calls differ")
    expect(launches == fd.step_launches(nlc), f"fused_decode_step {label}: "
           f"{launches} launches per step, the plan says "
           f"{fd.step_launches(nlc)}")
    return rec


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
                    rec = time_fused_step(f"BASE N={3 * b}", entry, x, index,
                                          fb, kw, BASE["nlc"], 10, b == 8)
                    if b == 8:
                        entry["ms"] = rec["events_ms"]
                        entry["plain_ms"] = rec["plain_ms"]
                        n, d = x["hidden0"].shape
                        t_len, l_enc = BASE["t"], BASE["l_enc"]
                        nlc = BASE["nlc"]
                        flops = 2.0 * n * x["w_all"].numel() + 4.0 * n * d * (
                            t_len * (nlc + 1) + l_enc * nlc)
                        set_bound(entry, nbytes(
                            x["hidden0"], x["w_all"], x["b_all"], x["self_k"],
                            x["self_v"], x["key_mask"], x["cross_k"],
                            x["cross_v"], fb, *got), flops, dtype)
                        log(f"    bound {entry['bound_ms']:.4f} ms "
                            f"({entry['bound_by']})")
        del case, x
        torch.cuda.empty_cache()


def check_lm_topk(results):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    entry = results["lm_topk"]
    for d, batches in ((768, (8, 5, 16)), (1024, (8, 16))):
        _check_lm_topk(gen, entry, d, batches)
    # the bf16 logits kernel's 6 row counts (gated: no spill), the fp32 FMA
    # kernel's 4 (parity runs only: listed) and the selection's 16 (beams
    # 1-8, lists of 8 or 16)
    report_ptxas("lm_topk", 26, ungated=("lm_topk fma_logits",))


def _check_lm_topk(gen, entry, d, batches):
    """lm_topk at width d (768 BASE, 1024 LARGE / HUGE) for each batch."""
    import torch
    from prismer_tpu_torch.ops import lm_topk as lt

    v, beams = 50265, 3
    emb32 = torch.randn(v, d, generator=gen, device="cuda") * 0.02
    bias = torch.randn(v, generator=gen, device="cuda") * 0.1
    for b in batches:            # 16: N 48, the 48-wide wgmma
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
                log(f"  lm_topk N={n} V={v} D={d} {str(dtype)[6:]} mask_eos="
                    f"{mask_eos}: indices exact {exact}, max|val err| "
                    f"{err:.3g} (tol {TOL_TOPK} rel + {TOL_TOPK} abs), "
                    f"repeat bit-identical {repeat}, tied tokens {ties}")
                expect(exact and ok_v and repeat,
                       f"lm_topk N={n} {dtype} mask_eos={mask_eos} differs")
                expect(ties == [1000, 2000, 40000], "lm_topk tie order")
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if dtype != torch.bfloat16:
                continue

            def kernel():
                return lt.lm_topk(h, emb, bb, alive, False, **kw)
            events, graph = cuda_ms(kernel, iters=20), graph_ms(kernel, 50)
            bound = {}
            set_bound(bound, nbytes(h, emb, bb, alive, *kernel()),
                      2.0 * n * v * d, dtype)
            log(f"    bf16 N={n} D={d}: kernel graph {graph:.4f} ms "
                f"({nbytes(emb) / graph / 1e9:.3f} TB/s of embedding), "
                f"events {events:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                f"({bound['bound_by']})")
            if b == 8 and d == 768:   # the main path's shape
                plain = cuda_ms(lambda: lt.lm_topk_reference(
                    h, emb, bb, alive, False, **kw), iters=20)
                entry.update(bound, ms=graph, events_ms=events,
                             plain_ms=plain)
                log(f"    plain {plain:.4f} ms")


def _bwd_errors(got, want, fp32: bool):
    """fp32: max abs over the reference's largest magnitude; bf16: rel L2."""
    g, w = got.double(), want.double()
    if fp32:
        return ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item()


# the train step's attention shapes at batch 4: (name, packed, B, Lq, Lk, H,
# Dh, key mask, causal)
TRAIN_ATTENTION = (
    ("trunk", True, 4, 964, 964, 12, 64, False, False),
    ("resampler", True, 4, 64, 1240, 8, 96, False, False),
    ("decoder self", False, 4, 30, 30, 12, 64, True, True),
    ("decoder cross", False, 4, 30, 964, 12, 64, False, False),
)
# the drivers' train steps at other resolutions (phases "cli pretrain" and
# "cli classification"): (label, pixels, batch)
CLI_TRAIN_SIZES = (("pretrain", 224, 32), ("classification", 384, 2))


def _encoder_shapes(res: int):
    """Prismer-BASE (six experts) at `res` px: (trunk tokens, resampler
    keys, trunk heads, resampler heads, resampler head dim)."""
    v = model_config(CLI_MODEL, res, "bfloat16").vision
    return (v.rgb_tokens + v.resampler_latents,
            expert_tokens(v) + v.resampler_latents, v.heads,
            v.resampler_heads, v.width // v.resampler_heads)


def train_attention():
    """TRAIN_ATTENTION, then the same rows of the pretrain driver's step
    (224 px, batch 32: trunk 260 tokens, decoder self-attention over 30
    captions' keys at batch 32, cross-attention over 260 keys) and the
    classification driver's (384 px, batch 2: trunk 640 tokens,
    cross-attention over 640 keys), derived from the model config."""
    rows = list(TRAIN_ATTENTION)
    for label, res, b in CLI_TRAIN_SIZES:
        trunk, keys, h, rh, rdh = _encoder_shapes(res)
        rows += [(f"{label} trunk {res} px", True, b, trunk, trunk, h, 64,
                  False, False),
                 (f"{label} resampler {res} px", True, b, 64, keys, rh, rdh,
                  False, False),
                 (f"{label} decoder cross {res} px", False, b, 30, trunk, 12,
                  64, False, False)]
        if b > 4:
            rows.append((f"{label} decoder self B{b}", False, b, 30, 30, 12,
                         64, True, True))
    return rows


def cli_eval_attention():
    """The classification driver's rank eval (phase "cli classification":
    384 px, 8 images at the config's batch_size_test 8): the encoder's
    trunk and resampler, and rank pass 1's self- and cross-attention over
    the config's prefix prompt, the cross-attention over 640 keys."""
    from prismer_tpu_torch.config import (default_config_path,
                                          load_task_config)
    from prismer_tpu_torch.models.caption import prefix_prompt_ids
    from prismer_tpu_torch.tokenizer import synthetic_tokenizer
    config = load_task_config(default_config_path("classification"))
    res, b = config["image_resolution"], config["batch_size_test"]
    p = prefix_prompt_ids(synthetic_tokenizer(), config["prefix"],
                          1)[0].shape[1]
    trunk, keys, h, rh, rdh = _encoder_shapes(res)
    return [(f"classification encoder {res} px B{b}", True, b, trunk, trunk,
             h, 64, None, False, False),
            (f"classification resampler {res} px B{b}", True, b, 64, keys,
             rh, rdh, None, False, False),
            (f"classification rank pass 1 self B{b}", False, b, p, p, 12, 64,
             "prefill", True, True),
            (f"classification rank pass 1 cross B{b}", False, b, p, trunk,
             12, 64, None, False, True)]


def check_flash_backward(results):
    """Kernels 6 and 7 against their plain versions at the train steps'
    shapes (train_attention) and at the LARGE / HUGE encoders' head dims
    80, 128 and 160,
    fp32 and bf16; two launches on the same inputs bit-identical. At every
    bf16 shape: kernel and plain ms (CUDA events), device ms (graph
    replay), the bound, achieved TFLOP/s on the 6 / 8 x B*H*Lq*Lk*Dh counts
    and SDPA's backward on the same inputs. Then ptxas -v's registers and
    spills of every instantiation (report_ptxas)."""
    import torch
    from prismer_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    dq_e, dkv_e = (results["flash_attention_bwd_dq"],
                   results["flash_attention_bwd_dkv"])
    wide = [(name, True, b, lq, lk, h, dh, False, False)
            for name, b, lq, lk, h, dh in wide_attention()]
    for name, packed, b, lq, lk, h, dh, masked, causal in (
            *train_attention(), *wide):
        w = h * dh
        if packed:
            shapes = ((b, lq, w), (b, lk, w), (b, lk, w))
        else:
            shapes = ((b, h, lq, dh), (b, h, lk, dh), (b, h, lk, dh))
        base = [torch.randn(*s, generator=gen, device="cuda") for s in shapes]
        dout32 = torch.randn(*shapes[0], generator=gen, device="cuda")
        mask = None
        if masked:   # right-padded captions, one sample with no valid key
            lens = _caption_lens(b, lk)
            mask = (torch.arange(lk, device="cuda")[None] < lens[:, None]).to(
                torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (t.to(dtype) for t in (*base, dout32))
            if packed:
                o, lse = fa.flash_attention_packed_lse(q, k, v, h)
                delta = fa.attention_delta(
                    dout.view(b, lq, h, dh), o.view(b, lq, h, dh)
                ).transpose(1, 2).contiguous()
                views = [fa._heads(t, h) for t in (q, k, v, dout)]
            else:
                o, lse = fa.flash_attention_lse(q, k, v, mask, causal)
                delta = fa.attention_delta(dout, o)
                views = [q, k, v, dout]
            args = (*views, lse, delta, mask, causal)

            def kernel_dq():
                return fa.flash_attention_bwd_dq(*args)

            def kernel_dkv():
                return fa.flash_attention_bwd_dkv(*args)

            got = (kernel_dq(), *kernel_dkv())
            again = (kernel_dq(), *kernel_dkv())
            want = (fa.bwd_dq_reference(*args), *fa.bwd_dkv_reference(*args))
            torch.cuda.synchronize()
            fp32 = dtype == torch.float32
            errs = [_bwd_errors(g, r, fp32) for g, r in zip(got, want)]
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            repeat = all(torch.equal(g, a) for g, a in zip(got, again))
            tol = TOL_BWD_FP32 if fp32 else TOL_BWD_BF16
            ms_dq, ms_dkv = cuda_ms(kernel_dq, iters=10), cuda_ms(kernel_dkv,
                                                                  iters=10)
            plain_dq = cuda_ms(lambda: fa.bwd_dq_reference(*args), iters=5)
            plain_dkv = cuda_ms(lambda: fa.bwd_dkv_reference(*args), iters=5)
            log(f"  flash backward {name} B={b} Lq={lq} Lk={lk} H={h} "
                f"Dh={dh}{' masked causal' if causal else ''} "
                f"{str(dtype)[6:]}: dq/dk/dv err "
                f"{'/'.join(f'{e:.3g}' for e in errs)} ("
                f"{'max abs / max|ref|' if fp32 else 'rel L2'} tol {tol}), "
                f"finite {finite}, repeat bit-identical {repeat}; dq kernel "
                f"{ms_dq:.4f} ms plain {plain_dq:.4f} ms, dk/dv kernel "
                f"{ms_dkv:.4f} ms plain {plain_dkv:.4f} ms")
            expect(max(errs) <= tol and finite and repeat,
                   f"flash backward {name} {dtype} out of tolerance")
            if fp32:
                dq_e["max_abs_err"] = max(dq_e["max_abs_err"], errs[0])
                dkv_e["max_abs_err"] = max(dkv_e["max_abs_err"], *errs[1:])
                del got, again, want
                continue
            pairs = 1.0 * b * h * lq * lk * dh
            ins = nbytes(q, k, v, dout, lse, delta)
            bq, bkv = {}, {}
            set_bound(bq, ins + nbytes(got[0]), 6.0 * pairs, dtype)
            set_bound(bkv, ins + nbytes(*got[1:]), 8.0 * pairs, dtype)
            lib = sdpa_backward_ms(q, k, v, dout, packed, h, dh, mask, causal)
            # device time without the host's dispatch (which bounds the
            # decoder's small shapes), from CUDA-graph replays
            dev_dq, dev_dkv = graph_ms(kernel_dq), graph_ms(kernel_dkv)
            log(f"    bound dq {bq['bound_ms']:.4f} ms ({bq['bound_by']}), "
                f"dk/dv {bkv['bound_ms']:.4f} ms ({bkv['bound_by']}); "
                f"achieved dq {6.0 * pairs / ms_dq / 1e9:.1f}, dk/dv "
                f"{8.0 * pairs / ms_dkv / 1e9:.1f}, pair "
                f"{14.0 * pairs / (ms_dq + ms_dkv) / 1e9:.1f} TFLOP/s; "
                f"graph replay dq {dev_dq:.4f} ms, dk/dv {dev_dkv:.4f} ms "
                f"({14.0 * pairs / (dev_dq + dev_dkv) / 1e9:.1f} TFLOP/s); "
                f"F.scaled_dot_product_attention backward {lib:.4f} ms")
            if name == "trunk":
                dq_e["ms"], dq_e["plain_ms"] = ms_dq, plain_dq
                dkv_e["ms"], dkv_e["plain_ms"] = ms_dkv, plain_dkv
                dq_e.update(bq)
                dkv_e.update(bkv)
                dq_e["library_ms"] = dkv_e["library_ms"] = lib
            del got, again, want
        torch.cuda.empty_cache()
    report_ptxas("flash_attention_bwd", 20)


def sdpa_backward_ms(q, k, v, dout, packed, h, dh, mask, causal) -> float:
    """SDPA's autograd backward (dq, dk, dv together, its forward excluded)
    on the same inputs, with the same key mask and bottom-right causal
    mask: the library yardstick of kernels 6 and 7."""
    import torch
    import torch.nn.functional as F
    if packed:
        b = q.shape[0]
        leaves = [t.detach().view(b, -1, h, dh).transpose(1, 2)
                  .requires_grad_() for t in (q, k, v)]
        grad = dout.view(b, -1, h, dh).transpose(1, 2)
    else:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        grad = dout
    keep = None
    if mask is not None:
        keep = mask.bool()[:, None, None, :]
    if causal:
        lq, lk = q.shape[-2], k.shape[-2]
        tri = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(
            lk - lq)
        keep = tri if keep is None else keep & tri
    out = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, grad,
                                               retain_graph=True), iters=10)


# `nvcc -Xptxas -v` of the attention, fused-step, decode-tail, fused CE and
# deformable-attention sources, started beside the library build in
# phase_build and read after check_attention (forward),
# check_flash_backward (backward), check_decode_attention (kernels 11-12),
# check_fused_decode_huge (4), check_beam_update (3), check_lm_topk (5),
# check_fused_ce (8-9), check_ms_deform_attn (10) and check_adaptor_fused
# (14-15)
PTXAS_SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention",
                 "fused_decode", "lm_topk", "beam_update", "fused_ce",
                 "ms_deform_attn", "ln_proj")
# the fused step's kernels other than the bf16 projection (PR 11 left them
# as they were): their registers and spills are listed, not gated
FUSED_UNGATED = ("dense_kernel", "self_attn_kernel", "cross_attn_kernel",
                 "ln_kernel")
FUSED_KERNELS = 46   # proj 6, dense 4, self 2, cross 32, ln 2
_PTXAS = {}


def start_ptxas(stems=PTXAS_SOURCES):
    from prismer_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for stem in stems:
        obj = _build.BUILD_DIR / f"ptxas_{stem}.{time.time_ns()}.o"
        _PTXAS[stem] = (obj, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(obj), str(_build.CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))


def _kernel_name(entry):
    """A readable name of a mangled kernel entry of the attention, fused
    decode, decode-tail, fused CE and deformable-attention sources: flash
    "<kernel> Dh <n>", grouped "<dtype> <mode> KT <n>", fused decode
    "<kernel> <template arguments>", lm_topk "lm_topk <kernel>
    <arguments>", "beam_update <vector width>", fused CE "<kernel>
    <arguments>", "ms_deform_attn_kernel <V, L, P, staged>", the encoder
    LayerNorm kernels by name ("ln_proj_kernel", "adaptor_f32_kernel",
    "row_stats_kernel", ...); else None."""
    k = re.search(r"\d((?:ln_proj|adaptor)(?:_f32)?_kernel|row_stats_kernel)"
                  r"E", entry)
    if k:
        return k.group(1)
    k = re.search(r"\dms_deform_attn_kernelI((?:Lin?\d+E)+)E", entry)
    if k:
        args = [a.replace("n", "-")
                for a in re.findall(r"Li(n?\d+)E", k.group(1))]
        return f"ms_deform_attn_kernel <{', '.join(args)}>"
    k = re.search(r"\d(ce_[a-z_]+_kernel)(?:I((?:Li\d+E|Lb[01]E|f|"
                  r"13__nv_bfloat16)+)E)?", entry)
    if k:
        args = [num or {"1": "grad", "0": "stats"}.get(flag)
                or ("bf16" if bf else "f32")
                for num, flag, bf in re.findall(
                    r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16)|f",
                    k.group(2) or "")]
        return f"{k.group(1)} <{', '.join(args)}>" if args else k.group(1)
    # the kernel's name follows its length in the mangled entry
    k = re.search(r"\d(fma_logits|logits|select|beam_update)_kernelI(f?)"
                  r"Li(\d+)E(?:Li(\d+)E)?", entry)
    if k:
        args = ", ".join(a for a in ("f32" if k.group(2) else None,
                                     k.group(3), k.group(4)) if a)
        prefix = "" if k.group(1) == "beam_update" else "lm_topk "
        return f"{prefix}{k.group(1)} <{args}>"
    k = re.search(r"\dflash_(\w+?)ILi(\d+)", entry)
    if k:
        return f"{k.group(1)} Dh {k.group(2)}"
    k = re.search(
        r"\d((?:proj|dense|self_attn|cross_attn|ln)_kernel)I(\w+?)EEv", entry)
    if k:
        names = {"13__nv_bfloat16": "bf16", "S1_": "bf16", "f": "f32",
                 "a": "int8"}
        args = [names.get(t, t[2:-1]) for t in re.findall(
            r"13__nv_bfloat16|S1_|Li\d+E|f|a", k.group(2))]
        return f"{k.group(1)} <{', '.join(args)}>"
    k = re.search(r"grouped_attn_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d+)E",
                  entry)
    if k:
        return (f"grouped {'f32' if k.group(1) == 'f' else 'bf16'} "
                f"{('cross_t', 'decode')[int(k.group(2))]} KT {k.group(3)}")
    return None


def sass_ops(obj, op: str):
    """{kernel entry: count of SASS instructions whose opcode starts with
    `op`} of an object file (`cuobjdump -sass`)."""
    from prismer_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(obj)], capture_output=True,
                         text=True, timeout=300)
    expect(res.returncode == 0, f"cuobjdump -sass failed: {res.stderr[-500:]}")
    counts = {}
    for block in res.stdout.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        counts[name] = len(re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                                      + op, block))
    return counts


def report_ptxas(stem, n_kernels, ungated=(), hgmma=()):
    """Registers and spills of every kernel instantiation in csrc/<stem>.cu
    (ptxas -v, its full text written to the output directory as
    ptxas_<stem>.txt); fails on
    a listing of other than n_kernels instantiations and on any spill,
    except in the kernels whose names start with one of `ungated` (listed
    with their spills, not failed), and if a kernel named in `hgmma` has no
    HGMMA (wgmma) instruction in its SASS."""
    if stem not in _PTXAS:
        start_ptxas((stem,))
    obj, proc = _PTXAS.pop(stem)
    _, err = proc.communicate()
    if hgmma and proc.returncode == 0:
        counts = {_kernel_name(k): n for k, n in sass_ops(obj, "HGMMA").items()}
        for name in hgmma:
            log(f"    SASS {name}: {counts.get(name, 0)} HGMMA")
            expect(counts.get(name, 0) > 0, f"{name} has no HGMMA in its SASS")
    obj.unlink(missing_ok=True)
    expect(proc.returncode == 0, f"nvcc -Xptxas -v {stem}.cu failed: "
           f"{err[-2000:]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"ptxas_{stem}.txt").write_text(err)
    rows, entry, props, name = [], None, None, None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            name = _kernel_name(entry)
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and props == entry:
            rows.append([name, None, int(m.group(1)) + int(m.group(2))])
        m = re.search(r"Used (\d+) registers", line)
        if m and name and rows and rows[-1][0] == name:
            rows[-1][1] = int(m.group(1))
    for name, regs, spill in sorted(rows):
        note = " (not gated)" if name.startswith(ungated) else ""
        log(f"    ptxas {name}: {regs} registers, {spill} bytes spilled"
            f"{note}")
    for line in err.splitlines():
        if "wgmma" in line.lower() or "setmaxnreg" in line.lower():
            log(f"    ptxas: {line.strip()}")
    expect(len(rows) == n_kernels, f"ptxas -v listed {len(rows)} of the "
           f"{n_kernels} kernels of {stem}.cu")
    expect(all(spill == 0 for name, _, spill in rows
               if not name.startswith(ungated)),
           f"a kernel of {stem}.cu spills registers")


# check_fused_ce's shapes, (N, D) at V 50265: the caption fine-tune's CE
# rows at batch 4 and 16 (29 target tokens a caption), a short batch, one
# row, and batch 4 at the LARGE / HUGE decoder width
CE_SHAPES = ((116, 768), (464, 768), (37, 768), (1, 768), (116, 1024))
# the parent's bf16 rel L2 of dh / demb / dbias to the plain version on the
# same inputs (tools/ab_fused_ce.py, NVIDIA H100 80GB HBM3, 700.00 W): its
# kernels kept dx in fp32; these round it once to bf16
CE_PARENT_REL_L2 = {(116, 768): (1.47e-5, 3.17e-7, 9.39e-8),
                    (464, 768): (8.04e-5, 3.39e-7, 2.71e-7),
                    (37, 768): (0.0, 3.05e-7, 8.09e-8),
                    (116, 1024): (6.50e-5, 4.26e-7, 1.35e-7)}
# fused_ce.cu's instantiations: ce_logits 6, ce_dh_mma 3, ce_demb_mma 1,
# the reductions 3, the fp32 FMA kernels 3 (listed, not gated)
CE_KERNELS = 16
CE_UNGATED = ("ce_stats_kernel", "ce_dh_kernel", "ce_demb_kernel")


def check_fused_ce(results):
    """Kernels 8 and 9 against their plain versions at CE_SHAPES, fp32 and
    bf16, repeat launches bit-identical; bf16 timed by graph replay and by
    events (kernel and plain) beside the bf16 matmul of the logits product
    alone; then ptxas -v of fused_ce.cu (no spill in a bf16 kernel)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    st_e, gr_e = results["ce_stats"], results["ce_grads"]
    st_e["shapes"], gr_e["shapes"] = [], []
    v = 50265
    for d in sorted({d for _, d in CE_SHAPES}):
        emb32 = torch.randn(v, d, generator=gen, device="cuda") * 0.02
        bias = torch.randn(v, generator=gen, device="cuda") * 0.1
        for n in (n for n, dd in CE_SHAPES if dd == d):
            _check_fused_ce(gen, st_e, gr_e, emb32, bias, n)
        del emb32, bias
        torch.cuda.empty_cache()
    report_ptxas("fused_ce", CE_KERNELS, CE_UNGATED)


def _check_fused_ce(gen, st_e, gr_e, emb32, bias, n):
    import torch
    from prismer_tpu_torch.ops import fused_ce as fc

    v, d = emb32.shape
    h32 = torch.randn(n, d, generator=gen, device="cuda")
    lab = torch.randint(0, v, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    lab[:3] = torch.tensor([0, v - 1, v - 2], dtype=torch.int32)[:n]
    valid = (torch.rand(n, generator=gen, device="cuda") > 0.2).float()
    gv = (valid * 0.25).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        h, emb = h32.to(dtype), emb32.to(dtype)
        fp32 = dtype == torch.float32
        tol = TOL_BWD_FP32 if fp32 else TOL_BWD_BF16
        stats = fc.ce_stats(h, emb, bias, lab)
        stats2 = fc.ce_stats(h, emb, bias, lab)
        r_stats = fc.ce_stats_reference(h, emb, bias, lab)
        lse = stats[2]
        grads = fc.ce_grads(h, emb, bias, lab, gv, lse, 0.1)
        grads2 = fc.ce_grads(h, emb, bias, lab, gv, lse, 0.1)
        r_grads = fc.ce_grads_reference(h, emb, bias, lab, gv, lse, 0.1)
        torch.cuda.synchronize()
        e_st = [_bwd_errors(g, r, fp32) for g, r in zip(stats, r_stats)]
        e_gr = [_bwd_errors(g, r, fp32) for g, r in zip(grads, r_grads)]
        repeat = (all(torch.equal(a, b) for a, b in zip(stats, stats2))
                  and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (*stats, *grads))
        log(f"  fused CE N={n} V={v} D={d} {str(dtype)[6:]}: xlab/sumx/lse"
            f" err {'/'.join(f'{e:.3g}' for e in e_st)}, dh/demb/dbias "
            f"err {'/'.join(f'{e:.3g}' for e in e_gr)} ("
            f"{'max abs / max|ref|' if fp32 else 'rel L2'} tol {tol}), "
            f"finite {finite}, repeat bit-identical {repeat}")
        expect(max(e_st + e_gr) <= tol and repeat and finite,
               f"fused CE N={n} D={d} {dtype} out of tolerance")
        if fp32:
            st_e["max_abs_err"] = max(st_e["max_abs_err"], *e_st)
            gr_e["max_abs_err"] = max(gr_e["max_abs_err"], *e_gr)
            continue
        parent = CE_PARENT_REL_L2.get((n, d))
        if parent:
            log(f"    bf16 dh/demb/dbias rel L2 "
                f"{'/'.join(f'{e:.3g}' for e in e_gr)}, the parent's "
                f"{'/'.join(f'{e:.3g}' for e in parent)} (dx in fp32)")
        rec = {"N": n, "D": d}
        for name, fn, plain in (
                ("stats", lambda: fc.ce_stats(h, emb, bias, lab),
                 lambda: fc.ce_stats_reference(h, emb, bias, lab)),
                ("grads", lambda: fc.ce_grads(h, emb, bias, lab, gv, lse,
                                              0.1),
                 lambda: fc.ce_grads_reference(h, emb, bias, lab, gv, lse,
                                               0.1))):
            rec[name] = {"graph_ms": graph_ms(fn, iters=20),
                         "events_ms": cuda_ms(fn, iters=20),
                         "plain_ms": graph_ms(plain, iters=5)}
        rec["matmul_ms"] = graph_ms(lambda: torch.matmul(h, emb.t()),
                                    iters=20)
        nvd = 2.0 * n * v * d
        bound_st, bound_gr = {}, {}
        set_bound(bound_st, nbytes(h, emb, bias, lab, *stats), nvd, dtype)
        set_bound(bound_gr, nbytes(h, emb, bias, lab, gv, lse, *grads),
                  3 * nvd, dtype)
        rec["stats"].update(bound_st)
        rec["grads"].update(bound_gr)
        st_e["shapes"].append({"N": n, "D": d, **rec["stats"]})
        gr_e["shapes"].append({"N": n, "D": d, **rec["grads"]})
        log(f"    bf16 ms (graph / events, plain by graph): stats "
            f"{rec['stats']['graph_ms']:.4f} / "
            f"{rec['stats']['events_ms']:.4f}, plain "
            f"{rec['stats']['plain_ms']:.4f}, bound "
            f"{bound_st['bound_ms']:.4f} ({bound_st['bound_by']}); grads "
            f"{rec['grads']['graph_ms']:.4f} / "
            f"{rec['grads']['events_ms']:.4f}, plain "
            f"{rec['grads']['plain_ms']:.4f}, bound "
            f"{bound_gr['bound_ms']:.4f} ({bound_gr['bound_by']}); bf16 "
            f"matmul(h, emb^T) {rec['matmul_ms']:.4f}")
        if (n, d) == (116, 768):
            for entry, r, b in ((st_e, rec["stats"], bound_st),
                                (gr_e, rec["grads"], bound_gr)):
                entry.update(b, ms=r["graph_ms"], events_ms=r["events_ms"],
                             plain_ms=r["plain_ms"])


def _ln_errors(got, want, name: str, fp32: bool, mag=None):
    """(max abs error, within tolerance): fp32 against TOL_FP32 times the
    reference's largest magnitude, bf16 elementwise within
    TOL_LN_BF16_ABS[name] + TOL_LN_BF16_REL * mag (default |ref|)."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    if fp32:
        ok = err.max().item() <= TOL_FP32 * w.abs().max().item()
    else:
        mag = w.abs() if mag is None else mag
        ok = bool((err <= TOL_LN_BF16_ABS[name]
                   + TOL_LN_BF16_REL * mag).all())
    return err.max().item(), ok


def _ln_case(gen, rows: int, dim: int):
    """Encoder-like rows (mean ~1, spread ~3) and an fp32 LN affine near
    the identity, on the card."""
    import torch
    x = torch.randn(rows, dim, generator=gen, device="cuda") * 3 + 1
    scale = 1 + 0.1 * torch.randn(dim, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(dim, generator=gen, device="cuda")
    return x, scale, bias


def _dense(gen, rows: int, cols: int):
    """An nn.Linear weight (rows, cols) scaled like lecun-normal, and a
    bias, fp32 on the card."""
    import torch
    w = torch.randn(rows, cols, generator=gen, device="cuda") * cols ** -0.5
    return w, 0.1 * torch.randn(rows, generator=gen, device="cuda")


def _grad_check(name, kernel_fn, plain_fn, leaves):
    """The autograd Function's fp32 gradients on the card (kernel forward,
    plain recompute backward) against plain autograd, for the loss
    sum(out^2): max abs over the reference's largest magnitude."""
    import torch
    grads = []
    for fn in (kernel_fn, plain_fn):
        ts = [t.detach().clone().requires_grad_() for t in leaves]
        outs = fn(*ts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum((o.float() ** 2).sum() for o in outs).backward()
        grads.append([t.grad for t in ts])
    errs = [_bwd_errors(g, w, True) for g, w in zip(*grads)]
    log(f"    {name} fp32 gradients (Function vs plain autograd, "
        f"{len(errs)} leaves): max err {max(errs):.3g} (max abs / max|ref|, "
        f"tol {TOL_FP32})")
    expect(max(errs) <= TOL_FP32, f"{name} fp32 gradient out of tolerance")


# kernels 14-15's model shapes, (label, R at batch 8, D): Prismer-BASE,
# LARGE (ViT-L/14 at 336 px, 640 tokens) and HUGE (ViT-H/14 at 480 px, 1220
# tokens); then ragged R at BASE's width: one image, batch 5, a short edge
LN_SHAPES = (("BASE", ENC_ROWS, ENC_DIM), ("LARGE", 8 * 640, 1024),
             ("HUGE", 8 * 1220, 1280))
LN_RAGGED = (964, 5 * 964, 17)


def ln_proj_case(gen, r: int, d: int):
    """fp32 inputs of kernels 14-15 on the card: encoder-like rows and the
    LN affine (`_ln_case`), then (weight, bias) pairs: q/k/v 3 x (D, D),
    c_fc (4D, D), the adaptor's down and up (D, D)."""
    x, scale, bias = _ln_case(gen, r, d)
    return {"x": x, "scale": scale, "bias": bias,
            "qkv": [_dense(gen, d, d) for _ in range(3)],
            "fc": [_dense(gen, 4 * d, d)],
            "adaptor": [_dense(gen, d, d), _dense(gen, d, d)]}


def ln_proj_calls(case, dtype, ln_proj, adaptor_fused):
    """{label: (kernel, plain, flag_off, flops, bytes)} for kernels 14-15 on
    `case` in `dtype`: "q/k/v", "c_fc" (+ quick_gelu) and "adaptor" through
    the given wrappers (the port's, or an older source's in the A/B tools),
    their plain versions, and the composition the model runs with
    set_ln_proj off (`fp32_layer_norm`, then `F.linear` per output and the
    activation, or the adaptor's `_proj` and the residual): the yardstick
    recorded as `library_ms`, since no single PyTorch call computes LN
    followed by projections. `bytes` counts each input once and each output
    once."""
    import torch.nn.functional as F
    from prismer_tpu_torch.models.layers import quick_gelu, squared_relu
    from prismer_tpu_torch.ops import ln_proj as lp
    from prismer_tpu_torch.ops.layer_norm import fp32_layer_norm

    x = case["x"].to(dtype)
    scale, bias = case["scale"], case["bias"]
    r, d = x.shape
    p = {k: [(w.to(dtype), b.to(dtype)) for w, b in case[k]]
         for k in ("qkv", "fc", "adaptor")}
    calls = {}
    for label, act in (("q/k/v", None), ("c_fc", "quick_gelu")):
        ws, bs = zip(*p["qkv" if act is None else "fc"])
        fs = sum(w.shape[0] for w in ws)

        def off(ws=ws, bs=bs, act=act):
            y = fp32_layer_norm(x, scale, bias)
            outs = [F.linear(y, w, b) for w, b in zip(ws, bs)]
            return outs if act is None else [quick_gelu(o) for o in outs]
        calls[label] = (
            lambda ws=ws, bs=bs, act=act: ln_proj(x, scale, bias, ws, bs,
                                                  act),
            lambda ws=ws, bs=bs, act=act: lp.ln_proj_reference(
                x, scale, bias, ws, bs, act),
            off, 2.0 * r * d * fs,
            nbytes(x, scale, bias, *ws, *bs) + r * fs * x.element_size())
    (wd, bd), (wu, bu) = p["adaptor"]
    args = (x, scale, bias, wd, bd, wu, bu)
    calls["adaptor"] = (
        lambda: adaptor_fused(*args), lambda: lp.adaptor_reference(*args),
        lambda: F.linear(squared_relu(F.linear(fp32_layer_norm(
            x, scale, bias), wd, bd)), wu, bu) + x,
        4.0 * r * d * d, nbytes(*args) + nbytes(x))
    return calls


def check_layer_norm(results):
    """Kernel 13 against its plain version at the encoder's LayerNorm
    shapes (R = 8 x 964, D = 768; HUGE's R = 8 x 1220, D = 1280), fp32 and
    bf16; two launches bit-identical; the Function's fp32 gradient."""
    for rows, dim in ENC_SHAPES:
        _check_layer_norm(results, rows, dim)


def _check_layer_norm(results, rows, dim):
    import torch
    import torch.nn.functional as F
    from prismer_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    entry = results["fused_layer_norm"]
    x32, scale, bias = _ln_case(gen, rows, dim)
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        fp32 = dtype == torch.float32
        got = ln.fused_layer_norm(x, scale, bias)
        again = ln.fused_layer_norm(x, scale, bias)
        want = ln.fp32_layer_norm(x, scale, bias)
        torch.cuda.synchronize()
        err, ok = _ln_errors(got, want, "fused_layer_norm", fp32)
        repeat = torch.equal(got, again)
        finite = bool(torch.isfinite(got.float()).all())
        ms = graph_ms(lambda: ln.fused_layer_norm(x, scale, bias))
        plain = graph_ms(lambda: ln.fp32_layer_norm(x, scale, bias))
        log(f"  fused_layer_norm R={rows} D={dim} {str(dtype)[6:]}: "
            f"max|err| {err:.3g}, within tolerance {ok}, repeat "
            f"bit-identical {repeat}, finite {finite}; kernel {ms:.4f} ms "
            f"plain {plain:.4f} ms (graph replay)")
        expect(ok and repeat and finite,
               f"fused_layer_norm {dtype} out of tolerance")
        if fp32:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        else:
            bound = {}
            set_bound(bound, nbytes(x, scale, bias, got), 8.0 * rows * dim,
                      torch.float32)
            sb, bb = scale.to(dtype), bias.to(dtype)
            lib = graph_ms(lambda: F.layer_norm(x, (dim,), sb, bb))
            log(f"    bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}),"
                f" F.layer_norm {lib:.4f} ms")
            if dim == ENC_DIM:
                entry.update(ms=ms, plain_ms=plain, library_ms=lib, **bound)
    _grad_check("fused_layer_norm", ln.fused_layer_norm,
                ln.fp32_layer_norm, (x32[:964], scale, bias))
    torch.cuda.empty_cache()


# ln_proj.cu's kernels: the bf16 row statistics, ln_proj and adaptor
# kernels (gated on spills and on HGMMA in their SASS) and the fp32 FMA
# kernels (listed, not gated)
LN_KERNELS = 5
LN_UNGATED = ("ln_proj_f32_kernel", "adaptor_f32_kernel")
LN_HGMMA = ("ln_proj_kernel", "adaptor_kernel")
# widths that no TMA store takes: q/k/v-like outputs of 200 and 77 columns
# at D 192 (neither a multiple of 128), written by plain stores
LN_ODD = (300, 192, (200, 77))


def _outs(o):
    return o if isinstance(o, (tuple, list)) else (o,)


def _check_ln_call(name, fn, call, x, label, timed, fp32):
    """One of `ln_proj_calls`' entries against its plain version: errors,
    two launches bit-identical, finite; timed: graph and events ms of the
    kernel, graph ms of the plain version and of the flag-off composition,
    the bound. Returns the record."""
    import torch
    kernel, plain, off, flops, n_bytes = call
    got, again, want = _outs(kernel()), _outs(kernel()), _outs(plain())
    torch.cuda.synchronize()
    errs = [_ln_errors(g, w, name, fp32, x.double().abs() + w.double().abs()
                       if name == "adaptor_fused" else None)
            for g, w in zip(got, want)]
    rec = {"fn": fn, "shape": label, "max_abs_err": max(e for e, _ in errs),
           "ok": all(o for _, o in errs),
           "repeat": all(torch.equal(g, a) for g, a in zip(got, again)),
           "finite": all(bool(torch.isfinite(g.float()).all()) for g in got)}
    del got, again, want
    msg = (f"  {name} {fn} {label} {str(x.dtype)[6:]}: max|err| "
           f"{rec['max_abs_err']:.3g}, within tolerance {rec['ok']}, repeat "
           f"bit-identical {rec['repeat']}, finite {rec['finite']}")
    if timed:
        rec.update(ms=graph_ms(kernel), events_ms=cuda_ms(kernel),
                   plain_ms=graph_ms(plain, iters=5), library_ms=graph_ms(off))
        set_bound(rec, n_bytes, flops, x.dtype)
        msg += (f"; kernel {rec['ms']:.4f} ms graph / {rec['events_ms']:.4f} "
                f"events, {flops / rec['ms'] / 1e9:.1f} TFLOP/s; plain "
                f"{rec['plain_ms']:.4f}; flag-off composition (yardstick) "
                f"{rec['library_ms']:.4f}; bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']})")
    log(msg)
    expect(rec["ok"] and rec["repeat"] and rec["finite"],
           f"{name} {fn} {label} {x.dtype} out of tolerance")
    return rec


def _check_ln_kernels(results, name, fns):
    """`fns` of `ln_proj_calls` through the port's wrappers at LN_SHAPES
    (bf16 timed, fp32 checked), at LN_RAGGED and at LN_ODD (both dtypes).
    The entry's times are BASE's first function's (graph replays), its
    `library_ms` the flag-off composition's (a yardstick, not one call of
    the same function); every timed shape's record is kept under
    `shapes`."""
    import torch
    from prismer_tpu_torch.ops import ln_proj as lp

    entry = results[name]
    entry["library_is"] = ("yardstick: the flag-off composition "
                           "(fp32_layer_norm, F.linear per output, the "
                           "activation or residual)")
    entry.setdefault("shapes", [])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    cases = [(label, r, d, True) for label, r, d in LN_SHAPES]
    cases += [("ragged", r, ENC_DIM, False) for r in LN_RAGGED]
    cases += [(f"odd F={LN_ODD[2]}", LN_ODD[0],
               LN_ODD[1], False)]
    for label, r, d, timed in cases:
        case = ln_proj_case(gen, r, d)
        if label.startswith("odd"):
            case["qkv"] = [_dense(gen, f, d) for f in LN_ODD[2]]
        for dtype in (torch.bfloat16, torch.float32):
            calls = ln_proj_calls(case, dtype, lp.ln_proj, lp.adaptor_fused)
            fp32 = dtype == torch.float32
            for fn in fns:
                rec = _check_ln_call(name, fn, calls[fn], case["x"].to(dtype),
                                     f"{label} R={r} D={d}", timed and not fp32,
                                     fp32)
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           rec["max_abs_err"])
                if "ms" in rec:
                    entry["shapes"].append(rec)
                    if label == "BASE" and fn == fns[0]:
                        entry.update({k: rec[k] for k in (
                            "ms", "events_ms", "plain_ms", "library_ms",
                            "bound_ms", "bound_by")})
            del calls
        del case
        torch.cuda.empty_cache()


def check_ln_proj(results):
    """Kernel 14 against its plain version: q/k/v (3 x D) and c_fc (4 D) +
    quick_gelu at LN_SHAPES (BASE, LARGE, HUGE at batch 8; bf16 timed by
    graph replay and events beside the plain version, the flag-off
    composition and the bound; fp32 checked), at LN_RAGGED and LN_ODD;
    two launches bit-identical; the Function's fp32 gradient."""
    import torch
    from prismer_tpu_torch.ops import ln_proj as lp

    _check_ln_kernels(results, "ln_proj", ("q/k/v", "c_fc"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x32, scale, bias = _ln_case(gen, 964, ENC_DIM)
    w32, b32 = _dense(gen, 4 * ENC_DIM, ENC_DIM)
    _grad_check("ln_proj c_fc", lambda x, s, b, w, bb: lp.ln_proj(
        x, s, b, [w], [bb], "quick_gelu"), lambda x, s, b, w, bb:
        lp.ln_proj_reference(x, s, b, [w], [bb], "quick_gelu"),
        (x32, scale, bias, w32, b32))
    torch.cuda.empty_cache()


def check_adaptor_fused(results):
    """Kernel 15 against its plain version at LN_SHAPES (bf16 timed as for
    check_ln_proj), LN_RAGGED and LN_ODD's width, fp32 and bf16; two
    launches bit-identical; the Function's fp32 gradient; then ptxas -v of
    ln_proj.cu (fails on a spill in a bf16 kernel or a bf16 product kernel
    without HGMMA)."""
    import torch
    from prismer_tpu_torch.ops import ln_proj as lp

    _check_ln_kernels(results, "adaptor_fused", ("adaptor",))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    x32, scale, bias = _ln_case(gen, 964, ENC_DIM)
    (wd32, bd32), (wu32, bu32) = (_dense(gen, ENC_DIM, ENC_DIM),
                                  _dense(gen, ENC_DIM, ENC_DIM))
    _grad_check("adaptor_fused", lp.adaptor_fused, lp.adaptor_reference,
                (x32, scale, bias, wd32, bd32, wu32, bu32))
    torch.cuda.empty_cache()
    report_ptxas("ln_proj", LN_KERNELS, LN_UNGATED, LN_HGMMA)


# ---------------------------------------------------------------------------
# the LARGE / HUGE shapes, the int8 fused step (4b) and kernels 11 / 12
# ---------------------------------------------------------------------------

# the served sizes, as the JAX package's bench served them: (label, registry
# model, input resolution)
SIZES = (("LARGE", "prismer_large", 336), ("HUGE", "prismer_huge", 480))


def model_config(model: str, res: int, dtype: str):
    from prismer_tpu_torch.config import CAPTION_EXPERTS, build_prismer_config
    return build_prismer_config({
        "experts": CAPTION_EXPERTS, "image_resolution": res,
        "prismer_model": model, "freeze": "freeze_vision", "dtype": dtype})


def expert_tokens(v) -> int:
    """The label stems' token count: each stem rescales the 224 px label
    map by 4 / patch (id maps) or 16 / patch and strides by 4 or 16."""
    from prismer_tpu_torch.models.vit import ID_MAP_EXPERTS
    n = 0
    for exp, _ in v.experts:
        if exp != "rgb":
            f = 4 if exp in ID_MAP_EXPERTS else 16
            n += (int(v.label_resolution * f / v.patch_size) // f) ** 2
    return n


def wide_attention():
    """(name, B, Lq, Lk, H, Dh) at batch 8 of the LARGE / HUGE encoders'
    attention whose head dim Prismer-BASE does not have: HUGE's trunk (80)
    and both resamplers (128, 160)."""
    out = []
    for label, model, res in SIZES:
        v = model_config(model, res, "bfloat16").vision
        trunk = v.rgb_tokens + v.resampler_latents
        if v.width // v.heads != 64:
            out.append((f"{label} trunk", 8, trunk, trunk, v.heads,
                        v.width // v.heads))
        out.append((f"{label} resampler", 8, v.resampler_latents,
                    expert_tokens(v) + v.resampler_latents,
                    v.resampler_heads, v.width // v.resampler_heads))
    return out


def _quantized(case, heads):
    """The case's cross K/V as int8 with their (NLc, B, H) scales."""
    import torch
    from prismer_tpu_torch.ops.fused_decode import quantize_kv
    out = {}
    for name in ("cross_k", "cross_v"):
        pairs = [quantize_kv(x, heads) for x in case[name]]
        out[name] = torch.stack([q for q, _ in pairs])
        out[name + "s"] = torch.stack([s for _, s in pairs])
    return out


def check_fused_decode_huge(results):
    """Kernels 4 and 4b at the HUGE decoder (D 1024, 24 + 1 layers, F 4096,
    L 1220, N = 8 x 3), fp32 and bf16, with and without the reorder: the
    int8 step against the plain int8 step on the same quantized inputs, by
    the tolerances of the BASE check above."""
    import torch
    from prismer_tpu_torch.ops import fused_decode as fd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    dims = HUGE_DEC
    kw = dict(heads=dims["heads"], eps=1e-5)
    case = _fused_case(gen, 8, 3, 10, dims)
    index, fb = case.pop("index"), case.pop("flat_beam")
    q8 = _quantized(case, dims["heads"])
    e4, e4b = results["fused_decode_step"], results["fused_decode_step_int8"]
    for quant in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            x = {k: (v.to(dtype) if v.is_floating_point() and k != "b_all"
                     else v) for k, v in case.items()}
            if quant:
                x.update(q8)
            fp32 = dtype == torch.float32
            x32 = {k: (v.float() if v.is_floating_point() else v)
                   for k, v in x.items()}
            x32["b_all"] = x["b_all"].to(dtype).float()

            def args(t, perm):  # fresh caches for each call
                return ((t["hidden0"], t["w_all"], t["b_all"],
                         t["self_k"].clone(), t["self_v"].clone(),
                         t["key_mask"], t["cross_k"], t["cross_v"], index,
                         fb if perm else None),
                        dict(kw, cross_ks=t.get("cross_ks"),
                             cross_vs=t.get("cross_vs")))

            k = dict(kw, cross_ks=x.get("cross_ks"),
                     cross_vs=x.get("cross_vs"))
            for perm in (False, True):
                a, _ = args(x, perm)
                got = fd.fused_decode_step(*a, **k)
                want = fd.fused_decode_step_reference(*a, **k)
                torch.cuda.synchronize()
                errs = [(g.float() - w.float()).abs().max().item()
                        for g, w in zip(got[:3], want[:3])]
                finite = all(bool(torch.isfinite(g.float()).all())
                             for g in got[:3])
                line = (f"  fused_decode_step HUGE N=24 L={dims['l_enc']} "
                        f"{str(dtype)[6:]} int8={quant} perm={perm}: max|err| "
                        f"hidden/k_new/v_new "
                        f"{'/'.join(f'{e:.3g}' for e in errs)}")
                if fp32:
                    ok = max(errs) <= TOL_FUSED_FP32
                    line += f" (tol max abs {TOL_FUSED_FP32})"
                else:
                    a32, k32 = args(x32, perm)
                    exact = fd.fused_decode_step_reference(*a32, **k32)
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
                log(line + f", finite {finite}")
                expect(ok and finite, f"fused_decode_step HUGE {dtype} "
                       f"int8={quant} perm={perm} out of tolerance")
                entry = e4b if quant else e4
                if fp32:
                    entry["max_abs_err"] = max(entry["max_abs_err"], *errs)
                if not fp32 and perm:
                    rec = time_fused_step("HUGE N=24", entry, x, index, fb,
                                          kw, dims["nlc"], 5, True)
                    ms, plain = rec["events_ms"], rec["plain_ms"]
                    n, d = x["hidden0"].shape
                    flops = 2.0 * n * x["w_all"].numel() + 4.0 * n * d * (
                        dims["t"] * (dims["nlc"] + 1)
                        + dims["l_enc"] * dims["nlc"])
                    bound = {}
                    set_bound(bound, nbytes(
                        x["hidden0"], x["w_all"], x["b_all"], x["self_k"],
                        x["self_v"], x["key_mask"], x["cross_k"],
                        x["cross_v"], x.get("cross_ks"), x.get("cross_vs"),
                        fb, *got), flops, dtype)
                    log(f"    bf16 HUGE N=24 int8={quant} with reorder: kernel "
                        f"{ms:.4f} ms plain {plain:.4f} ms bound "
                        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
                    if quant:
                        e4b.update(ms=ms, plain_ms=plain, **bound)
                del got, want
            del x, x32
            torch.cuda.empty_cache()
    del case, q8
    torch.cuda.empty_cache()
    report_ptxas("fused_decode", FUSED_KERNELS, ungated=FUSED_UNGATED)


# the grouped decode cross-attention's model shapes (kernels 11, 12) as
# (label, B, H, L, Q, cross layers): BASE's decode step (Q = 3 beams) and
# prefill (3 beams x 4 prompt tokens), LARGE's (ViT-L/14 at 336 px) and
# HUGE's decode steps. Cold timing cycles through one (k, v) set per cross
# layer, as the decode loop reads another layer's cache on every call
DECODE_ATTENTION_SHAPES = (("BASE", 8, 12, 964, 3, 12),
                           ("BASE", 8, 12, 964, 12, 12),
                           ("LARGE", 8, 16, 640, 3, 24),
                           ("HUGE", 8, 16, 1220, 3, 24))
# the split's edge shapes at B 2, H 3 as (L, Q): blocks of a cluster with
# no keys or one (L 1, 7), a 64-key tile across a block's range end (L 65,
# 513), one pass of 16 query rows (Q 1, 16) and several (17, 64)
DECODE_ATTENTION_EDGES = tuple((l, nq) for l in (1, 7, 65, 513)
                               for nq in (1, 16, 17, 64))


def cycle_ms(fn, sets) -> float:
    """graph_ms of calls that cycle through the argument tuples `sets`, two
    rounds: each call reads another set, so once the sets outgrow the 50
    MB L2 every call reads its operands from HBM (L2-cold)."""
    it = iter(sets * 8)
    return graph_ms(lambda: fn(*next(it)), iters=2 * len(sets))


def check_decode_attention(results):
    """Kernels 11 (mode cross_t) and 12 (mode decode) against their plain
    versions, fp32 and bf16, two launches bit-identical: the split's edge
    shapes (DECODE_ATTENTION_EDGES), BASE's prefill with the head-split
    views of a projected (B, L, D) K/V read through their strides (and
    `tma_layout_ok` refusing a view TMA cannot read), and the model shapes
    (DECODE_ATTENTION_SHAPES). At each bf16 model shape: kernel, plain and
    SDPA ms, warm (graph_ms on one input set, L2-resident) and cold
    (cycle_ms over one set per cross layer), and the byte bound. Then
    ptxas -v's registers and spills of the kernel's 11 instantiations."""
    import torch
    import torch.nn.functional as F
    from prismer_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    entries = {"cross_t": results["grouped_cross_attention"],
               "decode": results["grouped_decode_attention"]}

    def held(q, k, v, what):
        """Both modes against the plain version; the largest error."""
        fp32 = q.dtype == torch.float32
        tol = TOL_FP32 if fp32 else TOL_BF16_OUT
        worst = 0.0
        for mode, entry in entries.items():
            got = da.grouped_cross_attention(q, k, v, mode)
            again = da.grouped_cross_attention(q, k, v, mode)
            want = da.grouped_attention_reference(q, k, v, mode)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            repeat = torch.equal(got, again)
            finite = bool(torch.isfinite(got.float()).all())
            expect(err <= tol and repeat and finite and got.shape == q.shape,
                   f"grouped attention {mode} {what} {q.dtype}: max|err| "
                   f"{err:.3g} (tol {tol}), repeat bit-identical {repeat}, "
                   f"finite {finite}")
            if fp32:
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
            worst = max(worst, err)
        return worst

    for l, nq in DECODE_ATTENTION_EDGES:
        q32, k32, v32 = (torch.randn(2, 3, n, 64, generator=gen,
                                     device="cuda") for n in (nq, l, l))
        errs = [held(q32.to(dt), k32.to(dt), v32.to(dt), f"L={l} Q={nq}")
                for dt in (torch.float32, torch.bfloat16)]
        log(f"  grouped attention edge B=2 H=3 L={l} Q={nq}: max|err| fp32 "
            f"{errs[0]:.3g} (tol {TOL_FP32}), bf16 {errs[1]:.3g} (tol "
            f"{TOL_BF16_OUT}), both modes, repeat bit-identical")

    # the prefill's head-split views: (B, L, D) projections, uncopied
    b, h, l, nq = 8, 12, 964, 12
    q32 = torch.randn(b, h, nq, 64, generator=gen, device="cuda")
    kv32 = torch.randn(2, b, l, h * 64, generator=gen, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        k, v = (x.to(dt).view(b, l, h, 64).permute(0, 2, 1, 3) for x in kv32)
        expect(not k.is_contiguous() and da.tma_layout_ok(k),
               "head-split view layout")
        err = held(q32.to(dt), k, v, "head-split views")
        log(f"  grouped attention BASE prefill on head-split views (strides "
            f"{k.stride()}) {str(dt)[6:]}: max|err| {err:.3g}, both modes")
    # rows 8 bytes past 16-byte alignment: the wrapper raises on such a view
    odd = torch.randn(b, h, l, 72, device="cuda", dtype=torch.bfloat16)[
        ..., 4:68]
    expect(not da.tma_layout_ok(odd), "a K/V view TMA cannot read passes")
    del q32, kv32, odd

    for label, b, h, l, nq, layers in DECODE_ATTENTION_SHAPES:
        q32, k32, v32 = (torch.randn(b, h, n, 64, generator=gen,
                                     device="cuda") for n in (nq, l, l))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            err = held(q, k, v, f"{label} Q={nq}")
            log(f"  grouped attention {label} B={b} H={h} L={l} Q={nq} "
                f"{str(dtype)[6:]}: max|err| {err:.3g} (tol "
                f"{TOL_FP32 if dtype == torch.float32 else TOL_BF16_OUT}), "
                "both modes, repeat bit-identical")
            if dtype == torch.float32:
                continue
            sets = [(q, k, v)] + [
                (q, *(torch.randn(b, h, l, 64, generator=gen, device="cuda",
                                  dtype=dtype) for _ in range(2)))
                for _ in range(layers - 1)]
            bound = {}
            set_bound(bound, nbytes(q, k, v, q),   # the output is q's size
                      4.0 * b * h * nq * l * 64, dtype)
            lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            lib_cold = cycle_ms(F.scaled_dot_product_attention, sets)
            for mode, entry in entries.items():
                def kernel(q, k, v):
                    return da.grouped_cross_attention(q, k, v, mode)

                def plain(q, k, v):
                    return da.grouped_attention_reference(q, k, v, mode)

                warm, cold = graph_ms(lambda: kernel(q, k, v)), cycle_ms(
                    kernel, sets)
                p_warm, p_cold = graph_ms(lambda: plain(q, k, v)), cycle_ms(
                    plain, sets)
                log(f"    bf16 {mode}: kernel warm {warm:.4f} ms cold "
                    f"{cold:.4f} ms ({cold / bound['bound_ms']:.2f}x "
                    f"the bound {bound['bound_ms']:.4f} ms, "
                    f"{bound['bound_by']}); plain warm {p_warm:.4f} cold "
                    f"{p_cold:.4f} ms; F.scaled_dot_product_attention warm "
                    f"{lib:.4f} cold {lib_cold:.4f} ms ({layers} sets of "
                    f"{nbytes(k, v) / 1e6:.1f} MB cycled)")
                if label == "BASE" and nq == 3:
                    entry.update(ms=cold, plain_ms=p_cold,
                                 library_ms=lib_cold, **bound)
            del sets
        del q32, k32, v32
        torch.cuda.empty_cache()
    report_ptxas("decode_attention", 11)


def _decode_parity(label, setup):
    """fp32 Prismer-BASE at batch 2: the decoder on the card against the
    same decoder on the CPU (the card's encode copied over), under the
    switches `setup(flag)` sets (flag False restores the defaults). The
    step logits of init_cache + one decode step to TOL_DECODE_LOGITS rel
    L2, and beam search's ids equal. Returns the card's launch counts."""
    import torch
    from prismer_tpu_torch.data.device import materialize_experts
    from prismer_tpu_torch.models.generation import beam_search
    from prismer_tpu_torch.models.prismer import (build_random_prismer,
                                                  prepare_serving_variables)

    cfg = slice_config("float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    raw = raw_batch(cfg, 2, gen, "cuda")
    prompt = torch.tensor([[0, 250, 1000, 7], [0, 31, 1, 1]],
                          dtype=torch.int32)
    mask = (prompt != 1).to(torch.int32)         # row 1 right-padded
    kw = dict(num_beams=3, max_length=20, min_length=8, eos_token_id=2,
              pad_token_id=1)
    out, counts = {}, None
    for dev in ("cuda", "cpu"):
        model = build_random_prismer(cfg, SEED, dev)
        with torch.no_grad():
            if dev == "cuda":
                enc = model.encode(materialize_experts(raw, torch.float32))
            pr, pm = prompt.to(dev), mask.to(dev)
            e = enc.to(dev)
            wrap = wrappers()
            setup(True)
            try:
                for fn in wrap.values():
                    fn.launches = 0
                serving = prepare_serving_variables(model)
                ids3, m3 = pr.repeat_interleave(3, 0), pm.repeat_interleave(3, 0)
                logits, cache = model.init_cache(
                    ids3, m3, e, 20, 3, packed=serving)
                key_mask = torch.zeros((6, 20), dtype=torch.int32, device=dev)
                key_mask[:, :4] = m3
                key_mask[:, 4] = 1             # the step's own column
                step, _ = model.decode_step(
                    torch.full((6,), 500, dtype=torch.int32, device=dev), 4,
                    m3.sum(1).to(torch.int32) + 2, key_mask, cache, 3)
                seqs, scores = beam_search(model, e, pr, pm, serving=serving,
                                           **kw)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    counts = {n: fn.launches for n, fn in wrap.items()}
            finally:
                setup(False)
        out[dev] = (logits.cpu(), step.cpu(), seqs.cpu(), scores.cpu())
        del model, cache
    e0 = rel_l2(out["cuda"][0], out["cpu"][0])
    e1 = rel_l2(out["cuda"][1], out["cpu"][1])
    same = torch.equal(out["cuda"][2], out["cpu"][2])
    err = (out["cuda"][3] - out["cpu"][3]).abs().max().item()
    log(f"  {label}, fp32 batch 2, card vs CPU: prefill logits rel L2 "
        f"{e0:.3g}, step logits rel L2 {e1:.3g} (tol {TOL_DECODE_LOGITS}); "
        f"ids identical {same}, max|score diff| {err:.3g} (tol "
        f"{TOL_SCORES}); card ids {out['cuda'][2].tolist()}")
    expect(e0 <= TOL_DECODE_LOGITS and e1 <= TOL_DECODE_LOGITS,
           f"{label}: logits card vs CPU")
    expect(same and err <= TOL_SCORES, f"{label}: ids or scores differ")
    torch.cuda.empty_cache()
    return counts


def phase_decode_cross_parity(results):
    """The per-layer decode path with set_decode_cross("kernel"): kernel 11
    in the prefill and every step, card against the CPU's plain version."""
    from prismer_tpu_torch.models import roberta

    def setup(on):
        roberta.set_fused_decode("off" if on else "auto")
        roberta.set_decode_cross("kernel" if on else "matmul")

    counts = _decode_parity("set_decode_cross(\"kernel\")", setup)
    n = counts["grouped_cross_attention"]
    steps = counts["beam_update"]
    log(f"  card launches: grouped_cross_attention {n} over init_cache + 1 "
        f"step + a beam search of {steps} steps (12 layers each)")
    expect(n == 12 * (1 + 1 + 1 + steps) and counts["fused_decode_step"] == 0,
           f"decode cross parity launches {counts}")


def phase_kv_quant_parity(results):
    """The fused decode path with set_kv_quant("int8"): kernel 4b, card
    against the CPU's plain version of the int8 step."""
    from prismer_tpu_torch.models import roberta

    def setup(on):
        roberta.set_fused_decode("on" if on else "auto")
        roberta.set_kv_quant("int8" if on else "off")

    counts = _decode_parity("set_kv_quant(\"int8\")", setup)
    log(f"  card launches: fused_decode_step int8 "
        f"{counts['fused_decode_step_int8']}, bf16-or-fp32 cross "
        f"{counts['fused_decode_step']}")
    expect(counts["fused_decode_step_int8"] == 1 + counts["beam_update"]
           and counts["fused_decode_step"] == 0,
           f"kv quant parity launches {counts}")


def phase_serve_decode_cross(results, card: str, profile: bool):
    """bf16 Prismer-BASE requests at batch 8 on the per-layer decode path
    with set_decode_cross("kernel"): 12 launches of kernel 11 in the
    prefill and in every step; then the same requests with it off. With
    `profile`, one request's encode / beam-search split and profile under
    each setting."""
    import torch
    from prismer_tpu_torch.models import roberta
    from prismer_tpu_torch.models.caption import build_generate_fn

    cfg, model, requests = serve_setup()
    wrap = wrappers()
    reqs = requests[:3]
    timed = {}
    roberta.set_fused_decode("off")
    try:
        generate = build_generate_fn(model)
        for mode in ("kernel", "matmul", "kernel", "matmul"):
            roberta.set_decode_cross(mode)
            generate(*requests[0])     # warm-up
            torch.cuda.synchronize()
            for fn in wrap.values():
                fn.launches = 0
            outs, times = timed_requests(generate, reqs)
            counts = {name: fn.launches for name, fn in wrap.items()}
            timed.setdefault(mode, []).extend(times)
            check_requests(reqs, outs, cfg.decoder.vocab_size)
            n, steps = counts["grouped_cross_attention"], counts["beam_update"]
            want = 12 * (len(reqs) + steps) if mode == "kernel" else 0
            expect(n == want and counts["fused_decode_step"] == 0,
                   f"decode cross {mode} launches {counts}")
            if mode == "kernel":
                results["grouped_cross_attention"]["launches"] = n
                log(f"  set_decode_cross(\"kernel\"): grouped_cross_attention "
                    f"{n} launches over {len(reqs)} requests of {steps} "
                    f"steps in all ({n / len(reqs):.0f} per request)")
        if profile:   # the beam search's device time under each switch
            for mode in ("kernel", "matmul"):
                roberta.set_decode_cross(mode)
                label = f"per-layer decode, decode cross {mode}, batch 8"
                split_request(model, requests[0], label, card)
                profile_request(generate, requests[0], label, card)
    finally:
        roberta.set_decode_cross("matmul")
        roberta.set_fused_decode("auto")
    for mode, times in timed.items():
        log(f"  per-layer decode, decode cross {mode}, batch 8: "
            f"{sum(times) / len(times):.1f} ms/request "
            f"({' '.join(f'{t:.1f}' for t in times)}) ({card})")


def _serve_size(results, card, label, model_name, res, quant_modes, profile):
    """bf16 captioning requests at batch 8 (beam 3, max 20) on a registry
    model through build_generate_fn, fused decode, for each kv-quant mode:
    ms per request, peak memory, the encode / beam-search split, every
    serving kernel launched."""
    import torch
    from prismer_tpu_torch.models import roberta
    from prismer_tpu_torch.models.caption import build_generate_fn
    from prismer_tpu_torch.models.prismer import build_random_prismer

    cfg = model_config(model_name, res, "bfloat16")
    t0 = time.perf_counter()
    model = build_random_prismer(cfg, SEED, "cuda")
    log(f"  built bf16 Prismer-{label} ({cfg.vision.name}, {res} px, "
        f"{cfg.vision.rgb_tokens + cfg.vision.resampler_latents} encoder "
        f"tokens) in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    reqs = []
    for _ in range(3):
        prompt = torch.randint(4, 1000, (8, 4), generator=gen, device="cuda",
                               dtype=torch.int32)
        reqs.append((raw_batch(cfg, 8, gen, "cuda"), prompt,
                     torch.ones_like(prompt)))
    generate = build_generate_fn(model)
    wrap = wrappers()
    for quant in quant_modes:
        roberta.set_kv_quant(quant)
        try:
            generate(*reqs[0])         # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in wrap.values():
                fn.launches = 0
            outs, times = timed_requests(generate, reqs)
            counts = {name: fn.launches for name, fn in wrap.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            if profile or label == "HUGE":
                split_request(model, reqs[0], f"Prismer-{label} kv quant "
                              f"{quant}, batch 8", card)
            if profile:
                profile_request(generate, reqs[0], f"Prismer-{label} kv quant "
                                f"{quant}, batch 8", card)
        finally:
            roberta.set_kv_quant("off")
        check_requests(reqs, outs, cfg.decoder.vocab_size)
        step_kernel = ("fused_decode_step_int8" if quant == "int8"
                       else "fused_decode_step")
        path = ("flash_attention_packed", "flash_attention", "beam_update",
                step_kernel, "lm_topk")
        expect(all(counts[n] > 0 for n in path)
               and counts[step_kernel] == counts["beam_update"],
               f"Prismer-{label} kv quant {quant} launches {counts}")
        if quant == "int8":
            results["fused_decode_step_int8"]["launches"] = counts[step_kernel]
        ms = sum(times) / len(times)
        log(f"  Prismer-{label} kv quant {quant}, batch 8: {ms:.1f} "
            f"ms/request ({' '.join(f'{t:.1f}' for t in times)}), "
            f"{8000.0 / ms:.1f} images/s, peak memory {peak:.2f} GiB; "
            f"launches " + ", ".join(f"{n}={counts[n]}" for n in path)
            + f" ({card})")
    del model, generate
    torch.cuda.empty_cache()


def phase_serve_large(results, card: str, profile: bool):
    """Prismer-LARGE (ViT-L/14 at 336 px), six experts, bf16, batch 8."""
    _serve_size(results, card, "LARGE", "prismer_large", 336, ("off",),
                profile)


def phase_serve_huge(results, card: str, profile: bool):
    """Prismer-HUGE (ViT-H/14 at 480 px, 1220 encoder tokens), six experts,
    bf16, batch 8, int8 cross K/V off and then on."""
    _serve_size(results, card, "HUGE", "prismer_huge", 480, ("off", "int8"),
                profile)


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
    """torch.profiler over one request (or train step, or forward): wall
    ms, device-busy ms (the sum of device op times, user annotations such
    as the optimizer's range left out; one stream, so they do not overlap)
    and device ops. Returns (busy ms, {op name: (ms, count)})."""
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
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    by_name = {}
    for e in ops:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"  profile {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {1 - busy / wall:.2f}), {len(ops)} device ops "
        f"({card})")
    for name, (t, c) in top:
        log(f"    {t:8.2f} ms {c:6d}x {name[:90]}")
    # the attention kernels, all instantiations
    for kind in ("flash_fwd", "flash_bwd", "grouped_attn"):
        hits = [tc for name, tc in by_name.items() if kind in name]
        if hits:
            log(f"    {kind}*: {sum(t for t, _ in hits):.2f} ms over "
                f"{sum(c for _, c in hits)} launches")
    return busy, by_name


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
    for name in SERVE_KERNELS:
        results[name]["launches"] = wrap[name].launches

    check_requests(reqs, outs, cfg.decoder.vocab_size)
    expect(torch.equal(outs[0], outs[1]), "same request gave different ids")
    for name in SERVE_KERNELS:
        expect(results[name]["launches"] > 0,
               f"{name} never launched on the path")
    b8 = times[1:4]
    ms8 = sum(b8) / len(b8)
    log(f"  4 requests (+1 repeat, +2 warm-up) of (8, 8, 8, 5) images: "
        f"shapes, prompts, id range and determinism ok; sample ids "
        f"{outs[1][0].tolist()}")
    log(f"  launches on the path: " + ", ".join(
        f"{n}={results[n]['launches']}" for n in SERVE_KERNELS))
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
# phases 7 and 8: the encoder's fused LayerNorm path (set_ln_proj(True))
# ---------------------------------------------------------------------------

def phase_ln_proj_parity(results):
    """fp32 Prismer-BASE encode at batch 2 with set_ln_proj(True): card
    (kernels 14 and 15) against the CPU (plain versions), same seeded
    weights and inputs; the card's encode launches ln_proj 24 times and
    adaptor_fused 12 times."""
    import torch
    from prismer_tpu_torch.data.device import materialize_experts
    from prismer_tpu_torch.models import layers
    from prismer_tpu_torch.models.prismer import build_random_prismer
    from prismer_tpu_torch.ops import ln_proj as lp

    cfg = slice_config("float32")
    raw = raw_batch(cfg, 2, torch.Generator().manual_seed(SEED + 16), "cpu")
    raw_gpu = {k: ({n: t.cuda() for n, t in v.items()}
                   if isinstance(v, dict) else v.cuda())
               for k, v in raw.items()}
    enc, counts = {}, {}
    for dev, r in (("cpu", raw), ("cuda", raw_gpu)):
        model = build_random_prismer(cfg, SEED, dev)
        x = materialize_experts(r, torch.float32)
        for flag in (True, False):
            lp.ln_proj.launches = lp.adaptor_fused.launches = 0
            layers.set_ln_proj(flag)
            try:
                t0 = time.perf_counter()
                with torch.no_grad():
                    enc[dev, flag] = model.encode(x).cpu()
            finally:
                layers.set_ln_proj(False)
            counts[dev, flag] = (lp.ln_proj.launches,
                                 lp.adaptor_fused.launches)
            log(f"  {dev} set_ln_proj({flag}): encode {tuple(enc[dev, flag].shape)}"
                f" in {time.perf_counter() - t0:.2f} s, launches ln_proj / "
                f"adaptor_fused {counts[dev, flag]}")
        del model, x
    rel = rel_l2(enc["cuda", True], enc["cpu", True])
    rel_off = rel_l2(enc["cuda", True], enc["cuda", False])
    log(f"  fp32 encode with the flag on, card vs CPU: rel L2 {rel:.3g} (tol "
        f"{TOL_LNPROJ_ENCODE}); card flag on vs off: rel L2 {rel_off:.3g}")
    want = (LN_PROJ_PER_ENCODE["ln_proj"], LN_PROJ_PER_ENCODE["adaptor_fused"])
    expect(counts["cuda", True] == want and counts["cpu", True] == (0, 0)
           and counts["cuda", False] == (0, 0), f"launches {counts}")
    expect(bool(torch.isfinite(enc["cuda", True]).all()), "encode not finite")
    expect(rel <= TOL_LNPROJ_ENCODE and rel_off <= TOL_LNPROJ_ENCODE,
           "fp32 encode with set_ln_proj(True) out of tolerance")
    torch.cuda.empty_cache()


def phase_serve_ln_proj(results, card: str, profile: bool):
    """bf16 captioning requests through build_generate_fn with
    set_ln_proj(True) (fused decode on): each request launches ln_proj 24
    times and adaptor_fused 12 times. Then the same requests with the flag
    off, and the batch-8 encode's ms with the flag off and on in turns."""
    import torch
    from prismer_tpu_torch.data.device import materialize_experts
    from prismer_tpu_torch.models import layers
    from prismer_tpu_torch.models.caption import build_generate_fn
    from prismer_tpu_torch.models.prismer import compute_dtype

    cfg, model, requests = serve_setup()
    generate = build_generate_fn(model)
    wrap = wrappers()
    reqs = [requests[0]] + requests
    layers.set_ln_proj(True)
    try:
        generate(*requests[0])         # warm-up, one per batch shape
        generate(*requests[3])
        torch.cuda.synchronize()
        for fn in wrap.values():
            fn.launches = 0
        outs, times = timed_requests(generate, reqs)
        counts = {name: fn.launches for name, fn in wrap.items()}
        if profile:
            split_request(model, requests[0], "set_ln_proj(True), batch 8",
                          card)
            profile_request(generate, requests[0],
                            "set_ln_proj(True), batch 8", card)
    finally:
        layers.set_ln_proj(False)
    for name in ("fused_layer_norm", "ln_proj", "adaptor_fused"):
        results[name]["launches"] = counts[name]
    n = len(reqs)
    check_requests(reqs, outs, cfg.decoder.vocab_size)
    expect(torch.equal(outs[0], outs[1]), "same request gave different ids")
    expect(counts["ln_proj"] == LN_PROJ_PER_ENCODE["ln_proj"] * n
           and counts["adaptor_fused"] == LN_PROJ_PER_ENCODE["adaptor_fused"]
           * n and counts["fused_layer_norm"] == 0
           and all(counts[k] > 0 for k in SERVE_KERNELS),
           f"set_ln_proj(True) path launches {counts}")
    off_outs, off_times = timed_requests(generate, reqs)
    same = sum(torch.equal(a, b) for a, b in zip(outs, off_outs))
    x = materialize_experts(requests[0][0], compute_dtype(cfg))
    enc = {False: [], True: []}
    for flag in (False, True, True, False):
        layers.set_ln_proj(flag)
        try:
            with torch.no_grad():
                enc[flag].append(cuda_ms(lambda: model.encode(x), iters=5,
                                         warmup=1))
        finally:
            layers.set_ln_proj(False)
    log(f"  launches on the path: " + ", ".join(
        f"{k}={counts[k]}" for k in ("ln_proj", "adaptor_fused",
                                     "fused_layer_norm"))
        + f" over {n} requests; " + ", ".join(
        f"{k}={counts[k]}" for k in SERVE_KERNELS))
    for label, ts in (("set_ln_proj(True)", times), ("flag off", off_times)):
        ms8 = sum(ts[1:4]) / 3
        log(f"  {label}, batch 8: {ms8:.1f} ms/request "
            f"({' '.join(f'{t:.1f}' for t in ts[1:4])}), {8000.0 / ms8:.1f}"
            f" images/s; batch 5: {ts[4]:.1f} ms/request ({card})")
    log(f"  ids equal to the flag-off run in {same} of {n} requests (bf16: "
        f"the two paths round at different points)")
    log(f"  batch-8 bf16 encode (CUDA events, 5 after 1 warm-up, in turns "
        f"off/on/on/off): flag off {' '.join(f'{t:.2f}' for t in enc[False])}"
        f" ms, flag on {' '.join(f'{t:.2f}' for t in enc[True])} ms ({card})")


# ---------------------------------------------------------------------------
# VQA and answer ranking, and the reference-checkpoint converter
# ---------------------------------------------------------------------------

# rank inference as bench.py's vqa_latency runs it: a 3,000-answer list of
# 4 tokens, k_test 16, questions of 12 tokens
RANK_ANSWERS, RANK_ANSWER_LEN, RANK_Q_LEN, RANK_K = 3000, 4, 12, 16
RANK_REQUESTS = 30
RANK_PATH = ("flash_attention_packed", "flash_attention")
# pass-2 scores, fp32 card vs CPU: a mean of ~4 label-smoothed log-probs
# over the 50,265-word vocabulary, summed in another order (max abs)
TOL_RANK_SCORES = 1e-4
VQA_GEN_BATCH = 8
VQA_GEN_REQUESTS = 6


def vqa_answers(gen, vocab: int, device):
    """(ids, mask) (3000, 4) int32: answers '<a> <b> <c> </s>' whose first
    tokens take 600 values (about five answers each), and answers 1000-1199
    share 8 of them, so pass 1's top 16 is made of ties."""
    import torch
    n = RANK_ANSWERS
    pool = torch.randint(4, vocab, (600,), generator=gen)
    first = pool[torch.randint(0, 600, (n,), generator=gen)]
    first[1000:1200] = pool[torch.arange(200) % 8]
    ids = torch.randint(4, vocab, (n, RANK_ANSWER_LEN), generator=gen)
    ids[:, 0] = first
    ids[:, -1] = 2
    ids = ids.to(torch.int32)
    return ids.to(device), torch.ones_like(ids).to(device)


def vqa_questions(gen, lengths, device):
    """(ids, mask) (B, 1 + max(lengths)) int32: BOS and that many question
    tokens, right-padded."""
    import torch
    q = 1 + max(lengths)
    ids = torch.ones((len(lengths), q), dtype=torch.int32)
    ids[:, 0] = 0
    for r, n in enumerate(lengths):
        ids[r, 1:1 + n] = torch.randint(4, 1000, (n,), generator=gen,
                                        dtype=torch.int32)
    mask = (torch.arange(q)[None, :] <= torch.tensor(lengths)[:, None])
    return ids.to(device), mask.to(torch.int32).to(device)


def phase_vqa_parity(results):
    """fp32 Prismer-BASE at batch 2: the encoder states of the card copied
    to the CPU; rank_answers (pass 1 candidates, pass 2 scores, the choice)
    and VQA beam search over right-padded questions of 9 and 12 tokens on
    the card (kernels; fused decode) against the CPU (plain; per layer)."""
    import torch
    from prismer_tpu_torch.data.device import materialize_experts
    from prismer_tpu_torch.models.generation import (rank_candidates,
                                                     score_candidates)
    from prismer_tpu_torch.models.prismer import (build_random_prismer,
                                                  prepare_serving_variables)
    from prismer_tpu_torch.models.vqa import beam_answers

    cfg = slice_config("float32")
    models = {"cpu": build_random_prismer(cfg, SEED, "cpu"),
              "cuda": build_random_prismer(cfg, SEED, "cuda")}
    gen = torch.Generator().manual_seed(SEED + 7)
    raw = raw_batch(cfg, 2, torch.Generator(device="cuda").manual_seed(
        SEED + 7), "cuda")
    with torch.no_grad():
        enc_gpu = models["cuda"].encode(materialize_experts(raw,
                                                            torch.float32))
    ans = vqa_answers(gen, cfg.decoder.vocab_size, "cpu")
    q = vqa_questions(gen, (12, 9), "cpu")
    out = {}
    for dev, model in models.items():
        enc = enc_gpu.to(dev)
        a = [x.to(dev) for x in ans]
        qq = [x.to(dev) for x in q]
        t0 = time.perf_counter()
        cand = rank_candidates(model, enc, *qq, a[0][:, 0], RANK_K)
        scores = score_candidates(model, enc, *qq, *a, cand)
        best = cand.gather(1, scores.argmax(dim=1)[:, None])[:, 0]
        ids = beam_answers(model, enc, *qq,
                           prepare_serving_variables(model))
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = [x.cpu() for x in (cand, scores, best, ids)]
        log(f"  {dev}: rank + generate {time.perf_counter() - t0:.2f} s")
    (c_c, s_c, b_c, i_c), (c_g, s_g, b_g, i_g) = out["cpu"], out["cuda"]
    err = (s_g - s_c).abs().max().item()
    firsts = ans[0][c_g.long(), 0]
    ties = sum(len(set(r.tolist())) < RANK_K for r in firsts)
    log(f"  pass 1 candidates equal {torch.equal(c_g, c_c)} (rows with tied "
        f"first tokens: {ties} of 2), chosen {b_g.tolist()} vs "
        f"{b_c.tolist()}, pass-2 max|score diff| {err:.3g} (tol "
        f"{TOL_RANK_SCORES})")
    log(f"  generate ids (fused on the card, per layer on the CPU) equal "
        f"{torch.equal(i_g, i_c)}: {i_g[:, q[0].shape[1]:].tolist()}")
    expect(ties == 2, "the answers' tied first tokens missed pass 1's top k")
    expect(torch.equal(c_g, c_c), "pass 1 candidates differ")
    expect(err <= TOL_RANK_SCORES, "pass 2 scores differ")
    expect(torch.equal(b_g, b_c), "chosen answers differ")
    expect(tuple(i_g.shape) == (2, q[0].shape[1] + 10)
           and torch.equal(i_g, i_c), "VQA generate ids differ")
    del models, enc_gpu
    torch.cuda.empty_cache()


def _percentiles(times):
    qs = statistics.quantiles(times, n=10)
    return (f"p50 {statistics.median(times):.2f}, p90 {qs[8]:.2f}, p10 "
            f"{qs[0]:.2f}, min {min(times):.2f}, max {max(times):.2f}")


def split_rank(model, req, label: str, card: str) -> None:
    """CUDA-event ms of one rank request's encode (expert gather
    included), pass 1 and pass 2."""
    import torch
    from prismer_tpu_torch.data.device import materialize_experts
    from prismer_tpu_torch.models.generation import (rank_candidates,
                                                     score_candidates)
    from prismer_tpu_torch.models.prismer import compute_dtype

    raw, q, q_mask, a_ids, a_mask = req
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.no_grad():
        ev[0].record()
        enc = model.encode(materialize_experts(raw, compute_dtype(model.cfg)))
        ev[1].record()
        cand = rank_candidates(model, enc, q, q_mask, a_ids[:, 0], RANK_K)
        ev[2].record()
        score_candidates(model, enc, q, q_mask, a_ids, a_mask, cand)
        ev[3].record()
    torch.cuda.synchronize()
    log(f"  split {label}: encode {ev[0].elapsed_time(ev[1]):.1f} ms, pass 1 "
        f"{ev[1].elapsed_time(ev[2]):.1f} ms, pass 2 "
        f"{ev[2].elapsed_time(ev[3]):.1f} ms ({card})")


def phase_serve_vqa_rank(results, card: str, profile: bool):
    """bf16 rank requests through build_rank_fn (bench.py's vqa_latency
    shapes, the questions right-padded to 12 tokens) at batch 1 and 32: ms per request over 30 requests each (CUDA
    events after a synchronize), kernels 1 and 2 the only ones launched,
    their launches per request, peak memory; `profile`: one request of
    each batch under torch.profiler."""
    import torch
    from prismer_tpu_torch.models.caption import build_rank_fn

    cfg, model, _ = serve_setup()
    vocab = cfg.decoder.vocab_size
    rank = build_rank_fn(model, k_test=RANK_K)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    a_ids = torch.randint(4, vocab, (RANK_ANSWERS, RANK_ANSWER_LEN),
                          generator=gen, device="cuda", dtype=torch.int32)
    a_mask = torch.ones_like(a_ids)
    wrap = wrappers()
    for batch in (1, 32):
        reqs = []
        for i in range(3):
            # questions of 5-12 tokens right-padded to 12 (pad id 1); the
            # first row of request i holds 12 - 3i, so batch 1 pads too
            lens = torch.randint(5, RANK_Q_LEN + 1, (batch,), generator=gen,
                                 device="cuda")
            lens[0] = RANK_Q_LEN - 3 * i
            q_mask = (torch.arange(RANK_Q_LEN, device="cuda")[None]
                      < lens[:, None]).to(torch.int32)
            q = torch.randint(4, 1000, (batch, RANK_Q_LEN), generator=gen,
                              device="cuda", dtype=torch.int32)
            q = torch.where(q_mask.bool(), q, torch.ones_like(q))
            reqs.append((raw_batch(cfg, batch, gen, "cuda"), q, q_mask,
                         a_ids, a_mask))
        first = rank(*reqs[0])            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrap.values():
            fn.launches = 0
        outs, times = timed_requests(
            rank, [reqs[i % 3] for i in range(RANK_REQUESTS)])
        counts = {name: fn.launches for name, fn in wrap.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        per = {n: counts[n] / RANK_REQUESTS for n in RANK_PATH}
        for n in RANK_PATH:
            results[n].setdefault("launches_per_request", {})[
                f"vqa_rank_b{batch}"] = per[n]
        expect(all(o.shape == (batch,) and o.dtype == torch.int64
                   and bool(((o >= 0) & (o < RANK_ANSWERS)).all())
                   for o in outs), f"batch {batch}: rank output")
        expect(torch.equal(outs[0], first), "same request gave another "
               "answer")
        expect(all(counts[n] > 0 for n in RANK_PATH) and all(
            c == 0 for n, c in counts.items() if n not in RANK_PATH),
            f"rank path launches {counts}")
        log(f"  rank batch {batch}, k {RANK_K}, {RANK_ANSWERS} answers: "
            f"ms/request over {RANK_REQUESTS}: {_percentiles(times)}; "
            f"{batch * 1000.0 / statistics.median(times):.1f} images/s; "
            f"peak memory {peak:.2f} GiB; launches per request "
            + ", ".join(f"{n}={per[n]:g}" for n in RANK_PATH) + f" ({card})")
        if profile:
            split_rank(model, reqs[0], f"rank, batch {batch}", card)
            profile_request(rank, reqs[0], f"rank, batch {batch}", card)


def phase_serve_vqa_generate(results, card: str, profile: bool):
    """bf16 VQA generation through build_answer_fn (beam 3, q_len + 10,
    length penalty -1) at batch 8 over right-padded questions of 5-12
    tokens, fused decode on (the default): every serving kernel launches;
    then generate_answers once through the synthetic tokenizer's text."""
    import torch
    from prismer_tpu_torch.models.vqa import (build_answer_fn,
                                              generate_answers)
    from prismer_tpu_torch.tokenizer import synthetic_tokenizer

    cfg, model, _ = serve_setup()
    answer = build_answer_fn(model)
    gen = torch.Generator().manual_seed(SEED + 9)
    cgen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    reqs = []
    for _ in range(3):
        lengths = torch.randint(5, 13, (VQA_GEN_BATCH,), generator=gen)
        reqs.append((raw_batch(cfg, VQA_GEN_BATCH, cgen, "cuda"),
                     *vqa_questions(gen, lengths.tolist(), "cuda")))
    answer(*reqs[0])                       # warm-up
    torch.cuda.synchronize()
    wrap = wrappers()
    for fn in wrap.values():
        fn.launches = 0
    outs, times = timed_requests(
        answer, [reqs[i % 3] for i in range(VQA_GEN_REQUESTS)])
    counts = {name: fn.launches for name, fn in wrap.items()}
    for n in SERVE_KERNELS:
        results[n].setdefault("launches_per_request", {})[
            f"vqa_generate_b{VQA_GEN_BATCH}"] = counts[n] / VQA_GEN_REQUESTS
    for (_, ids, _), seqs in zip(reqs * 2, outs):
        q = ids.shape[1]
        expect(tuple(seqs.shape) == (VQA_GEN_BATCH, q + 10)
               and torch.equal(seqs[:, :q], ids.long())
               and bool(((seqs >= 0) & (seqs < cfg.decoder.vocab_size))
                        .all()), "VQA generate output")
    expect(torch.equal(outs[0], outs[3]), "same request gave other ids")
    expect(all(counts[n] > 0 for n in SERVE_KERNELS),
           f"VQA generate launches {counts}")
    tok = synthetic_tokenizer()
    words = ["is", "the", "cat", "on", "a", "mat", "red", "what", "there"]
    questions = [" ".join(words[(i + j) % 9] for j in range(2 + i % 3))
                 for i in range(VQA_GEN_BATCH)]
    texts = generate_answers(answer, reqs[0][0], tok, questions)
    expect(len(texts) == VQA_GEN_BATCH and all(isinstance(t, str)
                                               for t in texts),
           "generate_answers output")
    log(f"  generate batch {VQA_GEN_BATCH}, questions of 5-12 tokens: "
        f"ms/request over {VQA_GEN_REQUESTS}: "
        + " ".join(f"{t:.1f}" for t in times) + f", mean "
        f"{sum(times) / len(times):.1f}; launches per request "
        + ", ".join(f"{n}={counts[n] / VQA_GEN_REQUESTS:g}"
                    for n in SERVE_KERNELS) + f" ({card})")
    log(f"  generate_answers through the synthetic tokenizer: {texts[:2]}")
    if profile:
        profile_request(answer, reqs[0], f"VQA generate, batch "
                        f"{VQA_GEN_BATCH}", card)


def synthetic_reference_checkpoint(cfg, seed: int, pretrain_res: int = 224):
    """A reference 'pytorch_model.bin' state dict (expert_encoder.*,
    text_decoder.* in the reference's layout) for `cfg`, the positional
    embedding at pretrain_res, from numpy: weights N(0, 1/fan_in), LN and
    BN scales near 1, small biases, N(0, 0.02) embedding tables."""
    import numpy as np
    import torch
    g = np.random.default_rng(seed)
    sd = {}

    def put(key, shape, std, mean=0.0):
        a = g.standard_normal(shape, dtype=np.float32) * np.float32(std)
        sd[key] = torch.from_numpy(a + np.float32(mean))

    def lin(key, out_d, in_d):
        put(f"{key}.weight", (out_d, in_d), in_d ** -0.5)
        put(f"{key}.bias", (out_d,), 0.02)

    def ln(key, d):
        put(f"{key}.weight", (d,), 0.02, 1.0)
        put(f"{key}.bias", (d,), 0.02)

    def conv(key, o, i, k):
        put(f"{key}.weight", (o, i, k, k), (i * k * k) ** -0.5)

    v, c = cfg.vision, cfg.decoder
    w, d = v.width, c.hidden_size
    grid = pretrain_res // v.patch_size
    put("expert_encoder.positional_embedding", (grid * grid, w), w ** -0.5)
    ln("expert_encoder.ln_pre", w)
    ln("expert_encoder.ln_post", w)
    conv("expert_encoder.conv1.rgb", w, 3, v.patch_size)
    put("expert_encoder.instance_embedding", (v.num_instance_slots, w),
        w ** -0.5)
    widths = (w // 8, w // 4, w // 2, w)
    for exp, ch in v.experts:
        if exp == "rgb":
            continue
        p, prev = f"expert_encoder.conv1.{exp}", ch
        for j, (ci, bi) in enumerate(zip((1, 4, 7, 10), (2, 5, 8, 11))):
            conv(f"{p}.{ci}", widths[j], prev, 3)
            ln(f"{p}.{bi}", widths[j])
            put(f"{p}.{bi}.running_mean", (widths[j],), 0.02)
            put(f"{p}.{bi}.running_var", (widths[j],), 0.02, 1.0)
            sd[f"{p}.{bi}.num_batches_tracked"] = torch.tensor(0)
            prev = widths[j]
        conv(f"{p}.13", w, w, 1)
    for i in range(v.layers):
        p = f"expert_encoder.transformer.resblocks.{i}"
        put(f"{p}.0.attn.in_proj_weight", (3 * w, w), w ** -0.5)
        put(f"{p}.0.attn.in_proj_bias", (3 * w,), 0.02)
        lin(f"{p}.0.attn.out_proj", w, w)
        ln(f"{p}.0.ln_1", w)
        ln(f"{p}.0.ln_2", w)
        lin(f"{p}.0.mlp.c_fc", 4 * w, w)
        lin(f"{p}.0.mlp.c_proj", w, 4 * w)
        lin(f"{p}.1.adaptor.down_proj", w, w)
        lin(f"{p}.1.adaptor.up_proj", w, w)
        ln(f"{p}.1.adaptor_ln", w)
    put("expert_encoder.resampler.latents", (v.resampler_latents, w),
        w ** -0.5)
    for i in range(v.resampler_layers):
        p = f"expert_encoder.resampler.perceiver_blocks.{i}"
        put(f"{p}.attn.in_proj_weight", (3 * w, w), w ** -0.5)
        put(f"{p}.attn.in_proj_bias", (3 * w,), 0.02)
        lin(f"{p}.attn.out_proj", w, w)
        for nm in ("ln_1", "ln_2", "ln_ff"):
            ln(f"{p}.{nm}", w)
        lin(f"{p}.mlp.c_fc", 4 * w, w)
        lin(f"{p}.mlp.c_proj", w, 4 * w)
    emb = "text_decoder.roberta.embeddings"
    for nm, rows in (("word_embeddings", c.vocab_size),
                     ("position_embeddings", c.max_position_embeddings),
                     ("token_type_embeddings", c.type_vocab_size)):
        put(f"{emb}.{nm}.weight", (rows, d), 0.02)
    ln(f"{emb}.LayerNorm", d)

    def block(p):
        for nm in ("query", "key", "value"):
            lin(f"{p}.attention.self.{nm}", d, d)
        lin(f"{p}.attention.output.dense", d, d)
        ln(f"{p}.attention.output.LayerNorm", d)
        lin(f"{p}.intermediate.dense", c.intermediate_size, d)
        lin(f"{p}.output.dense", d, c.intermediate_size)
        ln(f"{p}.output.LayerNorm", d)

    for i in range(c.num_hidden_layers):
        p = f"text_decoder.roberta.encoder.layer.{i}"
        block(f"{p}.0")
        for nm in ("query", "key", "value"):
            lin(f"{p}.1.self.{nm}", d,
                d if nm == "query" else c.vision_hidden_size)
        lin(f"{p}.1.output.dense", d, d)
        ln(f"{p}.1.output.LayerNorm", d)
        lin(f"{p}.2.adaptor.down_proj", d, d)
        lin(f"{p}.2.adaptor.up_proj", d, d)
        ln(f"{p}.2.adaptor_ln", d)
    block("text_decoder.roberta.encoder.output_layer")
    lin("text_decoder.lm_head.dense", d, d)
    ln("text_decoder.lm_head.layer_norm", d)
    put("text_decoder.lm_head.bias", (c.vocab_size,), 0.02)
    return sd


def phase_convert(results, card: str):
    """A synthetic reference checkpoint of Prismer-BASE (six experts,
    pretrained at 224 px) written with torch.save, converted by
    `python -m prismer_tpu_torch.convert.cli --kind prismer` for 480 px,
    loaded into a bf16 port model on the card, which serves one caption
    request through build_generate_fn."""
    import shutil
    import torch
    from prismer_tpu_torch.convert.cli import load_npz_into
    from prismer_tpu_torch.models.caption import build_generate_fn
    from prismer_tpu_torch.models.prismer import Prismer

    cfg = slice_config("bfloat16")
    work = ROOT / "build" / "convert_smoke"
    work.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        sd = synthetic_reference_checkpoint(cfg, SEED)
        src, dst = work / "pytorch_model.bin", work / "prismer_base.npz"
        torch.save(sd, src)
        n_sd = sum(t.numel() for t in sd.values())
        del sd
        made = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "prismer_tpu_torch.convert.cli",
             "--kind", "prismer", "--src", str(src), "--dst", str(dst),
             "--prismer_model", "prismer_base", "--experts", "full",
             "--image_resolution", "480"], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        conv_s = time.perf_counter() - t0
        expect(res.returncode == 0, f"convert CLI failed: {res.stderr[-2000:]}")
        model = Prismer(cfg, device="meta").to_empty(device="cuda").eval()
        t0 = time.perf_counter()
        total, missing = load_npz_into(model, str(dst))
        load_s = time.perf_counter() - t0
        sizes = (src.stat().st_size, dst.stat().st_size)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  checkpoint of {n_sd / 1e6:.1f} M values ({sizes[0] / 2**30:.2f} "
        f"GiB) made in {made:.1f} s; CLI conversion {conv_s:.1f} s "
        f"(process included) to {sizes[1] / 2**30:.2f} GiB .npz; loaded in "
        f"{load_s:.1f} s; uncovered leaves {len(missing)} of {total}: "
        f"{missing[:5]}")
    expect(not missing, f"uncovered leaves {missing[:10]}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    raw = raw_batch(cfg, 2, gen, "cuda")
    prompt = torch.tensor([[0, 250, 1000, 7]] * 2, dtype=torch.int32,
                          device="cuda")
    seqs = build_generate_fn(model)(raw, prompt, torch.ones_like(prompt))
    torch.cuda.synchronize()
    check_requests([(raw, prompt)], [seqs], cfg.decoder.vocab_size)
    log(f"  caption from the converted weights: {seqs[0].tolist()} ({card})")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 9 and 10: the caption fine-tune step
# ---------------------------------------------------------------------------

# the train phase's lr: the slice's 5e-5, raised to 1e-4 for this check only
# so that ten AdamW steps on one batch show the loss falling
TRAIN_LR = 1e-4
TRAIN_STEPS = 10
TRAIN_WD = 0.05
PROMPT_LEN = 4
# one fp32 train step, card (kernels) vs CPU (plain versions): loss rel,
# gradient rel L2 per trainable leaf, BatchNorm running statistics. The
# label stems' Conv_i / bn_i feed ReLUs: where two fp32 forwards that agree
# to ~2e-6 put a pre-activation on either side of zero, ReLU's derivative
# flips for that element, and a handful of the ~5 M elements at 224 px
# moves those leaves' gradients by up to a few 1e-3 (measured on an H100
# 80GB HBM3 at 700 W: 4e-4 to 3e-3 with cuDNN on or off, stem outputs
# 2e-6 apart)
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-3
TOL_TRAIN_GRAD_RELU = 1e-2
TOL_TRAIN_STATS = 1e-5
RELU_FED = re.compile(r"\.conv1_\w+\.(Conv|bn)_\d\.")
SERVE_KERNELS = ("flash_attention_packed", "flash_attention", "beam_update",
                 "fused_decode_step", "lm_topk")
TRAIN_KERNELS = ("flash_attention_packed", "flash_attention",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "ce_stats", "ce_grads")


def caption_batch(cfg, batch: int, gen, device):
    """A ragged caption batch as the fine-tune sees it: <s>, random tokens,
    </s>, at most 30 tokens, right-padded to the longest; the pads and the
    4-token prompt are -100 in the targets."""
    import torch
    from prismer_tpu_torch.models.caption import (CAPTION_MAX_TOKENS,
                                                  caption_targets)
    dec = cfg.decoder
    lens = [CAPTION_MAX_TOKENS - (7 * i) % 20 for i in range(batch)]
    width = max(lens)
    ids = torch.randint(4, dec.vocab_size, (batch, width), generator=gen,
                        device=device, dtype=torch.int32)
    pos = torch.arange(width, device=device)[None]
    n = torch.tensor(lens, device=device)[:, None]
    ids[:, 0] = 0
    ids = torch.where(pos == n - 1, dec.eos_token_id, ids)
    mask = (pos < n).to(torch.int32)
    ids = torch.where(mask.bool(), ids, dec.pad_token_id).to(torch.int32)
    return {"experts": raw_batch(cfg, batch, gen, device), "input_ids": ids,
            "attention_mask": mask,
            "targets": caption_targets(ids, mask, PROMPT_LEN,
                                       dec.pad_token_id)}


def train_state(cfg, device, lr: float):
    """Random Prismer (seeded) with its fp32 masters, freeze_vision, AdamW
    under the per-step cosine over TRAIN_STEPS steps."""
    from prismer_tpu_torch.models.prismer import (build_random_prismer,
                                                  random_masters)
    from prismer_tpu_torch.train import TrainState
    from prismer_tpu_torch.train.schedules import per_step_cosine

    model = build_random_prismer(cfg, SEED, device)
    return TrainState.create(model, per_step_cosine(lr, 0.0, TRAIN_STEPS, 1),
                             TRAIN_WD, "freeze_vision",
                             random_masters(model, SEED), seed=SEED)


def grad_rel(name: str, got, want, want_all) -> float:
    """rel L2 of a gradient; a key projection's bias (zero in exact
    arithmetic: softmax ignores a per-query constant) against the norm of
    its weight's gradient."""
    scale = want.double().norm()
    if name.endswith(("key.bias", "k_proj.bias")):
        scale = want_all[name[:-len("bias")] + "weight"].double().norm()
    return ((got.double() - want.double()).norm()
            / scale.clamp_min(1e-30)).item()


def phase_train_parity(results):
    """One fp32 train step of Prismer-BASE at batch 2 (full depth),
    dropout 0 so both sides draw no masks: card (kernels) vs CPU (plain
    versions); the same seed gives both the same weights and slots."""
    import dataclasses

    import torch
    from prismer_tpu_torch.train import build_train_step
    from prismer_tpu_torch.train.optim import FROZEN

    cfg = slice_config("float32")
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, hidden_dropout_prob=0.0))
    batch = caption_batch(cfg, 2, torch.Generator().manual_seed(SEED + 7),
                          "cpu")
    to_gpu = lambda x: ({k: to_gpu(v) for k, v in x.items()}
                        if isinstance(x, dict) else x.cuda())
    out = {}
    for dev, b in (("cpu", batch), ("cuda", to_gpu(batch))):
        t0 = time.perf_counter()
        state = train_state(cfg, dev, 5e-5)
        model = state.model
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if state.labels[n] == FROZEN}
        state, metrics = build_train_step(model)(state, b)
        loss = float(metrics["loss"])
        grads = {n: leaf.grad.cpu() for n, leaf in state.trainable()}
        stats = {k: t.cpu() for k, t in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        still = all(torch.equal(model.get_parameter(n), t)
                    for n, t in frozen.items())
        out[dev] = (loss, grads, stats, still)
        log(f"  {dev}: one fp32 train step at batch 2 in "
            f"{time.perf_counter() - t0:.1f} s (model build included), loss "
            f"{loss:.6f}, {len(grads)} trainable leaves, {len(frozen)} frozen")
        del state, model, frozen
    (l_c, g_c, s_c, f_c), (l_g, g_g, s_g, f_g) = out["cpu"], out["cuda"]
    e_loss = abs(l_g - l_c) / abs(l_c)
    errs = {n: grad_rel(n, g_g[n], g_c[n], g_c) for n in g_c}
    relu_fed = {n for n in errs if RELU_FED.search(n)}
    worst = max(set(errs) - relu_fed, key=errs.get)
    worst_relu = max(relu_fed, key=errs.get)
    e_stats = max(((s_g[k] - s_c[k]).abs()
                   / (1.0 + s_c[k].abs())).max().item() for k in s_c)
    log(f"  fp32 train step card vs CPU: loss rel {e_loss:.3g} (tol "
        f"{TOL_TRAIN_LOSS}); gradient rel L2 max {errs[worst]:.3g} at {worst} "
        f"(tol {TOL_TRAIN_GRAD}, {len(errs) - len(relu_fed)} leaves), "
        f"{errs[worst_relu]:.3g} at {worst_relu} (tol {TOL_TRAIN_GRAD_RELU}, "
        f"{len(relu_fed)} ReLU-fed stem leaves); {len(s_c)} BatchNorm "
        f"statistics max err {e_stats:.3g} (tol {TOL_TRAIN_STATS}); frozen "
        f"leaves unchanged {f_c and f_g}")
    expect(g_c.keys() == g_g.keys() and len(g_c) > 100, "trainable leaves")
    expect(len(relu_fed) == 72, f"{len(relu_fed)} ReLU-fed stem leaves")
    expect(e_loss <= TOL_TRAIN_LOSS, "train loss card vs CPU")
    expect(errs[worst] <= TOL_TRAIN_GRAD, f"gradient of {worst} card vs CPU")
    expect(errs[worst_relu] <= TOL_TRAIN_GRAD_RELU,
           f"gradient of {worst_relu} card vs CPU")
    expect(e_stats <= TOL_TRAIN_STATS, "BatchNorm statistics card vs CPU")
    expect(f_c and f_g, "a frozen leaf changed")
    torch.cuda.empty_cache()


def timed_steps(step, state, batch, n: int):
    """(losses, CUDA-event ms) of n train steps, one after another."""
    import torch
    losses, times = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        times.append(start.elapsed_time(end))
    return losses, times


def split_train_step(state, batch, card: str) -> None:
    """CUDA-event ms of one train step's parts, the step's own calls taken
    apart: encoder forward (expert gather included), decoder forward (LM
    head and CE stats kernel included), decoder backward (CE gradients and
    attention backward), encoder backward, AdamW + master refresh."""
    import torch
    from prismer_tpu_torch.data.device import materialize_experts
    from prismer_tpu_torch.models.prismer import compute_dtype
    from prismer_tpu_torch.models.vit import draw_instance_slots
    from prismer_tpu_torch.train.step import apply_gradients

    model = state.model
    v = model.cfg.vision
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    model.zero_grad(set_to_none=True)
    state.optimizer.zero_grad(set_to_none=True)
    ev[0].record()
    experts = materialize_experts(batch["experts"], compute_dtype(model.cfg))
    slots = draw_instance_slots(v.max_instances, v.num_instance_slots,
                                state.generator)
    enc = model.encode(experts, slots, True)
    ev[1].record()
    enc_in = enc.detach().requires_grad_()
    loss = model.decode_loss(batch["input_ids"], batch["attention_mask"],
                             enc_in, batch["targets"], True,
                             state.generator).mean()
    ev[2].record()
    loss.backward()
    ev[3].record()
    enc.backward(enc_in.grad)
    ev[4].record()
    apply_gradients(state)
    ev[5].record()
    torch.cuda.synchronize()
    parts = ("encoder fwd", "decoder fwd", "decoder bwd", "encoder bwd",
             "AdamW")
    log(f"  split train step, batch {batch['input_ids'].shape[0]}: " + ", ".join(
        f"{p} {ev[i].elapsed_time(ev[i + 1]):.1f} ms"
        for i, p in enumerate(parts)) + f" ({card})")


def phase_train(results, card: str, profile: bool):
    """The fine-tune path: bf16 Prismer-BASE, full depth, freeze_vision,
    batch 4, ten AdamW steps on one ragged caption batch through
    build_train_step; then the step's time at batch 4 and at batch 16."""
    import torch
    from prismer_tpu_torch.train import build_train_step
    from prismer_tpu_torch.train.optim import FROZEN

    cfg = slice_config("bfloat16")
    state = train_state(cfg, "cuda", TRAIN_LR)
    model = state.model
    step = build_train_step(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    batch = caption_batch(cfg, 4, gen, "cuda")
    start = {n: t.clone() for n, t in state.params_fp32().items()}
    wrap = wrappers()
    for fn in wrap.values():
        fn.launches = 0
    losses, times = timed_steps(step, state, batch, TRAIN_STEPS)
    counts = {name: fn.launches for name, fn in wrap.items()}
    for name in TRAIN_KERNELS[2:]:
        results[name]["launches"] = counts[name]
    after = state.params_fp32()
    still = [n for n, l in state.labels.items()
             if l != FROZEN and torch.equal(after[n], start[n])]
    moved = [n for n, l in state.labels.items()
             if l == FROZEN and not torch.equal(after[n], start[n])]
    n_frozen = sum(l == FROZEN for l in state.labels.values())
    log(f"  bf16 batch 4, lr {TRAIN_LR}: losses "
        + " ".join(f"{x:.4f}" for x in losses))
    log(f"  launches per step: " + ", ".join(
        f"{n}={counts[n] / TRAIN_STEPS:g}" for n in TRAIN_KERNELS)
        + "; serving kernels " + ", ".join(
        f"{n}={counts[n]}" for n in SERVE_KERNELS[2:]))
    log(f"  {len(state.labels) - n_frozen} trainable leaves, {len(still)} "
        f"unmoved; {n_frozen} frozen leaves, {len(moved)} changed")
    expect(all(map(math.isfinite, losses)), "train loss not finite")
    expect(losses[-1] < losses[0], "train loss did not fall")
    expect(not still, f"trainable leaves did not move: {still[:5]}")
    expect(not moved, f"frozen leaves changed: {moved[:5]}")
    expect(all(counts[n] > 0 for n in TRAIN_KERNELS),
           f"train path launches {counts}")
    ms4 = sum(times[2:]) / len(times[2:])
    batch16 = caption_batch(cfg, 16, gen, "cuda")
    _, times16 = timed_steps(step, state, batch16, 5)
    ms16 = sum(times16[2:]) / len(times16[2:])
    _FILES["fixed_ms16"] = ms16
    log(f"  train step after 2 warm-up steps: batch 4 {ms4:.1f} ms/step "
        f"({' '.join(f'{t:.1f}' for t in times[2:])}), {4000.0 / ms4:.1f} "
        f"images/s; batch 16 {ms16:.1f} ms/step "
        f"({' '.join(f'{t:.1f}' for t in times16[2:])}), "
        f"{16000.0 / ms16:.1f} images/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({card})")
    if profile:
        split_train_step(state, batch, card)
        profile_request(lambda: step(state, batch), (), "train step, batch 4",
                        card)


# ---------------------------------------------------------------------------
# the data path from files on disk: JPEG decoding, the caption dataset and
# loader, the train step and caption evaluation fed by them
# ---------------------------------------------------------------------------

JPEG_FIXTURES = ROOT / "tests" / "data" / "jpeg"
JPEG_RUNS = 50
FILES_TRAIN, FILES_TEST = 64, 16
FILES_BATCH, FILES_EVAL_BATCH = 16, 8
FILES_STEPS = 5
FILES_PREFIX = "A picture of"
FILES_EXPERTS = ("depth", "normal", "seg_coco", "edge", "obj_detection",
                 "ocr_detection")
_FILES = {}


def host_cpu() -> str:
    """The host's CPU model as /proc/cpuinfo names it and the cores this
    process may use."""
    import os
    name = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"CPU {name}, {len(os.sched_getaffinity(0))} cores"


def big_fixtures(every_kind: bool = False):
    """The 640 x 480 JPEG fixtures, by name: the whole Huffman files that
    the data trees are made of, or with `every_kind` also the arithmetic
    twins and the cut progressive file."""
    exp = json.loads((JPEG_FIXTURES / "expected.json").read_text())["files"]
    return sorted(n for n, e in exp.items() if e["shape"] == [480, 640, 3]
                  and (every_kind or (e["kind"] == "huffman"
                                      and not e["smoothed"])))


def phase_jpeg(results, card: str):
    """The port's host JPEG decoder: built with g++ from the checkout, every
    fixture (Huffman, arithmetic-coded, lossless, progressive files cut
    short that libjpeg smooths) decoded by `native.decode_jpeg` and by the
    loader's `data.labels.read_rgb` to the sha256 Pillow gave (tests/data/
    jpeg/expected.json, written where Pillow is), then the median decode ms
    of each 640 x 480 fixture over JPEG_RUNS runs on the host's CPU: the
    Huffman files, the arithmetic twins beside their Huffman sources and
    the cut progressive file."""
    import collections
    import hashlib

    from prismer_tpu_torch import native
    from prismer_tpu_torch.data.labels import read_rgb
    t0 = time.perf_counter()
    lib = native.build()
    log(f"  built {lib.relative_to(ROOT)} with g++ in "
        f"{time.perf_counter() - t0:.1f} s")
    expected = json.loads((JPEG_FIXTURES / "expected.json").read_text())
    for name, e in sorted(expected["files"].items()):
        path = JPEG_FIXTURES / name
        for how, px in (("decode_jpeg", native.decode_jpeg(path.read_bytes())),
                        ("read_rgb", read_rgb(str(path)))):
            digest = hashlib.sha256(px.tobytes()).hexdigest()
            expect(list(px.shape) == e["shape"] and digest == e["sha256"],
                   f"{name} ({how}): {px.shape} sha256 {digest[:12]}, Pillow "
                   f"gave {e['shape']} {e['sha256'][:12]}")
    kinds = collections.Counter(e["kind"] for e in expected["files"].values())
    kinds["smoothed"] = sum(e["smoothed"] for e in expected["files"].values())
    log(f"  {len(expected['files'])} fixtures ({kinds['huffman']} Huffman, "
        f"{kinds['arithmetic']} arithmetic, {kinds['lossless']} lossless; "
        f"{kinds['smoothed']} of them smoothed) decode to the pixels of "
        f"Pillow {expected['pillow']} / libjpeg-turbo "
        f"{expected['libjpeg_turbo']} through decode_jpeg and read_rgb "
        f"(sha256 equal)")
    for name in big_fixtures(every_kind=True):
        source = expected["files"][name].get("source")
        data = (JPEG_FIXTURES / name).read_bytes()
        times = []
        for _ in range(JPEG_RUNS):
            t0 = time.perf_counter()
            native.decode_jpeg(data)
            times.append((time.perf_counter() - t0) * 1e3)
        beside = f", twin of {source}" if source else ""
        log(f"  decode {name} ({len(data)} bytes{beside}): median "
            f"{statistics.median(times):.2f} ms, min {min(times):.2f} ms over "
            f"{JPEG_RUNS} runs ({host_cpu()}; {card})")


def coco_image(split: str, image_id: int) -> str:
    return f"{split}/COCO_{split}_{image_id:012d}.jpg"


def write_label_files(label_root: Path, image: str, rng, w: int, h: int,
                      dataset: str = "vqav2"):
    """Random label maps for the six BASE experts at the image's size, as
    the generators lay them out under <label_root>/<expert>/<dataset>/:
    piecewise-constant id maps (16 px cells), smooth dense maps, an
    instance -> class .json for obj_detection and an .npz word sidecar
    (under the .pt name) for ocr_detection."""
    import os

    import numpy as np
    from prismer_tpu_torch.data import png

    def cells(hi, channels=0):
        shape = (-(-h // 16), -(-w // 16)) + ((channels,) if channels else ())
        small = rng.integers(0, hi, shape, dtype=np.uint8)
        return np.ascontiguousarray(
            small.repeat(16, 0).repeat(16, 1)[:h, :w])

    stem = os.path.splitext(image)[0]
    maps = {"depth": cells(256), "normal": cells(256, 3), "edge": cells(256),
            "seg_coco": cells(134), "obj_detection": cells(8),
            "ocr_detection": cells(4)}
    for exp, arr in maps.items():
        path = label_root / exp / dataset / f"{stem}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        png.write_png(str(path), arr)
    det = label_root / "obj_detection" / dataset / f"{stem}.json"
    det.write_text(json.dumps({str(i): int(rng.integers(0, 80))
                               for i in range(8)}))
    ocr = label_root / "ocr_detection" / dataset / f"{stem}.pt"
    with open(ocr, "wb") as f:
        np.savez(f, **{str(i): rng.normal(size=64).astype(np.float32)
                       for i in range(4)},
                 **{f"text_{i}": f"word{i}" for i in range(4)})


def check_batch(batch, size: int, res: int, train: bool) -> None:
    """The keys, shapes and dtypes of a collated caption batch."""
    import numpy as np
    ex = batch["experts"]
    want = {"rgb": ((size, res, res, 3), np.uint8),
            "depth": ((size, 224, 224, 1), np.float32),
            "normal": ((size, 224, 224, 3), np.float32),
            "edge": ((size, 224, 224, 1), np.float32)}
    expect(set(ex) == set(want) | {"seg_coco", "obj_detection",
                                   "ocr_detection"}, f"batch keys {set(ex)}")
    for k, (shape, dtype) in want.items():
        expect(ex[k].shape == shape and ex[k].dtype == dtype,
               f"{k}: {ex[k].shape} {ex[k].dtype}, want {shape} {dtype}")
    for k in ("seg_coco", "obj_detection", "ocr_detection"):
        keys = {"ids", "table"} | ({"instance"} if k == "obj_detection"
                                   else set())
        expect(set(ex[k]) == keys, f"{k} keys {set(ex[k])}")
        expect(ex[k]["ids"].shape == (size, 224, 224)
               and ex[k]["ids"].dtype == np.uint8, f"{k} ids")
        expect(ex[k]["table"].shape == (size, 256, 64)
               and ex[k]["table"].dtype == np.float32, f"{k} table")
    if train:
        expect(isinstance(batch["caption"], list)
               and len(batch["caption"]) == size, "captions")
    else:
        expect(batch["index"].shape == (size,), "indices")


def phase_data(results, card: str):
    """A COCO-Karpathy tree in a temporary directory under build/: 64
    train and 16 test records whose images are the 640 x 480 JPEG fixtures,
    label PNGs for the six experts with their sidecars, the test split's
    ground truth; `Caption(train=True)` at 480 px through the loader at
    batch 16 with 1 worker and with min(8, cores) forked workers."""
    import os
    import shutil
    import tempfile

    import numpy as np
    from prismer_tpu_torch.data import create_dataset, create_loader

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="files_", dir=ROOT / "build"))
    atexit.register(shutil.rmtree, tmp, True)
    _FILES["tree"] = tmp
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    sources = [(JPEG_FIXTURES / n).read_bytes() for n in big_fixtures()]
    words = "a man dog cat sits on the grass near red car with two".split()
    train, test, gt = [], [], {"images": [], "annotations": []}
    for i in range(FILES_TRAIN + FILES_TEST):
        is_train = i < FILES_TRAIN
        image = coco_image("train2014" if is_train else "val2014", 1000 + i)
        path = tmp / "vqav2" / image
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(sources[i % len(sources)])
        write_label_files(tmp / "labels", image, rng, 640, 480)
        caption = " ".join(rng.choice(words, int(rng.integers(5, 12))))
        if is_train:
            train.append({"image": image, "caption": caption,
                          "image_id": 1000 + i})
        else:
            test.append({"image": image, "image_id": 1000 + i})
            gt["images"].append({"id": 1000 + i})
            for j in range(5):
                gt["annotations"].append({
                    "image_id": 1000 + i, "id": 10 * i + j,
                    "caption": " ".join(rng.choice(words, 8))})
    for name, obj in (("coco_karpathy_train.json", train),
                      ("coco_karpathy_test.json", test),
                      ("coco_karpathy_test_gt.json", gt)):
        (tmp / name).write_text(json.dumps(obj))
    cfg = {"data_path": str(tmp), "label_path": str(tmp / "labels"),
           "experts": list(FILES_EXPERTS), "image_resolution": 480,
           "dataset": "coco", "prefix": FILES_PREFIX}
    train_ds, test_ds = create_dataset("caption", cfg)
    _FILES.update(cfg=cfg, train_ds=train_ds, test_ds=test_ds)
    log(f"  tree: {len(train_ds)} train + {len(test_ds)} test records from "
        f"{len(sources)} 640x480 JPEGs, 6 label PNGs + 2 sidecars each, "
        f"written in {time.perf_counter() - t0:.1f} s")
    expect(len(train_ds) == FILES_TRAIN and len(test_ds) == FILES_TEST,
           "record counts")

    cores = len(os.sched_getaffinity(0))
    for workers, n_batches in ((1, 2), (min(8, cores), FILES_TRAIN
                                        // FILES_BATCH)):
        loader = create_loader(train_ds, FILES_BATCH, num_workers=workers,
                               train=True)
        t0 = time.perf_counter()
        n = 0
        for batch in loader:
            check_batch(batch, FILES_BATCH, 480, True)
            n += 1
            if n == n_batches:
                break
        dt = time.perf_counter() - t0
        rate = n * FILES_BATCH / dt
        log(f"  Caption(train) 480 px through the loader, batch "
            f"{FILES_BATCH}, {workers} {loader.worker_type} worker(s): "
            f"{n * FILES_BATCH} records in {dt:.2f} s = {rate:.1f} records/s "
            f"({rate / workers:.1f} per worker; the first batch's start-up "
            f"included; {host_cpu()}; {card})")
    _FILES["workers"] = min(8, cores)


def file_batch(batch, tokenizer, prompt_len: int, pad_id: int):
    """A loader batch as the train step takes it, tokenized as
    cli/train_caption.py's prepare_train_batch does."""
    import torch
    from prismer_tpu_torch.data import experts_to_device
    from prismer_tpu_torch.models.caption import caption_targets
    enc = tokenizer(batch["caption"], padding="longest", truncation=True,
                    max_length=30)
    ids = torch.from_numpy(enc.input_ids)
    mask = torch.from_numpy(enc.attention_mask)
    targets = caption_targets(ids, mask, prompt_len, pad_id)
    return {"experts": experts_to_device(batch["experts"], "cuda"),
            "input_ids": ids.cuda(), "attention_mask": mask.cuda(),
            "targets": targets.cuda()}


def busy_window(run) -> tuple:
    """(wall ms, device-busy ms) of `run()` under torch.profiler: the sum of
    the device ops' times on the one stream, as profile_request counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    return wall, sum(e.time_range.elapsed_us() for e in ops) / 1e3


def phase_train_from_files(results, card: str):
    """Five bf16 steps of the BASE train step at batch 16 fed by the
    loader over the tree (min(8, cores) forked workers; the fifth batch
    opens the second epoch), the first a warm-up; the other four under torch.profiler: ms/step, images/s and
    the device's idle share; then four steps on one fixed batch (the last
    one read) measured the same way, beside phase "train"'s batch-16
    figure. Every training kernel must launch in the file-fed steps."""
    import torch
    from prismer_tpu_torch.train import build_train_step

    cfg = slice_config("bfloat16")
    state = train_state(cfg, "cuda", TRAIN_LR)
    step = build_train_step(state.model)
    run = file_fed_steps(cfg, state, step)
    counts, file_losses = run["counts"], run["losses"]
    wall, busy = run["wall"], run["busy"]
    fixed = run["last"]

    def steps(n):
        for _ in range(n):
            step(state, fixed)

    fwall, fbusy = busy_window(lambda: steps(FILES_STEPS - 1))
    n = FILES_STEPS - 1
    log(f"  bf16 BASE batch {FILES_BATCH} fed from files: losses "
        + " ".join(f"{x:.4f}" for x in file_losses)
        + "; launches " + ", ".join(f"{k}={v}" for k, v in counts.items()))
    log(f"  steps 2-{FILES_STEPS} from the loader: {wall / n:.1f} ms/step, "
        f"{FILES_BATCH * 1000.0 * n / wall:.1f} images/s, device busy "
        f"{busy / n:.1f} ms/step, idle share {1 - busy / wall:.3f}; the same "
        f"steps on one fixed batch: {fwall / n:.1f} ms/step, "
        f"{FILES_BATCH * 1000.0 * n / fwall:.1f} images/s, idle share "
        f"{1 - fbusy / fwall:.3f}; phase \"train\" batch 16: "
        f"{_FILES.get('fixed_ms16', float('nan')):.1f} ms/step (CUDA events) "
        f"({_FILES['workers']} loader workers; {host_cpu()}; {card})")
    expect(all(map(math.isfinite, file_losses)), "train loss not finite")
    expect(all(counts[k] > 0 for k in TRAIN_KERNELS),
           f"train-from-files launches {counts}")
    state.model.eval()
    _FILES["model"] = state.model
    del state, run, fixed
    torch.cuda.empty_cache()


def file_fed_steps(cfg, state, step) -> dict:
    """FILES_STEPS train steps fed by the loader over the "data" tree at
    batch 16 (min(8, cores) forked workers; the fifth batch opens the
    second epoch), the first a warm-up, the others under torch.profiler:
    {"losses", "wall", "busy" (ms), "counts" (launches of TRAIN_KERNELS),
    "last" (the last batch on the card)}."""
    from prismer_tpu_torch.data import create_loader
    from prismer_tpu_torch.models.caption import prefix_length
    from prismer_tpu_torch.tokenizer import synthetic_tokenizer

    tok = synthetic_tokenizer()
    prompt_len = prefix_length(tok, FILES_PREFIX)
    pad = cfg.decoder.pad_token_id
    loader = create_loader(_FILES["train_ds"], FILES_BATCH,
                           num_workers=_FILES["workers"], train=True)

    def epochs():   # 64 records make 4 batches: step 5 opens epoch 2
        while True:
            yield from loader

    batches = epochs()
    losses, last = [], {}

    def steps(n):
        for _ in range(n):
            last["batch"] = file_batch(next(batches), tok, prompt_len, pad)
            _, metrics = step(state, last["batch"])
            losses.append(metrics["loss"])

    wrap = wrappers()
    for fn in wrap.values():
        fn.launches = 0
    try:
        steps(1)
        wall, busy = busy_window(lambda: steps(FILES_STEPS - 1))
    finally:
        batches.close()
    return {"losses": [float(x) for x in losses], "wall": wall,
            "busy": busy, "last": last["batch"],
            "counts": {n: wrap[n].launches for n in TRAIN_KERNELS}}


def phase_eval_from_files(results, card: str):
    """`Caption(train=False)` through the loader at batch 8, then
    `build_generate_fn` (bf16, beam 3) on the model the file-fed steps
    left, `decode_captions` and `coco_caption_eval` against the tree's
    ground truth: 16 results with distinct image ids, finite scores, every
    serving kernel launched. The tree stays for the "cli" phases."""
    import torch
    from prismer_tpu_torch.data import create_loader, experts_to_device
    from prismer_tpu_torch.evals.coco_eval import coco_caption_eval
    from prismer_tpu_torch.models.caption import (build_generate_fn,
                                                  decode_captions,
                                                  prefix_prompt_ids)
    from prismer_tpu_torch.tokenizer import synthetic_tokenizer

    tmp = _FILES["tree"]
    try:
        model = _FILES.pop("model")
        generate = build_generate_fn(model)
        tok = synthetic_tokenizer()
        test_ds = _FILES["test_ds"]
        loader = create_loader(test_ds, FILES_EVAL_BATCH,
                               num_workers=_FILES["workers"], train=False)
        wrap = wrappers()
        for fn in wrap.values():
            fn.launches = 0
        out = []
        t0 = time.perf_counter()
        for batch in loader:
            check_batch(batch, FILES_EVAL_BATCH, 480, False)
            experts = experts_to_device(batch["experts"], "cuda")
            ids, mask = prefix_prompt_ids(tok, FILES_PREFIX,
                                          len(batch["index"]))
            seqs = generate(experts, torch.from_numpy(ids).cuda(),
                            torch.from_numpy(mask).cuda())
            captions = decode_captions(seqs.cpu(), tok, FILES_PREFIX)
            for i, cap in zip(batch["index"].tolist(), captions):
                image = test_ds.data_list[i]["image"]
                image_id = int(image.split("/")[-1][:-len(".jpg")]
                               .split("_")[-1])
                out.append({"image_id": image_id,
                            "caption": cap.capitalize() + "."})
        dt = time.perf_counter() - t0
        counts = {n: wrap[n].launches for n in SERVE_KERNELS}
        scores = coco_caption_eval(str(tmp / "coco_karpathy_test_gt.json"),
                                   out)
        log(f"  {len(out)} captions from files in {dt:.2f} s "
            f"(loader, generate, decode), e.g. {out[0]['caption']!r}; "
            f"scores " + ", ".join(f"{k} {v:.4f}" for k, v in scores.items())
            + "; launches " + ", ".join(f"{k}={v}" for k, v in counts.items())
            + f" ({card})")
        expect(len(out) == FILES_TEST
               and len({r["image_id"] for r in out}) == FILES_TEST,
               f"{len(out)} results, {len({r['image_id'] for r in out})} "
               f"distinct image ids")
        expect(all(math.isfinite(v) for v in scores.values())
               and "CIDEr" in scores, f"scores {scores}")
        expect(all(counts[k] > 0 for k in SERVE_KERNELS),
               f"eval-from-files launches {counts}")
    finally:
        _FILES.pop("model", None)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the command-line drivers (python -m prismer_tpu_torch.cli.*), called in
# process from the repo's own task YAMLs over trees made from the fixtures
# ---------------------------------------------------------------------------

CLI_DEVICE = "cuda"
CLI_MODEL = "prismer_base"      # the weight files' model, as the YAMLs name
CLI_VQA_TRAIN, CLI_VQA_TEST, CLI_VQA_ANSWERS = 32, 16, 3000
CLI_CLASSES, CLI_CLASS_NAMES = 8, 1000
CLI_DEMO_IMAGES = 16
# the pretrain driver's COCO list: the 64 train records of phase "data",
# each listed this many times, so that its run takes several timed steps
CLI_PRETRAIN_REPEAT = 4
# the step counts of the driver runs: caption 64 records / batch 4, vqa 32
# / 8, classification 8 classes x 1 shot / 2, pretrain 4 x 64 / 32
_CLI = {}


def cli_yaml(task: str, dst: Path, **values) -> str:
    """The repo's configs/<task>.yaml with the value of each named key
    (every block of a keyed file) replaced by the given YAML text, written
    to dst: the drivers read it with the port's YAML reader."""
    from prismer_tpu_torch.config import default_config_path
    text = Path(default_config_path(task)).read_text()
    for key, value in values.items():
        text, n = re.subn(rf"^(\s*){key}:.*$",
                          lambda m: f"{m.group(1)}{key}: {value}", text,
                          flags=re.M)
        expect(n > 0, f"{task}.yaml has no key {key}")
    dst.write_text(text)
    return str(dst)


def cli_answers(tok) -> list:
    """CLI_VQA_ANSWERS distinct two-character answers, each ' <Ans></s>'
    of 4 tokens under the synthetic tokenizer (no merge applies), as the
    bench's rank case has them."""
    first = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789!#$%&()*+-./:;=?@[]^_{|}~"
    second = first.lower()[:26] + first[26:]
    answers = [a + b for a in first for b in second][:CLI_VQA_ANSWERS]
    from prismer_tpu_torch.models.caption import tokenize_answer_list
    ids, _ = tokenize_answer_list(tok, answers, lowercase=False)
    expect(ids.shape == (CLI_VQA_ANSWERS, 4), f"answer ids {ids.shape}")
    return answers


def cli_setup():
    """Once, under the "data" phase's tree: the synthetic tokenizer's files,
    the seed's weights as .npz at 480 and 224 px (save_params_npz) and as a
    reference pytorch_model.bin pretrained at 224 px, and the VQA,
    ImageNet and demo trees over the same fixtures."""
    if _CLI:
        return _CLI
    import shutil

    import numpy as np
    import torch
    from prismer_tpu_torch.config import build_prismer_config
    from prismer_tpu_torch.models.prismer import Prismer, random_values
    from prismer_tpu_torch.tokenizer import synthetic_tokenizer
    from prismer_tpu_torch.train.checkpoint import save_params_npz

    tree = _FILES["tree"]
    root = tree / "cli"
    root.mkdir()
    t0 = time.perf_counter()
    tok = synthetic_tokenizer()
    tok_dir = root / "tok"
    tok_dir.mkdir()
    (tok_dir / "vocab.json").write_text(json.dumps(tok.vocab))
    merges = ["#version: 0.2"] + [
        f"{a} {b}" for (a, b), _ in sorted(tok.bpe_ranks.items(),
                                           key=lambda kv: kv[1])]
    (tok_dir / "merges.txt").write_text("\n".join(merges) + "\n")

    weights = {}
    for res in (480, 224):
        cfg = build_prismer_config({"experts": list(FILES_EXPERTS),
                                    "image_resolution": res,
                                    "prismer_model": CLI_MODEL})
        model = Prismer(cfg, device="meta")
        values = random_values(model, SEED)
        weights[res] = root / f"prismer_base_{res}.npz"
        save_params_npz(str(weights[res]), {
            n: values[n] for n, _ in model.named_parameters()})
        del values
    bin_path = root / "pytorch_model.bin"
    torch.save(synthetic_reference_checkpoint(cfg, SEED), bin_path)
    made = time.perf_counter() - t0

    rng = np.random.default_rng(SEED + 31)
    words = "a man dog cat sits on the grass near red car with two".split()
    train = json.loads((tree / "coco_karpathy_train.json").read_text())
    test = json.loads((tree / "coco_karpathy_test.json").read_text())
    answers = cli_answers(tok)
    (tree / "vqav2_train_val.json").write_text(json.dumps([
        {"dataset": "vqa", "image": r["image"],
         "question": "what is the " + " ".join(rng.choice(words, 3)) + "?",
         "answer": answers[int(rng.integers(len(answers)))],
         "weight": float(rng.choice([0.3, 0.6, 1.0]))}
        for r in train[:CLI_VQA_TRAIN]]))
    (tree / "vqav2_test.json").write_text(json.dumps([
        {"dataset": "vqa", "image": r["image"], "question_id": 5000 + i,
         "question": "is there a " + " ".join(rng.choice(words, 2)) + "?"}
        for i, r in enumerate(test[:CLI_VQA_TEST])]))
    (tree / "answer_list.json").write_text(json.dumps(answers))
    coco = root / "pretrain_coco"
    coco.mkdir()
    (coco / "vqav2").symlink_to(tree / "vqav2")
    (coco / "coco_karpathy_train.json").write_text(
        json.dumps(train * CLI_PRETRAIN_REPEAT))

    sources = [JPEG_FIXTURES / n for n in big_fixtures()]
    inet = root / "imagenet_tree"
    names = [" ".join(rng.choice(words, int(rng.integers(1, 4)))) + f" {i}"
             for i in range(CLI_CLASS_NAMES)]
    folders = [f"n{i:08d}" for i in range(CLI_CLASS_NAMES)]
    for split in ("imagenet_train", "imagenet"):
        for c in range(CLI_CLASSES):
            image = f"{folders[c]}/{folders[c]}_{split}.JPEG"
            (inet / split / folders[c]).mkdir(parents=True)
            shutil.copy(sources[c % len(sources)], inet / split / image)
            write_label_files(inet / "labels", image, rng, 640, 480, split)
    (inet / "imagenet" / "imagenet_answer.json").write_text(
        json.dumps(names))
    (inet / "imagenet" / "imagenet_class.json").write_text(
        json.dumps({f: i for i, f in enumerate(folders)}))

    demo = root / "helpers"
    (demo / "images").mkdir(parents=True)
    for r in test[:CLI_DEMO_IMAGES]:
        name = Path(r["image"]).name
        shutil.copy(tree / "vqav2" / r["image"], demo / "images" / name)
        write_label_files(demo / "labels", f"images/{name}", rng, 640, 480,
                          "helpers")
    log(f"  tokenizer files, weights (.npz at 480 / 224 px "
        f"{weights[480].stat().st_size / 2**30:.2f} / "
        f"{weights[224].stat().st_size / 2**30:.2f} GiB, .bin "
        f"{bin_path.stat().st_size / 2**30:.2f} GiB), VQA / ImageNet / "
        f"demo trees written in {made:.1f} s + "
        f"{time.perf_counter() - t0 - made:.1f} s")
    _CLI.update(root=root, tok=str(tok_dir), npz480=str(weights[480]),
                npz224=str(weights[224]), bin=str(bin_path), inet=inet,
                demo=demo, answers=answers, coco=coco)
    return _CLI


def cli_argv(cfg_path: str, exp: str, *extra) -> list:
    c = _CLI
    return ["--config", cfg_path, "--exp_name", exp, "--tokenizer_dir",
            c["tok"], "--logging_dir", str(c["root"] / "logging"),
            "--results_dir", str(c["root"] / "results"),
            "--device", CLI_DEVICE, *extra]


def run_driver(module, argv, timed=None) -> dict:
    """module.main(argv) in process, its train step and the function
    `timed` names ((owner, attribute): the eval, or the demo's
    generate_captions) timed, synchronised; the wrappers' launches counted
    over the run and apart inside each timed call, from 0."""
    import gc

    import torch
    rec = {"steps": [], "losses": [], "evals": [], "eval_counts": []}
    wrap = wrappers()
    build = getattr(module, "build_train_step", None)
    original = getattr(*timed) if timed else None

    def timed_build(model, *args):
        step = build(model, *args)

        def timed_step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            rec["steps"].append((t0, time.perf_counter()))
            rec["losses"].append(float(metrics["loss"]))
            rec["batch"] = int(batch["input_ids"].shape[0])
            return state, metrics
        return timed_step

    def timed_call(*a, **kw):
        before = {n: w.launches for n, w in wrap.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(*a, **kw)
        torch.cuda.synchronize()
        rec["evals"].append(time.perf_counter() - t0)
        rec["eval_counts"].append({n: w.launches - before[n]
                                   for n, w in wrap.items()})
        return out

    if build:
        module.build_train_step = timed_build
    if timed:
        setattr(*timed, timed_call)
    for fn in wrap.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        module.main(argv)
    finally:
        if build:
            module.build_train_step = build
        if timed:
            setattr(*timed, original)
    rec["wall"] = time.perf_counter() - t0
    total = {n: w.launches for n, w in wrap.items()}
    rec["train_counts"] = {n: total[n] - sum(c[n] for c in rec["eval_counts"])
                           for n in total}
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def report_driver(label: str, rec: dict, card: str, train: bool = True):
    """Log ms/step, images/s, eval s and the launches of one driver run;
    fail on a non-finite loss or a training kernel that did not launch."""
    parts = [f"  {label}: run {rec['wall']:.1f} s"]
    if train:
        steps = rec["steps"]
        ms = [(b - a) * 1e3 for a, b in steps[1:]]
        span = steps[-1][1] - steps[0][1]
        parts.append(
            f"{len(steps)} steps at batch {rec['batch']}, losses "
            + " ".join(f"{x:.4f}" for x in rec["losses"])
            + f"; steps 2-{len(steps)}: median {statistics.median(ms):.1f} "
            f"ms/step (min {min(ms):.1f}, max {max(ms):.1f}), "
            f"{rec['batch'] * (len(steps) - 1) / span:.1f} images/s with the "
            f"loader; train launches " + ", ".join(
                f"{k}={rec['train_counts'][k]}" for k in TRAIN_KERNELS))
        expect(all(map(math.isfinite, rec["losses"])), "loss not finite")
        expect(all(rec["train_counts"][k] > 0 for k in TRAIN_KERNELS),
               f"{label} train launches {rec['train_counts']}")
    if len(rec["evals"]) > 2:
        ms = [t * 1e3 for t in rec["evals"]]
        parts.append(f"{len(ms)} timed calls: median "
                     f"{statistics.median(ms):.1f} ms (min {min(ms):.1f}, "
                     f"max {max(ms):.1f})")
    else:
        for t, counts in zip(rec["evals"], rec["eval_counts"]):
            parts.append(f"eval {t:.2f} s, launches " + ", ".join(
                f"{k}={v}" for k, v in counts.items() if v))
    log("; ".join(parts) + f" ({card})")


def phase_cli_caption(results, card: str):
    """`train_caption.main` from configs/caption.yaml (coco; data and label
    paths set, max_epoch 1): 16 bf16 steps at batch 4, 480 px, over the
    64 train records from the seed's .npz, eval at batch 8 and CIDEr; then
    `--from_checkpoint --evaluate` on the same directory."""
    import shutil

    from prismer_tpu_torch.cli import train_caption
    c = cli_setup()
    tree = _FILES["tree"]
    cfg = cli_yaml("caption", c["root"] / "caption.yaml",
                   data_path=f"'{tree}'", label_path=f"'{tree / 'labels'}'",
                   max_epoch=1)
    argv = cli_argv(cfg, "cli", "--pretrained", c["npz480"])
    rec = run_driver(train_caption, argv, (train_caption, "evaluate"))
    report_driver("cli caption", rec, card)
    expect(len(rec["steps"]) == FILES_TRAIN // 4, f"{len(rec['steps'])} steps")
    for counts in rec["eval_counts"]:
        expect(all(counts[k] > 0 for k in SERVE_KERNELS),
               f"caption eval launches {counts}")
    out = c["root"] / "results" / "caption_results_cli_coco.json"
    res = json.loads(out.read_text())
    expect(len(res) == FILES_TEST and len({r["image_id"] for r in res})
           == FILES_TEST, f"{len(res)} caption results")
    ckpt = c["root"] / "logging" / "caption_cli" / "state"
    expect(ckpt.exists(), "no caption checkpoint")
    rec = run_driver(train_caption, argv + ["--from_checkpoint",
                                            "--evaluate"],
                     (train_caption, "evaluate"))
    report_driver("cli caption --from_checkpoint --evaluate", rec, card,
                  train=False)
    expect(not rec["steps"] and len(rec["evals"]) == 1,
           "--evaluate trained")
    shutil.rmtree(c["root"] / "logging", ignore_errors=True)


def phase_cli_vqa(results, card: str):
    """`train_vqa.main` from configs/vqa.yaml (datasets ['vqav2'], paths
    set, max_epoch 1): 4 bf16 steps at batch 8, 480 px, with per-sample
    weights, then rank eval (k_test 16) of 16 questions at the config's
    batch 32 over 3,000 answers of 4 tokens."""
    import shutil

    from prismer_tpu_torch.cli import train_vqa
    c = cli_setup()
    tree = _FILES["tree"]
    cfg = cli_yaml("vqa", c["root"] / "vqa.yaml", datasets="['vqav2']",
                   data_path=f"'{tree}'", label_path=f"'{tree / 'labels'}'",
                   max_epoch=1)
    rec = run_driver(train_vqa, cli_argv(cfg, "cli", "--pretrained",
                                         c["npz480"]),
                     (train_vqa, "evaluate"))
    report_driver("cli vqa", rec, card)
    expect(len(rec["steps"]) == CLI_VQA_TRAIN // 8, "vqa steps")
    expect(all(rec["eval_counts"][0][k] > 0 for k in RANK_PATH),
           f"vqa rank launches {rec['eval_counts']}")
    res = json.loads((c["root"] / "results" / "vqa_results_cli.json")
                     .read_text())
    expect(len(res) == CLI_VQA_TEST and all(
        r["answer"] in c["answers"] for r in res), "vqa results")
    shutil.rmtree(c["root"] / "logging", ignore_errors=True)


def phase_cli_classification(results, card: str):
    """`train_classification.main` from configs/classification.yaml (paths
    set, max_epoch 1) at 384 px from the reference-layout .bin (pretrained
    at 224 px, converted on the fly): 4 bf16 steps at batch 2 over 8
    classes x 1 shot, then rank eval of 8 images over 1,000 class names
    with k_test 32."""
    import shutil

    from prismer_tpu_torch.cli import train_classification
    c = cli_setup()
    inet = c["inet"]
    cfg = cli_yaml("classification", c["root"] / "classification.yaml",
                   data_path=f"'{inet}'", label_path=f"'{inet / 'labels'}'",
                   max_epoch=1)
    rec = run_driver(train_classification,
                     cli_argv(cfg, "cli", "--pretrained", c["bin"]),
                     (train_classification, "eval_accuracy"))
    report_driver("cli classification", rec, card)
    expect(len(rec["steps"]) == CLI_CLASSES // 2, "classification steps")
    expect(all(rec["eval_counts"][0][k] > 0 for k in RANK_PATH),
           f"classification rank launches {rec['eval_counts']}")
    shutil.rmtree(c["root"] / "logging", ignore_errors=True)


def phase_cli_pretrain(results, card: str):
    """`train_pretrain.main` from configs/pretrain.yaml (datasets
    ['coco'], paths set, max_epoch 1): freeze_lang_vision at 224 px, 8
    bf16 steps at batch 32 over the 64 COCO records listed 4 times; the
    peak memory the run allocated above what was allocated before it."""
    import gc
    import shutil

    import torch
    from prismer_tpu_torch.cli import train_pretrain
    c = cli_setup()
    tree = _FILES["tree"]
    cfg = cli_yaml("pretrain", c["root"] / "pretrain.yaml",
                   datasets="['coco']", coco_data_path=f"'{c['coco']}'",
                   label_path=f"'{tree / 'labels'}'", max_epoch=1)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec = run_driver(train_pretrain, cli_argv(cfg, "cli", "--pretrained",
                                              c["npz224"]))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    report_driver("cli pretrain", rec, card)
    log(f"  cli pretrain: peak memory allocated by the run {peak:.2f} GiB "
        f"above the {base / 2**30:.2f} GiB allocated before it (batch "
        f"{rec['batch']}, 224 px, freeze_lang_vision; {card})")
    expect(len(rec["steps"]) == FILES_TRAIN * CLI_PRETRAIN_REPEAT // 32,
           "pretrain steps")
    shutil.rmtree(c["root"] / "logging", ignore_errors=True)


def phase_cli_demo(results, card: str):
    """`demo.main` from configs/caption.yaml (demo; paths set) over the 16
    test images at batch 1, a caption file beside each, then
    `demo_vis.main` on one of them: a 7-panel PNG."""
    from prismer_tpu_torch.cli import demo, demo_vis
    from prismer_tpu_torch.data.png import read_png
    c = cli_setup()
    cfg = cli_yaml("caption", c["root"] / "demo.yaml",
                   data_path=f"'{c['demo']}'",
                   label_path=f"'{c['demo'] / 'labels'}'")
    rec = run_driver(demo, cli_argv(cfg, "demo", "--pretrained",
                                    c["npz480"]),
                     (demo.caption_head, "generate_captions"))
    report_driver("cli demo", rec, card, train=False)
    counts = {k: sum(n[k] for n in rec["eval_counts"])
              for k in SERVE_KERNELS}
    expect(len(rec["evals"]) == CLI_DEMO_IMAGES, "demo generate calls")
    log(f"  cli demo: {CLI_DEMO_IMAGES} images at batch 1, launches "
        + ", ".join(f"{k}={counts[k]}" for k in SERVE_KERNELS))
    expect(all(counts[k] > 0 for k in SERVE_KERNELS),
           f"demo launches {counts}")
    images = sorted((c["demo"] / "images").glob("*.jpg"))
    caps = [p.with_suffix(".txt") for p in images]
    expect(len(images) == CLI_DEMO_IMAGES and all(p.exists() for p in caps),
           "demo captions")
    out = c["root"] / "vis.png"
    t0 = time.perf_counter()
    demo_vis.main(["--image", str(images[0]), "--label_path",
                   str(c["demo"] / "labels"), "--out", str(out)])
    fig = read_png(str(out))
    log(f"  demo_vis: {fig.shape} figure in "
        f"{time.perf_counter() - t0:.2f} s")
    expect(fig.shape == (256 + 2 * 4 + 20, 7 * (256 + 4) + 4, 3),
           f"figure {fig.shape}")


# ---------------------------------------------------------------------------
# phases 11 and 12: the segmentation expert's label generation
# ---------------------------------------------------------------------------

# MaskFormer's deformable attention at 480 px: levels res5, res4, res3
SEG_LEVELS = ((15, 15), (30, 30), (60, 60))
SEG_HEADS, SEG_DIM, SEG_POINTS = 8, 32, 4
SEG_RES = 480
SEG_CLASSES = 133
SEG_BATCH = 16
SEG_IMAGES = 37          # batches of 16, 16 and 5
SEG_SIZES = ((640, 480), (500, 375), (480, 640), (427, 640), (640, 427),
             (333, 500))  # (W, H), COCO-like
_SEG = {}


DEFORM_FAMILIES = ("uniform", "local")
DEFORM_JITTER = 2.0      # pixels of the sampled level, one standard deviation


def deform_case(gen, n: int, family: str):
    """Kernel 10's inputs at the pixel decoder's shapes (Lq = S), made on
    the card from `gen`: value ~ N(0, 1), attention weights a softmax over
    the L * P points, and sampling locations of one of two families.
    "uniform": drawn from [-0.15, 1.15], so that corners fall outside the
    maps and the samples have no locality. "local" (Mask2Former-shaped):
    each query's own reference point (its pixel centre on its level's grid,
    as the encoder gives it), plus Deformable DETR's grid-initialised
    offsets (head h's direction (cos 2 pi h / H, sin 2 pi h / H) scaled to
    the unit square's edge, times p + 1 pixels of level l), plus
    N(0, DEFORM_JITTER^2)-pixel jitter, divided by (W_l, H_l)."""
    import torch
    from prismer_tpu_torch.experts.segmentation.mask2former import \
        encoder_reference_points

    s = sum(h * w for h, w in SEG_LEVELS)
    nl, hd, d, p = len(SEG_LEVELS), SEG_HEADS, SEG_DIM, SEG_POINTS
    value = torch.randn(n, s, hd, d, generator=gen, device="cuda")
    if family == "uniform":
        loc = torch.rand(n, s, hd, nl, p, 2, generator=gen,
                         device="cuda") * 1.3 - 0.15
    else:
        ref = torch.from_numpy(encoder_reference_points(SEG_LEVELS)).cuda()
        theta = torch.arange(hd, device="cuda") * (2.0 * math.pi / hd)
        grid = torch.stack([theta.cos(), theta.sin()], -1)
        grid = grid / grid.abs().max(-1, keepdim=True).values
        steps = torch.arange(1, p + 1, device="cuda", dtype=torch.float32)
        pixels = (grid[:, None, :] * steps[None, :, None])[:, None]
        pixels = pixels + DEFORM_JITTER * torch.randn(
            n, s, hd, nl, p, 2, generator=gen, device="cuda")
        norm = torch.tensor([[w, h] for h, w in SEG_LEVELS],
                            dtype=torch.float32, device="cuda")
        loc = (ref[None, :, None, :, None, :]
               + pixels / norm[None, None, None, :, None, :]).contiguous()
    w = torch.softmax(torch.randn(n, s, hd, nl * p, generator=gen,
                                  device="cuda"), -1).reshape(n, s, hd, nl, p)
    return value, loc, w


# kernel 10's other shapes, held to the plain version (not timed): (N,
# levels, Lq, H, D, P): the CPU tests' small levels (every level staged),
# a D that is not a multiple of 4 (scalar lanes, nothing staged), a level
# too large to stage beside a staged one, P 3 (the run-time point loop),
# and one query (nothing staged: the run-time loop on float4 lanes)
DEFORM_EDGES = ((2, ((12, 16), (6, 8), (3, 4)), 37, 4, 8, 4),
                (2, ((12, 16), (6, 8), (3, 4)), 40, 4, 6, 4),
                (2, ((100, 100), (30, 30)), 10900, 8, 32, 4),
                (3, ((15, 15), (30, 30), (60, 60)), 4725, 8, 32, 3),
                (1, ((15, 15), (30, 30), (60, 60)), 1, 8, 32, 4))
# ms_deform_attn.cu's instantiations: <4, 3, 4, 3>, <4, 0, 0, -1>,
# <1, 0, 0, -1>
DEFORM_KERNELS = 3


def check_ms_deform_attn(results):
    """Kernel 10 against its plain version at the pixel decoder's shapes,
    N = 16 (the generator's batch), 5 (its last batch of 37 images) and 1,
    on both location families of `deform_case` ("uniform" over
    [-0.15, 1.15], so that corners fall outside the maps; "local", shaped
    as Mask2Former's); two launches bit-identical, every value finite;
    then at DEFORM_EDGES; then ptxas -v (fails on a spill). The entry's
    `ms` is the N 16 uniform time (CUDA events), `ms_local` the local
    one; graph replays beside them in the log."""
    import torch
    from prismer_tpu_torch.experts.ops.deform_attn import (
        deform_plan, ms_deform_attn, ms_deform_attn_reference)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    entry = results["ms_deform_attn"]
    s = sum(h * w for h, w in SEG_LEVELS)
    nl, hd, d, p = len(SEG_LEVELS), SEG_HEADS, SEG_DIM, SEG_POINTS

    def held(args, who):
        got, again = ms_deform_attn(*args), ms_deform_attn(*args)
        want = ms_deform_attn_reference(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        repeat = torch.equal(got, again)
        finite = bool(torch.isfinite(got).all())
        expect(err <= TOL_FP32 and repeat and finite,
               f"ms_deform_attn {who}: max|err| {err:.3g}, repeat {repeat}, "
               f"finite {finite}")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        return got, err, repeat, finite

    for n in (SEG_BATCH, 5, 1):
        plan = deform_plan(SEG_LEVELS, n, s, hd, d, p)
        for family in DEFORM_FAMILIES:
            value, loc, w = deform_case(gen, n, family)
            args = (value, SEG_LEVELS, loc, w)
            got, err, repeat, finite = held(args, f"N={n} {family}")
            outside = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
            ms = cuda_ms(lambda: ms_deform_attn(*args), iters=20)
            graph = graph_ms(lambda: ms_deform_attn(*args), iters=20)
            plain = cuda_ms(lambda: ms_deform_attn_reference(*args), iters=3)
            bound = {}
            set_bound(bound, nbytes(value, loc, w, got),
                      2.0 * n * s * hd * nl * p * 4 * d, torch.float32)
            log(f"  ms_deform_attn N={n} S=Lq={s} H={hd} D={d} L={nl} P={p} "
                f"fp32, {family} ({outside:.2f} of the points outside "
                f"[0, 1]; {plan['blocks']} blocks, levels {plan['staged']} "
                f"staged): max|err| {err:.3g} (tol {TOL_FP32}), repeat "
                f"bit-identical {repeat}, finite {finite}; kernel {ms:.4f} "
                f"ms events, {graph:.4f} graph; plain {plain:.4f} ms; bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
            if n == SEG_BATCH and family == "uniform":
                entry.update(ms=ms, plain_ms=plain, **bound)
            elif n == SEG_BATCH:
                entry.update(ms_local=ms)
            del value, loc, w, got
    for n, shapes, lq, heads, dim, pts in DEFORM_EDGES:
        rows = sum(h * w for h, w in shapes)
        value = torch.randn(n, rows, heads, dim, generator=gen,
                            device="cuda")
        loc = torch.rand(n, lq, heads, len(shapes), pts, 2, generator=gen,
                         device="cuda") * 1.3 - 0.15
        w = torch.softmax(torch.randn(n, lq, heads, len(shapes) * pts,
                                      generator=gen, device="cuda"),
                          -1).reshape(n, lq, heads, len(shapes), pts)
        plan = deform_plan(shapes, n, lq, heads, dim, pts)
        _, err, _, _ = held((value, shapes, loc, w),
                            f"N={n} {shapes} Lq={lq} D={dim} P={pts}")
        log(f"  ms_deform_attn N={n} levels {shapes} Lq={lq} H={heads} "
            f"D={dim} P={pts} (vec {plan['vec']}, levels {plan['staged']} "
            f"staged, {plan['chunks']} chunks): max|err| {err:.3g}, repeat "
            f"bit-identical")
        del value, loc, w
    torch.cuda.empty_cache()
    report_ptxas("ms_deform_attn", DEFORM_KERNELS)


def seg_image(rng, size):
    """A synthetic uint8 RGB photo-like image (W, H) = size: smooth colour
    ramps, a few flat regions and noise."""
    import numpy as np
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / w * 255, yy / h * 255, (xx + yy) / (w + h) * 255],
                   -1)
    for _ in range(4):
        x0, y0 = rng.integers(0, w // 2), rng.integers(0, h // 2)
        img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.integers(0, 256, 3)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def seg_input(count: int, seed: int):
    """(count, 480, 480, 3) fp32 batch preprocessed as the generator does."""
    import numpy as np
    import torch
    from prismer_tpu_torch.experts.model_bank import (SEG_MEAN, SEG_STD,
                                                      resize_norm)
    rng = np.random.default_rng(seed)
    pre = resize_norm(SEG_RES, SEG_MEAN, SEG_STD)
    return torch.from_numpy(np.stack([
        pre(seg_image(rng, SEG_SIZES[i % len(SEG_SIZES)]))
        for i in range(count)]))


def phase_segment_parity(results):
    """fp32 MaskFormer (Swin-L, num_classes 133) at 480 px, batch 1: card
    (kernel 10) against the CPU (plain version), same seeded weights and
    image."""
    import copy

    import torch
    from prismer_tpu_torch.experts.segmentation.mask2former import \
        build_random_maskformer

    t0 = time.perf_counter()
    cpu = build_random_maskformer(SEED, "cpu", num_classes=SEG_CLASSES)
    gpu = copy.deepcopy(cpu).to("cuda")
    log(f"  built the fp32 MaskFormer in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in cpu.parameters()) / 1e6:.1f} M params)")
    x = seg_input(1, SEED + 10)
    outs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(x.to(dev))
        outs[name] = out.cpu()
        log(f"  {name}: forward at batch 1 in "
            f"{time.perf_counter() - t0:.2f} s, semantic {tuple(out.shape)}")
    want, got = outs["cpu"], outs["cuda"]
    rel = rel_l2(got, want)
    top2 = want.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > SEG_GAP
    differ = (got.argmax(1) != want.argmax(1)) & clear
    log(f"  fp32 card vs CPU: semantic rel L2 {rel:.3g} (tol "
        f"{TOL_SEG_REL_L2}); {int((~clear).sum())} of {clear.numel()} pixels "
        f"have a top-2 gap <= {SEG_GAP}; argmax differs at "
        f"{int(differ.sum())} pixels above it (tol 0)")
    expect(tuple(got.shape) == (1, SEG_CLASSES, SEG_RES // 4, SEG_RES // 4),
           f"semantic shape {tuple(got.shape)}")
    expect(bool(torch.isfinite(got).all()), "semantic logits not finite")
    expect(rel <= TOL_SEG_REL_L2, "segmentation card vs CPU out of "
           "tolerance")
    expect(not differ.any(), "argmax differs above the near-tie gap")
    _SEG["model"] = gpu
    del cpu, outs


def split_segment(model, x, card: str) -> None:
    """CUDA-event ms of one forward's backbone, pixel decoder, decoder and
    post (semantic logits + argmax)."""
    import torch
    from prismer_tpu_torch.experts.segmentation.mask2former import \
        semantic_logits
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.no_grad():
        ev[0].record()
        feats = model.backbone(x)
        ev[1].record()
        mask_features, ms = model.pixel_decoder(feats)
        ev[2].record()
        classes, masks = model.predictor(ms, mask_features)
        ev[3].record()
        semantic_logits(classes, masks).argmax(dim=1)
        ev[4].record()
    torch.cuda.synchronize()
    parts = ("backbone", "pixel decoder", "decoder", "post")
    log(f"  split segmentation forward, batch {x.shape[0]}: " + ", ".join(
        f"{p} {ev[i].elapsed_time(ev[i + 1]):.1f} ms"
        for i, p in enumerate(parts)) + f" ({card})")


def phase_segment(results, card: str, profile: bool, tf32_defaults):
    """The generator's entry point on the card over 37 synthetic PNGs of
    mixed sizes at batch 16, called with both TF32 flags at torch's
    defaults (`tf32_defaults`): its forward must see both False, and the
    flags must read the defaults again after it. Kernel 10 launches 6 x 3
    times, every label map has its image's size and ids < 133; then the
    batch-16 forward's time in fp32."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from prismer_tpu_torch.data import png
    from prismer_tpu_torch.experts import generate
    from prismer_tpu_torch.experts.ops.deform_attn import ms_deform_attn

    def flags():
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    seen = []
    real_load = generate.load_expert_model

    def recording_load(*a, **kw):
        """load_expert_model whose model records the TF32 flags at each
        forward"""
        model, preprocess = real_load(*a, **kw)
        forward = model.forward

        def recorded(*x, **k):
            seen.append(flags())
            return forward(*x, **k)

        model.forward = recorded
        return model, preprocess

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="segment_", dir=ROOT / "build"))
    try:
        rng = np.random.default_rng(SEED + 11)
        sizes = {}
        for i in range(SEG_IMAGES):
            folder = tmp / "data" / f"images{i % 2}"
            folder.mkdir(parents=True, exist_ok=True)
            size = SEG_SIZES[i % len(SEG_SIZES)]
            png.write_png(str(folder / f"{i:03d}.png"), seg_image(rng, size))
            sizes[f"{folder.name}/{i:03d}.png"] = size
        for fn in wrappers().values():
            fn.launches = 0
        out_buf = io.StringIO()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32_defaults
        generate.load_expert_model = recording_load
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out_buf):
                rc = generate.main(["--task", "seg_coco", "--data_path",
                                    str(tmp / "data"), "--save_path",
                                    str(tmp / "labels"), "--batch_size",
                                    str(SEG_BATCH)])
        finally:
            generate.load_expert_model = real_load
        total = time.perf_counter() - t0
        after = flags()
        log(f"  TF32 flags (matmul, cudnn): {tf32_defaults} before main(), "
            f"{sorted(set(seen))} in its {len(seen)} forwards, {after} after")
        expect(seen and set(seen) == {(False, False)},
               f"the generator's forward ran with TF32 flags {set(seen)}")
        expect(after == tf32_defaults, "main() left the TF32 flags changed")
        results["ms_deform_attn"]["launches"] = ms_deform_attn.launches
        for line in out_buf.getvalue().splitlines():
            log(f"  {line}")
        loop_s = generate.LAST_RUN["wall_s"]
        expect(rc == 0, f"generate.main returned {rc}")
        expect(ms_deform_attn.launches == 18, f"ms_deform_attn launched "
               f"{ms_deform_attn.launches} times, want 6 layers x 3 batches")
        for rel, (w, h) in sizes.items():
            out = tmp / "labels" / "seg_coco" / "data" / rel
            expect(out.exists(), f"no label for {rel}")
            ids = png.read_png(str(out))
            expect(ids.shape == (h, w) and int(ids.max()) < SEG_CLASSES,
                   f"label {rel}: shape {ids.shape}, max id {ids.max()}")
        log(f"  {SEG_IMAGES} label PNGs at their images' sizes, ids < "
            f"{SEG_CLASSES}; ms_deform_attn launches "
            f"{ms_deform_attn.launches}; main() {total:.1f} s in all (random "
            f"model build included), labelling loop {loop_s:.2f} s = "
            f"{SEG_IMAGES / loop_s:.1f} images/s wall-clock with PNG IO "
            f"({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the forward's device time in fp32, as the generator runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _SEG["model"]
    x = seg_input(SEG_BATCH, SEED + 12).cuda()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms = cuda_ms(lambda: model(x), iters=3, warmup=1)
    log(f"  batch-16 forward (fp32, 480 px) after one warm-up: {ms:.1f} ms, "
        f"{SEG_BATCH * 1000.0 / ms:.1f} images/s through the device part; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
        f"({card})")
    if profile:
        split_segment(model, x, card)
        with torch.no_grad():
            busy, by_name = profile_request(
                lambda: model(x), (), "segmentation forward, batch 16", card)
        k10 = sum(t for name, (t, _) in by_name.items()
                  if "ms_deform_attn" in name)
        log(f"  ms_deform_attn: {k10:.2f} ms of {busy:.1f} ms device time "
            f"({k10 / busy:.3f})")
    del _SEG["model"], model, x
    torch.cuda.empty_cache()


SEG_JPEG_FIXTURES = ("photo_640x480_q90_420.jpg",
                     "photo_640x480_progressive.jpg",
                     "truncated_640x480.jpg", "restart_100x75_420.jpg")


def phase_segment_jpeg(results, card: str):
    """The generator's entry point over 4 JPEG fixtures as .jpg, then over
    the same pixels (decoded by the port) written as PNG, one model for
    both runs: the label maps must be equal."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    from prismer_tpu_torch import native
    from prismer_tpu_torch.data import png
    from prismer_tpu_torch.experts import generate

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="segjpeg_", dir=ROOT / "build"))
    real_load = generate.load_expert_model
    cached = {}

    def load_once(*a, **kw):
        if "model" not in cached:
            cached["model"] = real_load(*a, **kw)
        return cached["model"]

    try:
        for name in SEG_JPEG_FIXTURES:
            data = (JPEG_FIXTURES / name).read_bytes()
            stem = name[:-len(".jpg")]
            for kind in ("jpg", "png"):
                (tmp / kind / "images").mkdir(parents=True, exist_ok=True)
            (tmp / "jpg" / "images" / name).write_bytes(data)
            png.write_png(str(tmp / "png" / "images" / f"{stem}.png"),
                          native.decode_jpeg(data))
        generate.load_expert_model = load_once
        t0 = time.perf_counter()
        try:
            for kind in ("jpg", "png"):
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = generate.main([
                        "--task", "seg_coco", "--data_path",
                        str(tmp / kind), "--save_path",
                        str(tmp / f"labels_{kind}"), "--batch_size",
                        str(len(SEG_JPEG_FIXTURES))])
                expect(rc == 0, f"generate.main over {kind} returned {rc}")
        finally:
            generate.load_expert_model = real_load
        for name in SEG_JPEG_FIXTURES:
            stem = name[:-len(".jpg")]
            maps = [png.read_png(str(tmp / f"labels_{kind}" / "seg_coco"
                                     / kind / "images" / f"{stem}.png"))
                    for kind in ("jpg", "png")]
            h, w = native.decode_jpeg_shape(
                (JPEG_FIXTURES / name).read_bytes())
            expect(maps[0].shape == (h, w), f"{name}: label {maps[0].shape}")
            expect(np.array_equal(maps[0], maps[1]),
                   f"{name}: labels from the .jpg and the .png differ at "
                   f"{int((maps[0] != maps[1]).sum())} pixels")
        log(f"  {len(SEG_JPEG_FIXTURES)} JPEG fixtures and their PNG copies "
            f"give equal seg_coco label maps ({time.perf_counter() - t0:.1f} "
            f"s, model build included; {card})")
    finally:
        cached.clear()
        shutil.rmtree(tmp, ignore_errors=True)


IMAGE_FIXTURES = ROOT / "tests" / "data"
IMAGE_KINDS = ("webp", "gif", "bmp")
# the 640 x 480 fixtures: timed, then fed to the generator under .jpg names
IMAGE_BIG = (("webp", "photo_640x480_lossy_q80.webp"),
             ("webp", "photo_640x480_lossless_16colours.webp"),
             ("gif", "photo_640x480_16colours.gif"),
             ("bmp", "photo_640x480_16colours.bmp"))
IMAGE_RUNS = 50


def phase_image_formats(results, card: str):
    """WebP, GIF and BMP files as web-scraped caption corpora hold them,
    under .jpg names. Every fixture of tests/data/webp, gif and bmp decodes
    through its format's function (RGB and Pillow's own mode) and through
    the loader's read_rgb to the sha256 Pillow gave (expected.json, written
    where Pillow is); the median decode ms of each 640 x 480 kind over
    IMAGE_RUNS runs beside the JPEG fixture's; then the segmentation
    generator's entry point, one model, over the 640 x 480 WebP, GIF and
    BMP fixtures saved as .jpg and over the same pixels written as PNG
    (equal label maps, kernel 10 launched), and one Prismer-BASE bf16
    beam-3 caption batch of those records through load_expert_labels ->
    experts_to_device -> build_generate_fn, whose ids from the two trees
    must be equal (kernels 1-5 launched)."""
    import contextlib
    import hashlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from prismer_tpu_torch import native
    from prismer_tpu_torch.data import bmp, experts_to_device, png
    from prismer_tpu_torch.data.labels import (build_expert_record,
                                               load_expert_labels, read_rgb)
    from prismer_tpu_torch.data.loader import default_collate
    from prismer_tpu_torch.data.transform import Transform
    from prismer_tpu_torch.experts import generate
    from prismer_tpu_torch.models.caption import (build_generate_fn,
                                                  prefix_prompt_ids)
    from prismer_tpu_torch.tokenizer import synthetic_tokenizer

    native.build()
    decoders = {"webp": native.decode_webp, "gif": native.decode_gif,
                "bmp": bmp.decode_bmp}
    t0 = time.perf_counter()
    counted = {}
    for kind in IMAGE_KINDS:
        expected = json.loads(
            (IMAGE_FIXTURES / kind / "expected.json").read_text())
        for name, e in sorted(expected["files"].items()):
            path = IMAGE_FIXTURES / kind / name
            data = path.read_bytes()
            for how, px, key in (
                    ("decode", decoders[kind](data, "RGB"), ""),
                    ("read_rgb", read_rgb(str(path)), ""),
                    ("own mode", decoders[kind](data), "mode_")):
                if px.dtype == np.bool_:           # hashed as 0 / 1 bytes
                    px = px.astype(np.uint8)
                digest = hashlib.sha256(
                    np.ascontiguousarray(px).tobytes()).hexdigest()
                expect(list(px.shape) == e[key + "shape"]
                       and digest == e[key + "sha256"],
                       f"{kind}/{name} ({how}): {px.shape} sha256 "
                       f"{digest[:12]}, Pillow gave {e[key + 'shape']} "
                       f"{e[key + 'sha256'][:12]}")
        counted[kind] = len(expected["files"])
    log("  " + ", ".join(f"{n} {k}" for k, n in counted.items())
        + f" fixtures decode to the pixels of Pillow {expected['pillow']} "
        f"in RGB and their own mode, and through read_rgb (sha256 equal; "
        f"{time.perf_counter() - t0:.2f} s)")

    timed = [(kind, IMAGE_FIXTURES / kind / name, decoders[kind])
             for kind, name in IMAGE_BIG]
    timed.append(("jpeg", JPEG_FIXTURES / "photo_640x480_q90_420.jpg",
                  lambda data, mode: native.decode_jpeg(data)))
    for kind, path, fn in timed:
        data = path.read_bytes()
        times = []
        for _ in range(IMAGE_RUNS):
            t1 = time.perf_counter()
            fn(data, "RGB")
            times.append((time.perf_counter() - t1) * 1e3)
        log(f"  decode {path.name} ({len(data)} bytes): median "
            f"{statistics.median(times):.2f} ms, min {min(times):.2f} ms "
            f"over {IMAGE_RUNS} runs ({host_cpu()}; {card})")

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="formats_", dir=ROOT / "build"))
    real_load = generate.load_expert_model
    cached = {}

    def load_once(*a, **kw):
        if "model" not in cached:
            cached["model"] = real_load(*a, **kw)
        return cached["model"]

    names = {"jpg": [], "png": []}
    try:
        for kind, name in IMAGE_BIG:
            stem = f"{kind}_{name.rsplit('.', 1)[0]}"
            data = (IMAGE_FIXTURES / kind / name).read_bytes()
            for sub in ("jpg", "png"):
                (tmp / sub / "images").mkdir(parents=True, exist_ok=True)
            (tmp / "jpg" / "images" / f"{stem}.jpg").write_bytes(data)
            png.write_png(str(tmp / "png" / "images" / f"{stem}.png"),
                          decoders[kind](data, "RGB"))
            names["jpg"].append(f"{stem}.jpg")
            names["png"].append(f"{stem}.png")
        generate.load_expert_model = load_once
        _zero_counts()
        t0 = time.perf_counter()
        try:
            for sub in ("jpg", "png"):
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = generate.main([
                        "--task", "seg_coco", "--data_path", str(tmp / sub),
                        "--save_path", str(tmp / f"labels_{sub}"),
                        "--batch_size", str(len(IMAGE_BIG))])
                expect(rc == 0, f"generate.main over {sub} returned {rc}")
        finally:
            generate.load_expert_model = real_load
        seg_launches = _launch_counts(["ms_deform_attn"])["ms_deform_attn"]
        dt_seg = time.perf_counter() - t0
        for jpg, pngname in zip(names["jpg"], names["png"]):
            maps = [png.read_png(str(tmp / f"labels_{sub}" / "seg_coco" / sub
                                     / "images" / f"{n[:-4]}.png"))
                    for sub, n in (("jpg", jpg), ("png", pngname))]
            expect(maps[0].shape == (480, 640), f"{jpg}: label "
                   f"{maps[0].shape}")
            expect(np.array_equal(maps[0], maps[1]),
                   f"{jpg}: labels from the .jpg and the .png differ at "
                   f"{int((maps[0] != maps[1]).sum())} pixels")
        expect(seg_launches > 0, "ms_deform_attn was not launched")
        log(f"  the WebP, GIF and BMP fixtures under .jpg names and their "
            f"PNG twins give equal seg_coco label maps ({dt_seg:.1f} s, "
            f"model build included; ms_deform_attn launches "
            f"{seg_launches}; {card})")
        cached.clear()

        _, model, _ = serve_setup()
        gen_fn = build_generate_fn(model)
        tok = synthetic_tokenizer()
        tf = Transform(480, train=False)
        ids, mask = prefix_prompt_ids(tok, FILES_PREFIX, len(IMAGE_BIG))
        prompt = (torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda())
        _zero_counts()
        t0 = time.perf_counter()
        batches, outs = [], []
        for sub in ("jpg", "png"):
            records = []
            for n in names[sub]:
                image, labs, info = load_expert_labels(
                    str(tmp), str(tmp / f"labels_{sub}"), f"images/{n}", sub,
                    list(FILES_EXPERTS))
                records.append(build_expert_record(tf(image, labs), info))
            batch = default_collate(records)
            batches.append(batch)
            seqs = gen_fn(experts_to_device(batch, "cuda"), *prompt)
            outs.append(seqs.cpu())
        dt_cap = time.perf_counter() - t0
        counts = _launch_counts(SERVE_KERNELS)
        same_in = _same_batch(batches[0], batches[1])
        same_ids = torch.equal(outs[0], outs[1])
        log(f"  BASE bf16 beam-3 captions of the {len(IMAGE_BIG)} records "
            f"through load_expert_labels -> experts_to_device -> "
            f"build_generate_fn: inputs bit-equal {same_in}, ids equal "
            f"{same_ids} ({dt_cap:.2f} s for both batches); launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items())
            + f" ({card})")
        expect(same_in, "the .jpg and .png records differ")
        expect(same_ids, "caption ids from the .jpg and .png trees differ")
        expect(all(counts[k] > 0 for k in SERVE_KERNELS),
               f"image-formats caption launches {counts}")
    finally:
        generate.load_expert_model = real_load
        cached.clear()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases "experts parity", "experts generate", "experts demo": the other
# five label experts, the OCR words' CLIP text encoder, and the demo from
# the labels the port generated
# ---------------------------------------------------------------------------

EXPERT_TASKS = ("depth", "normal", "edge", "obj_detection", "ocr_detection")
EXPERT_RES = 480
# fp32 card vs CPU, relative L2 of every output compared
TOL_EXPERT_REL_L2 = 1e-3
CLIP_WORDS = ("stop", "the cat", "exit", "dog and the cat", "open", "on",
              "car park", "the end")
EXPERT_IMAGES = 16      # synthetic PNGs and the 640 x 480 JPEG fixtures
EXPERT_BATCH = 16
# object detection runs on shard 0 of 16 of the 16 images (1): with random
# weights UniDet keeps up to 300 boxes, and the host's class-wise NMS and
# occlusion ordering take about a minute an image
OBJDET_SHARDS = 16
# OCR: the seeded CharNet's heads are set from its own outputs
# (`sparse_ocr`) so that about this share of the cells pass the word
# threshold, and half of those the char threshold, with boxes that overlap
# their neighbours and one dominant char class: with random weights half
# of the 14,400 cells would be word candidates, and the reference's
# pairwise polygon NMS (kept as a copy) would take longer than this run
# may
OCR_WORD_SHARE = 0.01
OCR_CHAR_CLASS = 10     # 'A'
_EXP = {}


def expert_inputs(task: str, seed: int):
    """(1, 480, 480, 3) fp32 image preprocessed as `task`'s generator does."""
    import numpy as np
    import torch
    from prismer_tpu_torch.experts.model_bank import PIXEL_STATS, resize_norm
    rng = np.random.default_rng(seed)
    pre = resize_norm(EXPERT_RES, *PIXEL_STATS[task])
    return torch.from_numpy(pre(seg_image(rng, (640, 480)))[None])


def _parity(label: str, got, want) -> float:
    import torch
    rel = rel_l2(got.float(), want.float())
    expect(bool(torch.isfinite(got).all()), f"{label}: not finite")
    expect(rel <= TOL_EXPERT_REL_L2, f"{label}: card vs CPU rel L2 {rel:.3g}")
    return rel


def phase_experts_parity(results):
    """Each of the five experts at full width from the seed, fp32, TF32 off,
    at 480 px batch 1, card against CPU: DPT-hybrid (ViT-B, 12 layers),
    NNET (EfficientNet-B5), DexiNed, CharNet (Hourglass-88) on their
    outputs; UniDet (ResNeSt-200) on P3-P7, the RPN's per-level top-k
    scores and every cascade stage's scores and boxes, each stage fed the
    CPU's boxes; and the CLIP text encoder at ViT-L/14's text width (768,
    12 layers, vocabulary 49,408, context 77) on 8 words."""
    import copy

    import torch
    from prismer_tpu_torch.experts import model_bank
    from prismer_tpu_torch.experts.clip_text import (RAW_INIT,
                                                     CLIPTextEncoder)
    from prismer_tpu_torch.experts.layers import build_random
    from prismer_tpu_torch.experts.obj_detection.rcnn import \
        proposals_after_nms
    from prismer_tpu_torch.tokenizer import synthetic_clip_tokenizer

    for i, task in enumerate(EXPERT_TASKS):
        t0 = time.perf_counter()
        cpu = model_bank._build(task, "cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        built = time.perf_counter() - t0
        x = expert_inputs(task, SEED + 40 + i)
        rels = []
        t0 = time.perf_counter()
        with torch.no_grad():
            if task != "obj_detection":
                want = cpu(x)
                t1 = time.perf_counter()
                got = gpu(x.cuda())
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if isinstance(want, dict):
                    rels = [_parity(f"{task} {k}", got[k], want[k])
                            for k in want]
                elif isinstance(want, list):
                    rels = [_parity(f"{task} {j}", g, w)
                            for j, (g, w) in enumerate(zip(got, want))]
                else:
                    rels = [_parity(task, got, want)]
            else:
                fc, fg = cpu.features(x), gpu.features(x.cuda())
                rels += [_parity(f"P{j + 3}", g, w)
                         for j, (g, w) in enumerate(zip(fg, fc))]
                for j, ((sc, _, _), (sg, _, _)) in enumerate(zip(
                        cpu.level_topk(fc), gpu.level_topk(fg))):
                    rels.append(_parity(f"RPN top-k P{j + 3}", sg, sc))
                pb, ps = cpu.rpn_proposals(fc)
                boxes = torch.from_numpy(proposals_after_nms(
                    pb.numpy(), ps.numpy(), (EXPERT_RES, EXPERT_RES)))
                for stage in range(3):
                    s_c, b_c = cpu.cascade_stage(fc, boxes, stage)
                    s_g, b_g = gpu.cascade_stage(fg, boxes.cuda(), stage)
                    rels.append(_parity(f"stage {stage} scores", s_g, s_c))
                    rels.append(_parity(f"stage {stage} boxes", b_g, b_c))
                    boxes = b_c
                t1 = t2 = time.perf_counter()
        log(f"  {task}: {sum(p.numel() for p in cpu.parameters()) / 1e6:.1f}"
            f" M params, built in {built:.1f} s; CPU vs card in "
            f"{time.perf_counter() - t0:.1f} s; rel L2 max {max(rels):.3g} "
            f"over {len(rels)} outputs (tol {TOL_EXPERT_REL_L2})")
        del cpu, gpu
    t0 = time.perf_counter()
    cpu = build_random(CLIPTextEncoder, SEED, "cpu", RAW_INIT)
    gpu = copy.deepcopy(cpu).to("cuda")
    ids = torch.from_numpy(synthetic_clip_tokenizer()(list(CLIP_WORDS))).long()
    with torch.no_grad():
        rel = _parity("CLIP text", gpu(ids.cuda()), cpu(ids))
    log(f"  CLIP text encoder (768 wide, 12 layers, vocabulary 49,408): "
        f"{len(CLIP_WORDS)} words, rel L2 {rel:.3g} (tol "
        f"{TOL_EXPERT_REL_L2}), {time.perf_counter() - t0:.1f} s")
    _EXP["clip"] = cpu
    torch.cuda.empty_cache()


def write_clip_assets(weights):
    """The seed's CLIP text encoder as the converter writes it
    (`clip_text_vit_l14.npz`) and a BPE vocabulary file of the synthetic
    tokenizer's merges under its header line."""
    from prismer_tpu_torch.experts.clip_text import (CLIP_TEXT_WEIGHTS,
                                                     RAW_INIT,
                                                     CLIPTextEncoder)
    from prismer_tpu_torch.experts.layers import build_random
    from prismer_tpu_torch.tokenizer import CLIP_SYNTHETIC_MERGES
    from prismer_tpu_torch.train.checkpoint import save_params_npz
    model = _EXP.pop("clip", None) or build_random(CLIPTextEncoder, SEED,
                                                   "cpu", RAW_INIT)
    save_params_npz(str(weights / CLIP_TEXT_WEIGHTS), model.state_dict())
    (weights / "bpe_simple_vocab_16e6.txt").write_text(
        "#version: synthetic\n" + "".join(
            f"{a} {b}\n" for a, b in CLIP_SYNTHETIC_MERGES))


def _affine_head(conv, raw, mean: float, std: float) -> None:
    """Scale and shift a 1x1 conv in place, each output channel apart, so
    that its outputs on `raw` ((cells, channels), its current outputs)
    have this mean and standard deviation."""
    scale = std / raw.std(dim=0)
    conv.weight.mul_(scale[:, None, None, None])
    conv.bias.mul_(scale).add_(mean - scale * raw.mean(dim=0))


def sparse_ocr(model, images):
    """Set the seeded CharNet's heads from its own outputs on `images`
    (module note at OCR_WORD_SHARE): the word / char foreground biases so
    that about OCR_WORD_SHARE of the cells pass the word threshold and half
    of those the char threshold; the box sides to about 15 cells (tblr
    1.5 +- 0.05 before the x10) and the orientation to 0 +- 0.05 rad, so
    that neighbouring boxes overlap as the polygon NMS needs; char class
    OCR_CHAR_CLASS ahead of every other by 12. Returns the share of cells
    over the word threshold and of those over the char threshold, after
    the shift."""
    import torch

    def head_outputs(head, feat):
        logits = head.fg_pred(head.fg_feat(head.det_conv_final(feat)))
        reg = head.reg_feat(head.det_conv_final(feat))
        out = {"gap": (logits[..., 1] - logits[..., 0]).reshape(-1),
               "tblr": head.tblr_pred(reg).reshape(-1, 4)}
        if hasattr(head, "orient_pred"):
            out["orient"] = head.orient_pred(reg).reshape(-1, 1)
        return out

    with torch.no_grad():
        outs = {"word": [], "char": []}
        gap = []
        for x in images:
            feat = model.backbone(x.cuda())
            outs["word"].append(head_outputs(model.word_detector, feat))
            outs["char"].append(head_outputs(model.char_detector, feat))
            h = feat
            for i in range(3):
                h = getattr(model, f"recog_{i}")(h)
            cls = model.recog_cls(h).reshape(-1, model.recog_cls.out_channels)
            gap.append(cls.max(dim=1).values - cls[:, OCR_CHAR_CLASS])
        cat = {k: {n: torch.cat([o[n] for o in v]) for n in v[0]}
               for k, v in outs.items()}
        dw, dc = cat["word"]["gap"], cat["char"]["gap"]
        sw = torch.quantile(dw, 1 - OCR_WORD_SHARE).item()
        # chars are read only on word cells: half of those pass p > 0.25
        dc = dc[dw > sw]
        sc = torch.quantile(dc, 0.5).item() + math.log(3.0)
        model.word_detector.fg_pred.bias[1] -= sw
        model.char_detector.fg_pred.bias[1] -= sc
        for name, head in (("word", model.word_detector),
                           ("char", model.char_detector)):
            _affine_head(head.tblr_pred, cat[name]["tblr"], 1.5, 0.05)
        _affine_head(model.word_detector.orient_pred, cat["word"]["orient"],
                     0.0, 0.05)
        model.recog_cls.bias[OCR_CHAR_CLASS] += torch.cat(gap).max() + 12.0
        return (float((dw - sw > 0).float().mean()),
                float((dc - sc > -math.log(3.0)).float().mean()))


def ocr_stages(model, x) -> None:
    """Log how many boxes each stage of the OCR decode keeps on one
    image (a failed run's diagnosis)."""
    import numpy as np
    import torch
    from prismer_tpu_torch.experts.ocr_detection import postprocess as pp
    with torch.no_grad():
        m = {k: v[0].cpu().numpy() for k, v in model(x.cuda()).items()}
    post = pp.OrientedTextPostProcessing()
    wf = m["word_fg"][..., 1]
    kw = dict(scale_w=640 / 480, scale_h=1.0, W=640, H=480)
    wb, _ = pp._parse_boxes(wf, m["word_tblr"], m["word_orient"][..., 0],
                            0.5, **kw)
    keep, wb = pp.weighted_nms(wb, 0.15, num_neig=1)
    cb, cs = pp._parse_boxes(m["char_fg"][..., 1], m["char_tblr"], None,
                             0.25, **kw, extra_maps=m["char_cls"],
                             keep_mask=wf > 0.5)
    ck, cb, cs = pp.weighted_nms(cb, 0.3, num_neig=1, extra=cs)
    words = post._assemble(pp._clip_round(wb[keep], 640, 480),
                           pp._clip_round(cb[ck], 640, 480), cs[ck])
    log(f"  ocr stages on one image: word cells {int((wf > 0.5).sum())}, "
        f"word boxes after NMS {len(keep)}, char boxes {len(cb)} -> "
        f"{len(ck)} after NMS, words assembled {len(words)}, text scores "
        f"{[round(w.text_score, 3) for w in words][:8]}; tblr mean "
        f"{np.round(m['word_tblr'].reshape(-1, 4).mean(0), 2).tolist()}, "
        f"orient std {float(m['word_orient'].std()):.3f}")


def phase_experts_generate(results, card: str):
    """`experts.generate.main` on the card over 16 images in one folder,
    synthetic PNGs and the 640 x 480 JPEG fixtures: depth, normal, edge at batch 16,
    obj_detection on 1 of them (reading the depth labels just written),
    ocr_detection with CLIP text weights and a vocabulary in a temporary
    PRISMER_EXPERT_WEIGHTS, then seg_coco. Every label file must be where
    `data.labels` reads it (OCR: only for images with words); per task the
    images/s, the device time a batch or image (CUDA events), the host
    time (wall minus device) and the peak memory."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from prismer_tpu_torch import native
    from prismer_tpu_torch.data import png
    from prismer_tpu_torch.experts import generate

    cli_setup()                      # the demo phase's tokenizer and weights
    (ROOT / "build").mkdir(exist_ok=True)
    tree = Path(tempfile.mkdtemp(prefix="experts_", dir=ROOT / "build"))
    images = tree / "helpers" / "images"
    images.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 50)
    sizes = {}
    jpegs = big_fixtures()
    for i in range(EXPERT_IMAGES - len(jpegs)):
        size = SEG_SIZES[i % len(SEG_SIZES)]
        png.write_png(str(images / f"{i:03d}.png"), seg_image(rng, size))
        sizes[f"{i:03d}.png"] = size
    for name in jpegs:
        shutil.copy(JPEG_FIXTURES / name, images / name)
        h, w = native.decode_jpeg_shape((JPEG_FIXTURES / name).read_bytes())
        sizes[name] = (w, h)
    weights = tree / "weights"
    weights.mkdir()
    write_clip_assets(weights)
    old_env = os.environ.get("PRISMER_EXPERT_WEIGHTS")
    os.environ["PRISMER_EXPERT_WEIGHTS"] = str(weights)
    labels = tree / "labels"
    real_load = generate.load_expert_model
    shares = {}

    def load(task, image_size, device):
        model, preprocess = real_load(task, image_size, device)
        if task == "ocr_detection":
            xs = [torch.from_numpy(preprocess(generate.read_rgb(str(
                images / n)))[None]) for n in sorted(sizes)[:4]]
            shares.update(zip(("word", "char"), sparse_ocr(model, xs)))
            shares.update(model=model, x=xs[0])
        return model, preprocess

    files = sorted(sizes)
    t_all = time.perf_counter()
    stats = {}
    try:
        generate.load_expert_model = load
        for task in EXPERT_TASKS + ("seg_coco",):
            argv = ["--task", task, "--data_path", str(tree / "helpers"),
                    "--save_path", str(labels), "--batch_size",
                    str(EXPERT_BATCH)]
            if task == "obj_detection":
                argv += ["--num_shards", str(OBJDET_SHARDS)]
            torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = generate.main(argv)
            total = time.perf_counter() - t0
            expect(rc == 0, f"generate.main --task {task} returned {rc}")
            run = dict(generate.LAST_RUN)
            run.update(total=total, peak=torch.cuda.max_memory_allocated())
            stats[task] = run
            done = files[::OBJDET_SHARDS] if task == "obj_detection" else files
            expect(run["images"] == len(done), f"{task}: {run['images']} "
                   f"images, want {len(done)}")
            for name in done:
                w, h = sizes[name]
                stem = os.path.splitext(name)[0]
                path = labels / task / "helpers" / "images" / f"{stem}.png"
                if task == "ocr_detection" and not path.exists():
                    continue
                expect(path.exists(), f"{task}: no label for {name}")
                arr = png.read_png(str(path))
                expect(arr.shape[:2] == (h, w), f"{task} {name}: label "
                       f"{arr.shape}, image {(h, w)}")
                side = {"obj_detection": ".json",
                        "ocr_detection": ".pt"}.get(task)
                if side:
                    expect(path.with_suffix(side).exists(),
                           f"{task}: no {side} for {name}")
            batches = (-(-run["images"] // EXPERT_BATCH)
                       if task in ("depth", "normal", "edge", "seg_coco")
                       else run["images"])
            unit = "batch" if batches < run["images"] else "image"
            log(f"  {task}: {run['images']} images in {run['wall_s']:.2f} s "
                f"({run['images'] / run['wall_s']:.2f} images/s); device "
                f"{run['device_s'] * 1e3 / batches:.1f} ms a {unit} (CUDA "
                f"events), host {run['host_s']:.2f} s; main() "
                f"{total:.1f} s with the model's build; peak "
                f"{run['peak'] / 2**30:.2f} GiB ({card})")
        ocr = sorted((labels / "ocr_detection" / "helpers" / "images").glob(
            "*.pt")) if (labels / "ocr_detection").exists() else []
        words = 0
        for p in ocr:
            with np.load(p) as z:
                words += sum(1 for k in z.files if not k.startswith("text_"))
                feats = [z[k] for k in z.files if not k.startswith("text_")]
            expect(all(f.shape == (64,) and np.isfinite(f).all()
                       for f in feats), f"{p.name}: word features")
        log(f"  ocr: cells over the word threshold / word cells over the "
            f"char threshold after the shift "
            f"{shares.get('word', 0):.4f} / {shares.get('char', 0):.3f}; "
            f"{words} words on {len(ocr)} of {len(files)} images, embedded "
            f"by the CLIP text encoder (768 wide, 12 layers) + PCA")
        if not words:
            ocr_stages(shares["model"], shares["x"])
        expect(words > 0, "the OCR task wrote no word")
    finally:
        generate.load_expert_model = real_load
        if old_env is None:
            os.environ.pop("PRISMER_EXPERT_WEIGHTS", None)
        else:
            os.environ["PRISMER_EXPERT_WEIGHTS"] = old_env
    _EXP.update(tree=tree, files=files, stats=stats)
    log(f"  six tasks in {time.perf_counter() - t_all:.1f} s ({card})")


def phase_experts_demo(results, card: str):
    """`cli.demo` at Prismer-BASE (six experts, 480 px, bf16, the seed's
    weights) over the 16 images and the labels "experts generate" wrote: a
    caption for every image, kernels 1-5 launched."""
    import shutil

    from prismer_tpu_torch.cli import demo
    c = cli_setup()
    tree = _EXP["tree"]
    try:
        cfg = cli_yaml("caption", tree / "demo.yaml",
                       data_path=f"'{tree / 'helpers'}'",
                       label_path=f"'{tree / 'labels'}'")
        rec = run_driver(demo, cli_argv(cfg, "experts_demo", "--pretrained",
                                        c["npz480"]),
                         (demo.caption_head, "generate_captions"))
        report_driver("experts demo", rec, card, train=False)
        counts = {k: sum(n[k] for n in rec["eval_counts"])
                  for k in SERVE_KERNELS}
        log("  experts demo: launches " + ", ".join(
            f"{k}={counts[k]}" for k in SERVE_KERNELS))
        expect(all(counts[k] > 0 for k in SERVE_KERNELS),
               f"experts demo launches {counts}")
        images = tree / "helpers" / "images"
        caps = {n: (images / n).with_suffix(".txt") for n in _EXP["files"]}
        expect(len(rec["evals"]) == len(caps), "experts demo generate calls")
        missing = [n for n, p in caps.items() if not p.exists()]
        expect(not missing, f"no caption for {missing}")
        first = caps[_EXP["files"][0]].read_text()
        log(f"  {len(caps)} captions from the port's own labels, e.g. "
            f"{first!r}")
    finally:
        shutil.rmtree(tree, ignore_errors=True)
        _EXP.clear()


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
    ("flash_attention_bwd_dq", "prismer_tpu_torch/csrc/flash_attention_bwd.cu",
     "prismer_tpu/ops/flash_attention.py:457"),
    ("flash_attention_bwd_dkv",
     "prismer_tpu_torch/csrc/flash_attention_bwd.cu",
     "prismer_tpu/ops/flash_attention.py:483"),
    ("ce_stats", "prismer_tpu_torch/csrc/fused_ce.cu",
     "prismer_tpu/ops/fused_ce.py:165"),
    ("ce_grads", "prismer_tpu_torch/csrc/fused_ce.cu",
     "prismer_tpu/ops/fused_ce.py:255"),
    ("ms_deform_attn", "prismer_tpu_torch/csrc/ms_deform_attn.cu",
     "prismer_tpu/experts/ops/deform_attn_pallas.py:138"),
    ("fused_layer_norm", "prismer_tpu_torch/csrc/layer_norm.cu",
     "prismer_tpu/ops/layer_norm.py:58"),
    ("ln_proj", "prismer_tpu_torch/csrc/ln_proj.cu",
     "prismer_tpu/ops/ln_proj.py:127"),
    ("adaptor_fused", "prismer_tpu_torch/csrc/ln_proj.cu",
     "prismer_tpu/ops/ln_proj.py:242"),
    ("grouped_cross_attention", "prismer_tpu_torch/csrc/decode_attention.cu",
     "prismer_tpu/ops/decode_attention.py:210"),
    ("grouped_decode_attention", "prismer_tpu_torch/csrc/decode_attention.cu",
     "prismer_tpu/ops/decode_attention.py:134"),
    ("fused_decode_step_int8", "prismer_tpu_torch/csrc/fused_decode.cu",
     "prismer_tpu/ops/fused_decode.py:637"),
)


# ---------------------------------------------------------------------------
# multi-gpu: the parallel/ package, sharded generation and the data-parallel
# train step (ROADMAP §1 item 9)
# ---------------------------------------------------------------------------

MULTI_MODES = ("dp", "zero2", "zero3")
MULTI_TIMED_STEPS = 5   # after 2 warm-up steps
# tests/test_torch_train.py's tolerances: loss rel, gradient rel L2 per
# trainable leaf, BatchNorm statistics
TOL_MULTI_LOSS = 1e-5
TOL_MULTI_GRAD = 1e-4
TOL_MULTI_STATS = 1e-5
# bf16 steps of the modes against dp on the same batch and seed: the
# forward and the BatchNorm statistics agree under the fp32 tolerances
# above; the gradients to rounding. Under zero3, FSDP2 passes each
# sharded module's inputs through an autograd node of its own, so the
# encoder output's gradient, which the decoder layers' cross-attention
# sum in bf16, is summed in another order (on the CPU the decoder's
# gradients stay bit-equal: tests/test_torch_parallel_train.py); 2^-4 is
# 16 bf16 units of rounding
TOL_MULTI_GRAD_BF16 = 2.0 ** -4


def _open_group(device: str, backend: str):
    """A one-rank group over a FileStore in a temporary directory."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from prismer_tpu_torch.parallel import runtime
    tmp = tempfile.mkdtemp(prefix="prismer_pg_")
    atexit.register(shutil.rmtree, tmp, True)
    runtime.init(device, backend, dist.FileStore(f"{tmp}/store", 1), 0, 1)


def _fp32_step_record(mode, mesh, batch):
    """One fp32 BASE step (dropout 0) at the batch: `_step_record`; the
    step without a group when mesh is None."""
    import dataclasses

    from prismer_tpu_torch.train import build_train_step

    cfg = slice_config("float32")
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, hidden_dropout_prob=0.0))
    state = train_state(cfg, "cuda", 5e-5)
    return _step_record(build_train_step(state.model, mesh, mode or "dp"),
                        state, batch)


def _step_record(step, state, batch):
    """One step: its loss, the gradients and the BatchNorm statistics after
    it, on the CPU."""
    from prismer_tpu_torch.parallel import zero

    state, metrics = step(state, batch)
    grads = {n: g.float().cpu() for n, g in zero.full_grads(state).items()}
    stats = {k: t.cpu() for k, t in zero.full_state(state)["model"].items()
             if k.endswith(("running_mean", "running_var"))}
    return float(metrics["loss"]), grads, stats


def _check_step(label, got, want, relu_fed_apart: bool = False,
                grad_tol: float = TOL_MULTI_GRAD):
    """Loss, gradients and BatchNorm statistics of one step against
    another's. relu_fed_apart: the two steps split the batch differently,
    so the ReLU-fed stem leaves are held as "train parity" holds them
    (TOL_TRAIN_GRAD_RELU) and every other leaf at grad_tol. Those leaves'
    gradients are sums over (B, H, W) that cancel (sum |g| / |sum g| up
    to 2.4e5 in a channel), so another order of the same sum moves them:
    tools/probe_relu_fed.py reads them 5.6e-4 apart at 2 ranks, with
    cuDNN deterministic too and no ReLU input across zero, and 5.7e-3
    apart when one process takes the same rows in reverse order."""
    import torch

    (l_g, g_g, s_g), (l_w, g_w, s_w) = got, want
    expect(g_g.keys() == g_w.keys() and len(g_w) > 100,
           f"{label}: trainable leaves")
    errs = {n: grad_rel(n, g_g[n], g_w[n], g_w) for n in g_w}
    apart = {n for n in errs if relu_fed_apart and RELU_FED.search(n)}
    worst = max(set(errs) - apart, key=errs.get)
    e_loss = abs(l_g - l_w) / abs(l_w)
    e_stats = max(((s_g[k] - s_w[k]).abs() / (1.0 + s_w[k].abs())).max()
                  .item() for k in s_w)
    equal = sum(torch.equal(g_g[n], g_w[n]) for n in g_w)
    msg = (f"  {label}: loss rel {e_loss:.3g} (tol {TOL_MULTI_LOSS}), "
           f"gradient rel L2 max {errs[worst]:.3g} at {worst} (tol "
           f"{grad_tol}, {len(errs) - len(apart)} leaves, {equal} of "
           f"{len(errs)} bit-equal)")
    if apart:
        worst_relu = max(apart, key=errs.get)
        msg += (f", {errs[worst_relu]:.3g} at {worst_relu} (tol "
                f"{TOL_TRAIN_GRAD_RELU}, {len(apart)} ReLU-fed stem leaves)")
        expect(len(apart) == 72, f"{len(apart)} ReLU-fed stem leaves")
        expect(errs[worst_relu] <= TOL_TRAIN_GRAD_RELU,
               f"{label}: gradient of {worst_relu}")
    log(msg + f", BatchNorm statistics max err {e_stats:.3g} (tol "
        f"{TOL_MULTI_STATS})")
    expect(e_loss <= TOL_MULTI_LOSS, f"{label}: loss")
    expect(errs[worst] <= grad_tol, f"{label}: gradient of {worst}")
    expect(e_stats <= TOL_MULTI_STATS, f"{label}: BatchNorm statistics")


def phase_multi_gpu(results, card: str):
    """`parallel.dryrun.entry()`'s loss; then part 1: NCCL at world size 1
    in this process (sharded generation, the fp32 step of each mode
    against the step without a group, bf16 ms/step of each mode); part 2:
    two ranks on this one card over gloo (NCCL refuses two ranks on one
    device)."""
    import tempfile

    import torch
    from prismer_tpu_torch.models.caption import (build_generate_fn,
                                                  build_sharded_generate_fn)
    from prismer_tpu_torch.parallel import runtime
    from prismer_tpu_torch.parallel.mesh import make_mesh
    from prismer_tpu_torch.train import build_train_step

    from prismer_tpu_torch.parallel import dryrun

    fwd, args = dryrun.entry("cuda")
    loss = float(fwd(*args))
    log(f"  parallel.dryrun.entry(): BASE bf16 caption loss {loss:.4f}")
    expect(math.isfinite(loss), "entry() loss not finite")
    del fwd, args
    torch.cuda.empty_cache()

    wrap = wrappers()
    per_path = {}
    _open_group("cuda", "nccl")
    try:
        mesh = make_mesh(device="cuda")
        cfg, model, requests = serve_setup()
        req = requests[0]
        want = build_generate_fn(model)(*req)
        for fn in wrap.values():
            fn.launches = 0
        got = build_sharded_generate_fn(model, mesh)(*req)
        torch.cuda.synchronize()
        per_path["sharded generate"] = {n: wrap[n].launches
                                        for n in SERVE_KERNELS}
        log(f"  NCCL world 1, bf16 batch 8: sharded ids equal one "
            f"process's {torch.equal(got, want)}; launches " + ", ".join(
                f"{n}={c}" for n, c in per_path["sharded generate"].items()))
        expect(torch.equal(got, want), "sharded generate ids differ")
        expect(all(per_path["sharded generate"].values()),
               "a serving kernel did not launch in sharded generate")

        gen = torch.Generator().manual_seed(SEED + 11)
        batch = caption_batch(slice_config("float32"), 2, gen, "cpu")
        batch = _to_cuda(batch)
        ref = _fp32_step_record(None, None, batch)
        torch.cuda.empty_cache()
        for mode in MULTI_MODES:
            _check_step(f"fp32 step batch 2, {mode} at world 1 vs no group",
                        _fp32_step_record(mode, mesh, batch), ref)
            torch.cuda.empty_cache()

        cfg16 = slice_config("bfloat16")
        b4 = caption_batch(cfg16, 4, torch.Generator(device="cuda")
                           .manual_seed(SEED + 12), "cuda")
        first = {}
        for mode in (None,) + MULTI_MODES:
            state = train_state(cfg16, "cuda", TRAIN_LR)
            step = build_train_step(state.model, None if mode is None
                                    else mesh, mode or "dp")
            torch.cuda.reset_peak_memory_stats()
            first[mode] = _step_record(step, state, b4)
            timed_steps(step, state, b4, 1)
            for fn in wrap.values():
                fn.launches = 0
            losses, times = timed_steps(step, state, b4, MULTI_TIMED_STEPS)
            label = mode or "no group"
            per_path[f"train {label}"] = counts = {
                n: wrap[n].launches for n in TRAIN_KERNELS}
            ms = statistics.median(times)
            log(f"  bf16 train step batch 4, {label}: {ms:.1f} ms/step "
                f"(median of {' '.join(f'{t:.1f}' for t in times)}), peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
                f"losses finite {all(map(math.isfinite, losses))}; launches "
                f"a step " + ", ".join(
                    f"{n}={c / MULTI_TIMED_STEPS:g}"
                    for n, c in counts.items()) + f" ({card})")
            expect(all(map(math.isfinite, losses)), f"{label}: loss")
            expect(all(counts.values()), f"{label}: a training kernel did "
                   f"not launch: {counts}")
            del state, step
            torch.cuda.empty_cache()
        # the first of those steps: zero2 and zero3 against dp; dp against
        # the step without a group shows what the same step gives twice
        for mode, ref in (("dp", None), ("zero2", "dp"), ("zero3", "dp")):
            _check_step(f"bf16 step batch 4, {mode} vs {ref or 'no group'} "
                        "at world 1", first[mode], first[ref],
                        grad_tol=TOL_MULTI_GRAD_BF16)
        del first
    finally:
        runtime.shutdown()
    for name in set(SERVE_KERNELS) | set(TRAIN_KERNELS):
        results[name]["launches_multi_gpu"] = {
            path: counts[name] for path, counts in per_path.items()
            if name in counts}

    # part 2: two ranks, gloo, this card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks = runtime.spawn(_multi_gpu_rank, 2, "cuda", d, backend="gloo",
                              timeout=600)
    for r, rec in enumerate(ranks):
        log(f"  gloo rank {r} of 2 on this card: own rows' ids equal one "
            f"process's on them {rec['own_equal']}, gathered in rank order "
            f"{rec['in_order']}; launches " + ", ".join(
                f"{n}={c}" for n, c in rec["launches"].items()))
        expect(rec["own_equal"] and rec["in_order"],
               f"rank {r}: sharded ids")
        expect(all(rec["launches"].values()),
               f"rank {r}: a serving kernel did not launch")
    r0 = ranks[0]
    log(f"  against one process on the whole batch 8 (not a gate: cuBLAS "
        f"picks its algorithm by shape): {r0['agree']} of 8 samples agree, "
        f"largest first-step logit difference {r0['logit_diff']:.3g}")
    _check_step("fp32 dp step batch 4 at 2 gloo ranks (BatchNorm synced, "
                "dropout rows) vs one process", r0["dp"], r0["one"],
                relu_fed_apart=True)
    log("  zero2, zero3 and tensor parallelism at 2 ranks need all_gather / "
        "reduce_scatter, which gloo lacks for CUDA tensors: they are held "
        "on the CPU (tests/test_torch_parallel_*.py) and at world size 1 "
        f"above; part 2 took {time.perf_counter() - t0:.1f} s")


def _to_cuda(x, device="cuda"):
    if isinstance(x, dict):
        return {k: _to_cuda(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cuda(v, device) for v in x)
    return x.to(device)


def _multi_gpu_rank():
    """One of two ranks on one card over gloo (phase multi-gpu, part 2)."""
    import dataclasses

    import torch
    from prismer_tpu_torch.models.caption import (build_generate_fn,
                                                  build_sharded_generate_fn)
    from prismer_tpu_torch.ops import _build
    from prismer_tpu_torch.parallel import runtime
    from prismer_tpu_torch.parallel.mesh import (batch_rows, make_mesh,
                                                 shard_batch)
    from prismer_tpu_torch.train import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.kernels()                 # the library phase build built
    mesh = make_mesh(device="cuda")
    wrap = wrappers()
    cfg, model, requests = serve_setup()
    raw, prompt, mask = requests[0]
    rows = batch_rows(prompt.shape[0], mesh)
    for fn in wrap.values():
        fn.launches = 0
    got = build_sharded_generate_fn(model, mesh)(raw, prompt, mask)
    torch.cuda.synchronize()
    out = {"launches": {n: wrap[n].launches for n in SERVE_KERNELS}}
    one = build_generate_fn(model)
    own = one(shard_batch(raw, mesh), prompt[rows], mask[rows])
    whole = one(raw, prompt, mask)
    out["own_equal"] = torch.equal(got[rows], own)
    gathered = runtime.all_gather_object(got.cpu())
    out["in_order"] = all(torch.equal(g, gathered[0]) for g in gathered)
    out["agree"] = int((got == whole).all(dim=1).sum())
    with torch.no_grad():
        from prismer_tpu_torch.data.device import materialize_experts
        from prismer_tpu_torch.models.prismer import compute_dtype
        dt = compute_dtype(cfg)
        enc_all = model.encode(materialize_experts(raw, dt))
        enc_own = model.encode(materialize_experts(shard_batch(raw, mesh),
                                                   dt))
        lg_all = model.decode_logits(prompt, mask, enc_all)[rows]
        lg_own = model.decode_logits(prompt[rows], mask[rows], enc_own)
        out["logit_diff"] = (lg_all - lg_own).abs().max().item()
    del model
    _SERVE.clear()
    torch.cuda.empty_cache()

    cfg32 = slice_config("float32")
    batch = _to_cuda(caption_batch(cfg32, 4, torch.Generator()
                                   .manual_seed(SEED + 13), "cpu"))
    records = {}
    for name, m in (("dp", mesh), ("one", None)):
        state = train_state(cfg32, "cuda", 5e-5)
        step = build_train_step(state.model, m, "dp")
        records[name] = _step_record(step, state, shard_batch(batch, mesh)
                                     if m is not None else batch)
        del state, step
        torch.cuda.empty_cache()
    if runtime.rank() == 0:
        out.update(records)
    return out


# ---------------------------------------------------------------------------
# devices and threads: every kernel on any card of the process and from any
# thread (ops/_build.py `launch_device`, per-device grants and locked
# tensor-map caches in csrc/); the PNG kinds and the decoded-label cache
# ---------------------------------------------------------------------------

THREAD_REQUESTS = 5      # requests each serving thread makes
THREAD_STEPS = 3         # train steps each training thread takes


def _serve_ids(generate, req):
    """The ids of one request, on the CPU, after its stream has finished."""
    import torch
    ids = generate(*req)
    torch.cuda.current_stream(ids.device).synchronize()
    return ids.cpu()


def _launch_counts(names) -> dict:
    wrap = wrappers()
    return {n: wrap[n].launches for n in names}


def _zero_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def phase_devices(results, card: str):
    """With two or more cards: BASE bf16 captioning at batch 8 on cuda:1
    from a process whose current device is 0 gives the ids of cuda:0;
    requests alternating between the cards from one process give the same
    ids; one bf16 train step at batch 4 on cuda:1 gives cuda:0's loss bit
    for bit (no kernel uses float atomics); kernels 1-5 and 6-9 launch on
    each card; the current device is 0 afterwards. On one card it logs
    that it did not run."""
    import torch
    from prismer_tpu_torch.models.caption import build_generate_fn
    from prismer_tpu_torch.models.prismer import build_random_prismer
    from prismer_tpu_torch.train import build_train_step

    n = torch.cuda.device_count()
    if n < 2:
        log(f"  devices: not run ({n} card)")
        return
    torch.cuda.set_device(0)
    cfg, model0, requests = serve_setup()
    model1 = build_random_prismer(cfg, SEED, "cuda:1")
    gen0, gen1 = build_generate_fn(model0), build_generate_fn(model1)
    reqs0 = requests[:3]
    reqs1 = [_to_cuda(r, "cuda:1") for r in reqs0]
    per_card = {}
    _zero_counts()
    want = [_serve_ids(gen0, r) for r in reqs0]
    per_card["serve cuda:0"] = _launch_counts(SERVE_KERNELS)
    _zero_counts()
    got1 = [_serve_ids(gen1, r) for r in reqs1]
    per_card["serve cuda:1"] = _launch_counts(SERVE_KERNELS)
    expect(torch.cuda.current_device() == 0, "serving on cuda:1 changed the "
           "current device")
    for i, (g, w) in enumerate(zip(got1, want)):
        expect(torch.equal(g, w), f"request {i}: cuda:1 ids differ from "
               "cuda:0's")
    alternating = []
    for i in range(2 * len(reqs0)):
        gen, reqs = (gen0, reqs0) if i % 2 == 0 else (gen1, reqs1)
        alternating.append(torch.equal(_serve_ids(gen, reqs[i // 2]),
                                       want[i // 2]))
    expect(all(alternating), f"alternating requests: equal {alternating}")
    log(f"  BASE bf16 batch 8 on cuda:1 from current device 0: ids of "
        f"{len(reqs0)} requests equal cuda:0's; {len(alternating)} requests "
        f"alternating cuda:0 / cuda:1 equal; sample ids {got1[0][0].tolist()}")
    del gen1, model1
    torch.cuda.empty_cache()

    batch0 = caption_batch(cfg, 4, torch.Generator(device="cuda")
                           .manual_seed(SEED + 31), "cuda")
    losses = {}
    for dev in ("cuda:0", "cuda:1"):
        state = train_state(cfg, dev, TRAIN_LR)
        step = build_train_step(state.model)
        _zero_counts()
        _, metrics = step(state, _to_cuda(batch0, dev))
        losses[dev] = float(metrics["loss"])
        per_card[f"train {dev}"] = _launch_counts(TRAIN_KERNELS)
        del state, step
        torch.cuda.empty_cache()
    log(f"  one bf16 train step at batch 4: loss cuda:0 "
        f"{losses['cuda:0']!r}, cuda:1 {losses['cuda:1']!r}")
    expect(losses["cuda:0"] == losses["cuda:1"], "train loss differs "
           "between the cards")
    for path, counts in per_card.items():
        log(f"  launches, {path}: " + ", ".join(
            f"{k}={v}" for k, v in counts.items()))
        expect(all(counts.values()), f"{path}: a kernel did not launch")
    expect(torch.cuda.current_device() == 0, "the current device moved")
    log(f"  current device after the phase: {torch.cuda.current_device()} "
        f"of {n} cards ({card})")
    for name in set(SERVE_KERNELS) | set(TRAIN_KERNELS):
        results[name]["launches_devices"] = {
            path: c[name] for path, c in per_card.items() if name in c}


def _in_threads(work, streams):
    """Run work[i](i) in thread i on streams[i], all started together;
    their results, or the first exception re-raised."""
    import threading

    import torch
    out, errors = [None] * len(work), []
    start = threading.Barrier(len(work))

    def run(i):
        try:
            start.wait()
            with torch.cuda.stream(streams[i]):
                out[i] = work[i](i)
        except BaseException as e:           # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(work))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.masters.items()},
            state.generator.get_state(), state.step)


def _restore(state, snap) -> None:
    """The state as `_snapshot` took it, AdamW's moments cleared (the
    snapshot is taken before the first step)."""
    model, masters, gen, step = snap
    state.model.load_state_dict(model)
    for k, v in masters.items():
        state.masters[k].copy_(v)
    state.generator.set_state(gen)
    state.step = step
    state.optimizer.state.clear()


def phase_threads(results, card: str):
    """Two Python threads, each on its own CUDA stream, serve two different
    BASE bf16 batch-8 requests THREAD_REQUESTS times each, at once, through
    one model: every result equals the serial run's ids. Then two threads
    each take THREAD_STEPS bf16 train steps at batch 4 on a model of their
    own at once: the losses equal the same steps run one thread after the
    other (kernels 6-9)."""
    import torch
    from prismer_tpu_torch.models.caption import build_generate_fn
    from prismer_tpu_torch.train import build_train_step

    cfg, model, requests = serve_setup()
    generate = build_generate_fn(model)
    reqs = requests[:2]
    want = [_serve_ids(generate, r) for r in reqs]
    t0 = time.perf_counter()
    for r in reqs:
        for _ in range(THREAD_REQUESTS):
            _serve_ids(generate, r)
    serial_s = time.perf_counter() - t0
    streams = [torch.cuda.Stream() for _ in reqs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    _zero_counts()
    t0 = time.perf_counter()
    got = _in_threads([lambda i: [_serve_ids(generate, reqs[i])
                                  for _ in range(THREAD_REQUESTS)]] * 2,
                      streams)
    wall = time.perf_counter() - t0
    counts = _launch_counts(SERVE_KERNELS)
    equal = [[torch.equal(g, want[i]) for g in got[i]] for i in range(2)]
    log(f"  2 threads x {THREAD_REQUESTS} BASE bf16 batch-8 requests at "
        f"once through one model: ids equal the serial run's {equal}; "
        f"{wall:.3f} s wall, the same {2 * THREAD_REQUESTS} requests one "
        f"after another {serial_s:.3f} s; launches " + ", ".join(
            f"{k}={v}" for k, v in counts.items()))
    expect(all(map(all, equal)), "threaded serving ids differ from serial")
    expect(all(counts.values()), f"threaded serving launches {counts}")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    batches = [caption_batch(cfg, 4, gen, "cuda") for _ in range(2)]
    states = [train_state(cfg, "cuda", TRAIN_LR) for _ in range(2)]
    steps = [build_train_step(st.model) for st in states]
    snaps = [_snapshot(st) for st in states]

    def train(i):
        return [float(steps[i](states[i], batches[i])[1]["loss"])
                for _ in range(THREAD_STEPS)]

    serial = [train(i) for i in range(2)]
    for st, snap in zip(states, snaps):
        _restore(st, snap)
    torch.cuda.synchronize()
    _zero_counts()
    threaded = _in_threads([train] * 2, streams)
    counts = _launch_counts(TRAIN_KERNELS)
    log(f"  2 threads x {THREAD_STEPS} bf16 train steps at batch 4 on a "
        f"model each, at once: losses {threaded}, serial {serial}; "
        f"launches " + ", ".join(f"{k}={v}" for k, v in counts.items())
        + f" ({card})")
    expect(threaded == serial, "threaded train losses differ from serial")
    expect(all(counts.values()), f"threaded train launches {counts}")
    _FILES["spare_state"] = states[0]     # phase "label cache" trains it
    del states, steps, snaps
    torch.cuda.empty_cache()


PNG_FIXTURES = ROOT / "tests" / "data" / "png"
CACHE_BATCHES = 1        # batches compared with the label cache off and on


def phase_png(results, card: str):
    """Every PNG fixture (tests/data/png: each colour type and bit depth,
    plain and Adam7) decoded by data/png.py in "L", "RGB" and the file's
    own mode to the sha256 Pillow gave where it was written."""
    import hashlib

    import numpy as np
    from prismer_tpu_torch.data import png

    expected = json.loads((PNG_FIXTURES / "expected.json").read_text())
    t0 = time.perf_counter()
    for name, e in sorted(expected["files"].items()):
        data = (PNG_FIXTURES / name).read_bytes()
        for mode, key in (("L", "L"), ("RGB", "RGB"), (None, "own")):
            px = png.decode_png(data, mode)
            if px.dtype == np.bool_:           # hashed as 0 / 1 bytes
                px = px.astype(np.uint8)
            digest = hashlib.sha256(px.tobytes()).hexdigest()
            expect(list(px.shape) == e[key]["shape"]
                   and digest == e[key]["sha256"],
                   f"{name} {key}: {px.shape} sha256 {digest[:12]}, Pillow "
                   f"gave {e[key]['shape']} {e[key]['sha256'][:12]}")
    log(f"  {len(expected['files'])} fixtures x 3 modes decode to the "
        f"pixels of Pillow {expected['pillow']} (sha256 equal) in "
        f"{time.perf_counter() - t0:.2f} s ({host_cpu()})")


def phase_label_cache(results, card: str):
    """The "data" tree read with PRISMER_LABEL_CACHE in a temporary
    directory: records/s of an epoch through the loader (min(8, cores)
    forked workers) with the cache off, cold (writing) and warm; the first
    CACHE_BATCHES batches of records read in order from one seed in this
    process and collated as the loader does, cache off and warm,
    bit-equal; then
    FILES_STEPS bf16 BASE train steps at batch 16 fed warm (ms/step and
    the device's idle share, as phase "train from files" measures them).
    A record, not a claim."""
    import os
    import random
    import shutil
    import tempfile

    import torch
    from prismer_tpu_torch.data import create_loader
    from prismer_tpu_torch.data.loader import default_collate
    from prismer_tpu_torch.train import build_train_step

    train_ds = _FILES["train_ds"]
    cache = tempfile.mkdtemp(prefix="label_cache_", dir=ROOT / "build")
    atexit.register(shutil.rmtree, cache, True)

    def set_cache(on: bool) -> None:
        if on:
            os.environ["PRISMER_LABEL_CACHE"] = cache
        else:
            os.environ.pop("PRISMER_LABEL_CACHE", None)

    def epoch() -> float:
        loader = create_loader(train_ds, FILES_BATCH,
                               num_workers=_FILES["workers"], train=True)
        t0 = time.perf_counter()
        n = sum(len(b["caption"]) for b in loader)
        return n / (time.perf_counter() - t0)

    def records() -> list:   # the first CACHE_BATCHES batches, in order
        random.seed(SEED)
        return [default_collate([train_ds[i] for i in range(
            b * FILES_BATCH, (b + 1) * FILES_BATCH)])
            for b in range(CACHE_BATCHES)]

    try:
        set_cache(False)
        off = epoch()
        want = records()
        set_cache(True)
        cold = epoch()
        entries = sum(len(f) for _, _, f in os.walk(cache))
        warm = epoch()
        got = records()
        same = all(_same_batch(g, w) for g, w in zip(got, want)) and \
            len(got) == len(want)
        log(f"  records/s over an epoch of {len(train_ds)}, batch "
            f"{FILES_BATCH}, {_FILES['workers']} forked workers: cache off "
            f"{off:.1f}, cold {cold:.1f} (wrote {entries} entries), warm "
            f"{warm:.1f}; per worker {off / _FILES['workers']:.1f} / "
            f"{cold / _FILES['workers']:.1f} / {warm / _FILES['workers']:.1f}"
            f" ({host_cpu()})")
        log(f"  {len(got)} batch(es) of {FILES_BATCH} records read in order, "
            f"cache warm vs off: bit-equal {same}")
        expect(same, "batches with the label cache differ from without")
        expect(entries == len(train_ds) * len(FILES_EXPERTS),
               f"{entries} cache entries")

        cfg = slice_config("bfloat16")
        state = (_FILES.pop("spare_state", None)
                 or train_state(cfg, "cuda", TRAIN_LR))
        run = file_fed_steps(cfg, state, build_train_step(state.model))
    finally:
        set_cache(False)
    n = FILES_STEPS - 1
    wall, busy = run["wall"], run["busy"]
    log(f"  bf16 BASE batch {FILES_BATCH} fed warm: steps 2-{FILES_STEPS} "
        f"{wall / n:.1f} ms/step, {FILES_BATCH * 1000.0 * n / wall:.1f} "
        f"images/s, idle share {1 - busy / wall:.3f}; losses "
        + " ".join(f"{x:.4f}" for x in run["losses"])
        + f" ({_FILES['workers']} loader workers; {host_cpu()}; {card})")
    expect(all(map(math.isfinite, run["losses"])), "train loss not finite")
    expect(all(run["counts"].values()), f"launches {run['counts']}")
    del state, run
    torch.cuda.empty_cache()


def _same_batch(got, want) -> bool:
    """Two collated batches: equal keys, and every array bit-equal."""
    import numpy as np
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(_same_batch(got[k], want[k]) for k in want))
    if isinstance(want, np.ndarray):
        return (isinstance(got, np.ndarray) and got.dtype == want.dtype
                and np.array_equal(got, want))
    return got == want


class _Int8Steps:
    """The int8 fused step's launch count (kernel 4b), which the
    fused_decode_step wrapper keeps apart from kernel 4's."""

    @property
    def launches(self):
        from prismer_tpu_torch.ops import fused_decode as fd
        return fd.fused_decode_step.int8_launches

    @launches.setter
    def launches(self, value):
        from prismer_tpu_torch.ops import fused_decode as fd
        fd.fused_decode_step.int8_launches = value


def wrappers():
    from prismer_tpu_torch.experts.ops import deform_attn as da
    from prismer_tpu_torch.ops import beam_update as bu
    from prismer_tpu_torch.ops import decode_attention as dca
    from prismer_tpu_torch.ops import flash_attention as fa
    from prismer_tpu_torch.ops import fused_ce as fc
    from prismer_tpu_torch.ops import fused_decode as fd
    from prismer_tpu_torch.ops import layer_norm as ln
    from prismer_tpu_torch.ops import lm_topk as lt
    from prismer_tpu_torch.ops import ln_proj as lp
    return {"flash_attention_packed": fa.flash_attention_packed,
            "flash_attention": fa.flash_attention,
            "beam_update": bu.beam_update,
            "fused_decode_step": fd.fused_decode_step,
            "lm_topk": lt.lm_topk,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "ce_stats": fc.ce_stats,
            "ce_grads": fc.ce_grads,
            "ms_deform_attn": da.ms_deform_attn,
            "fused_layer_norm": ln.fused_layer_norm,
            "ln_proj": lp.ln_proj,
            "adaptor_fused": lp.adaptor_fused,
            "grouped_cross_attention": dca.grouped_cross_attention,
            "grouped_decode_attention": dca.grouped_decode_attention,
            "fused_decode_step_int8": _Int8Steps()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one batch-8 request on each decode "
                        "path, one train step and one batch-16 "
                        "segmentation forward")
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

    # phase 0: card and settings. The parity phases compare fp32 on the card
    # with the CPU, so TF32 is off until the segmentation generator, which
    # runs with torch's defaults and pins fp32 itself
    card = card_info()
    log(f"card: {card}")
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    results = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "launches": 0, "max_abs_err": 0.0,
                      "ms": None, "plain_ms": None, "bound_ms": None,
                      "bound_by": None, "library_ms": None}
               for name, src, rep in KERNELS}
    phases = (("build", phase_build), ("kernels", phase_kernels),
              ("slice parity", phase_slice_parity),
              ("fused parity", phase_fused_parity),
              ("serve", lambda r: phase_serve(r, card, args.profile)),
              ("serve fused off",
               lambda r: phase_serve_per_layer(r, card, args.profile)),
              ("ln_proj parity", phase_ln_proj_parity),
              ("serve ln_proj",
               lambda r: phase_serve_ln_proj(r, card, args.profile)),
              ("decode cross parity", phase_decode_cross_parity),
              ("serve decode cross",
               lambda r: phase_serve_decode_cross(r, card, args.profile)),
              ("kv quant parity", phase_kv_quant_parity),
              ("serve large",
               lambda r: phase_serve_large(r, card, args.profile)),
              ("serve huge",
               lambda r: phase_serve_huge(r, card, args.profile)),
              ("vqa parity", phase_vqa_parity),
              ("serve vqa rank",
               lambda r: phase_serve_vqa_rank(r, card, args.profile)),
              ("serve vqa generate",
               lambda r: phase_serve_vqa_generate(r, card, args.profile)),
              ("convert", lambda r: phase_convert(r, card)),
              ("train parity", phase_train_parity),
              ("train", lambda r: phase_train(r, card, args.profile)),
              ("jpeg", lambda r: phase_jpeg(r, card)),
              ("data", lambda r: phase_data(r, card)),
              ("train from files", lambda r: phase_train_from_files(r, card)),
              ("eval from files", lambda r: phase_eval_from_files(r, card)),
              ("cli caption", lambda r: phase_cli_caption(r, card)),
              ("cli vqa", lambda r: phase_cli_vqa(r, card)),
              ("cli classification",
               lambda r: phase_cli_classification(r, card)),
              ("cli pretrain", lambda r: phase_cli_pretrain(r, card)),
              ("cli demo", lambda r: phase_cli_demo(r, card)),
              ("segment parity", phase_segment_parity),
              ("segment", lambda r: phase_segment(r, card, args.profile,
                                                  tf32_defaults)),
              ("segment jpeg", lambda r: phase_segment_jpeg(r, card)),
              ("image formats", lambda r: phase_image_formats(r, card)),
              ("experts parity", phase_experts_parity),
              ("experts generate", lambda r: phase_experts_generate(r, card)),
              ("experts demo", lambda r: phase_experts_demo(r, card)),
              ("multi-gpu", lambda r: phase_multi_gpu(r, card)),
              ("devices", lambda r: phase_devices(r, card)),
              ("threads", lambda r: phase_threads(r, card)),
              ("png", lambda r: phase_png(r, card)),
              ("label cache", lambda r: phase_label_cache(r, card)))
    t_experts = 0.0
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn(results)
        except Failed as e:
            log(f"FAILED phase {name}: {e}")
            return 1
        log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")
        if name.startswith("experts "):
            t_experts += time.perf_counter() - t0
    log(f"the three experts phases: {t_experts:.1f} s")
    log(card)
    log(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase_build(results):
    from prismer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    start_ptxas()
    lib = _build.build()
    _build.kernels()
    log(f"  built and loaded {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_kernels(results):
    check_attention(results)
    check_beam_update(results)
    check_fused_decode(results)
    check_lm_topk(results)
    check_flash_backward(results)
    check_fused_ce(results)
    check_ms_deform_attn(results)
    check_layer_norm(results)
    check_ln_proj(results)
    check_adaptor_fused(results)
    check_fused_decode_huge(results)
    check_decode_attention(results)


if __name__ == "__main__":
    sys.exit(main())
