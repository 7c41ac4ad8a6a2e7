"""Fused decode step: the CUDA kernel's wrapper, the weight packing and the
plain version.

Port of prismer_tpu/ops/fused_decode.py (`pack_decode_weights`,
`fused_decode_step` with its `flat_beam` fold). The kernel is
`csrc/fused_decode.cu`; its header note says what it replaces, what bounds
it on the H100 and how it is built. `fused_decode_step` launches the kernel
for CUDA tensors and computes `fused_decode_step_reference` for tensors on
the CPU. Launches are counted in `fused_decode_step.launches` (one per step),
those with int8 cross K/V in `fused_decode_step.int8_launches`.

One step is a fixed sequence of kernels on the caller's stream,
`step_launches(nlc)` of them (126 at Prismer-BASE, 246 at LARGE and HUGE),
each launched with programmatic dependent launch so that it becomes
resident while the one before it runs. Each LayerNorm but the last runs
inside the projection that reads it. A bf16 projection is the wgmma kernel
on a TMA weight ring; `dense_plan` mirrors the C entry's launch shape for it
(64 output columns a block, K split over a cluster of up to 8 blocks, the
ring's depth, shared memory).

Layouts (the port's own):
  * hidden (N, D), N = B * beams rows;
  * self caches (NL, T, N, D): a step's column is one contiguous (N, D) slab;
  * cross K/V natural and unpadded, (NLc, B, L, D), shared by a sample's
    beams; NL = NLc + 1 (the output layer has no cross-attention);
  * weights packed into one flat tensor in the compute dtype, per layer and
    in layer order, each matrix in nn.Linear (out, in) layout, and biases
    plus LayerNorm parameters into one flat fp32 tensor (`layer_layout`).
The TPU layout's head/tail weight split, chunked W2, zero cross slots of the
output layer, 8-row beam padding and lane-padded cross K^T are not carried
over.

int8 cross K/V (the JAX package's `PRISMER_KV_QUANT=int8`, kernel 4b; off
by default there and here, `models.roberta.set_kv_quant`): `quantize_kv`
turns each layer's (B, L, D) cross K or V into int8 plus fp32 scales
(B, H), one per (sample, head), as JAX's `quantize_kv_nat` does; the step
takes the int8 (NLc, B, L, D) tensors with their (NLc, B, H) scales
(`cross_ks`, `cross_vs`). The K scale folds into the cross query (fp32
product, rounded to the compute dtype) and the V scale into the normalised
probabilities (fp32 product, rounded), the TPU kernel's rounding points.

Numerics (the JAX kernel's spec, the XLA cached path): dense = fp32
accumulation rounded to the compute dtype, plus the bias in that dtype; LN in
fp32 on x + residual; fp32 softmax, normalised, rounded before the PV
product; attention scores and PV sums exact fp32 from compute-dtype
operands; exact-erf GELU and squared ReLU in fp32, rounded.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e9  # attention mask fill (JAX fused_decode.py:106)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_layout(d: int, f: int, with_cross: bool):
    """One layer's packed layout: ({name: (offset, (rows, cols))} of the
    weights, {name: (offset, size)} of the fp32 biases and LN parameters
    (an LN holds 2*d values, scale then bias), weight size, bias size)."""
    shapes = [("qkv", (3 * d, d)), ("self_out", (d, d))]
    sizes = [("qkv", 3 * d), ("self_out", d), ("ln1", 2 * d)]
    if with_cross:
        shapes += [("cross_q", (d, d)), ("cross_out", (d, d)),
                   ("ad_down", (d, d)), ("ad_up", (d, d))]
        sizes += [("cross_q", d), ("cross_out", d), ("ln2", 2 * d),
                  ("ad_down", d), ("ad_up", d), ("ln_ad", 2 * d)]
    shapes += [("mlp_in", (f, d)), ("mlp_out", (d, f))]
    sizes += [("mlp_in", f), ("mlp_out", d), ("ln3", 2 * d)]
    w, off = {}, 0
    for name, shape in shapes:
        w[name] = (off, shape)
        off += shape[0] * shape[1]
    b, boff = {}, 0
    for name, size in sizes:
        b[name] = (boff, size)
        boff += size
    return w, b, off, boff


# the bf16 projection's launch shape (csrc/fused_decode.cu `dense_plan`):
# 64 output columns a block, 64-wide k tiles, clusters of at most 8 blocks
# splitting K until a launch has 128 blocks, at most 8 weight boxes in
# flight a block, and two blocks an SM (one of the running launch and one
# of the next, resident early under programmatic dependent launch)
PROJ_TILE = 64
PROJ_MAX_STAGES = 8
PROJ_MAX_SPLIT = 8
PROJ_MIN_BLOCKS = 128
PROJ_MAX_ROWS = 64
SM_SMEM = 228 * 1024      # an SM's shared memory, 1 KB of it per block kept
PROJ_SMEM_BUDGET = (SM_SMEM - 2 * 1024) // 2


class DensePlan(NamedTuple):
    col_tiles: int   # 64-column tiles of the M outputs
    rows: int        # rows per row tile: N rounded up to 8..32, 48 or 64
    row_tiles: int   # row tiles of N
    k_tiles: int     # 64-wide tiles of K
    split: int       # blocks per cluster, each a K slice
    slice: int       # k tiles of the largest slice
    stages: int      # weight boxes in flight a block
    smem_bytes: int  # dynamic shared memory a block


def _proj_smem(rows: int, slice_: int, stages: int, split: int) -> int:
    """Ring, input slice, partials (split > 1), the columns' bias and the
    slice's LN parameters (fp32), LN statistics, stage barriers, 1 KB of
    alignment slack."""
    return (stages * PROJ_TILE * PROJ_TILE * 2 + slice_ * rows * 128
            + (PROJ_TILE * rows * 4 if split > 1 else 0) + PROJ_TILE * 4
            + 2 * slice_ * PROJ_TILE * 4 + rows * 8 + stages * 8 + 1024)


def dense_plan(m: int, k: int, n: int) -> DensePlan:
    """The launch shape of the bf16 projection out (n, m) = x (n, k) W^T,
    as the C entry computes it (`dense_plan`; keep the two in step). Rank
    r of a cluster takes k tiles [r * k_tiles // split, (r + 1) * k_tiles
    // split)."""
    col_tiles = -(-m // PROJ_TILE)
    r8 = -(-min(n, PROJ_MAX_ROWS) // 8) * 8
    rows = r8 if r8 <= 32 else (48 if r8 <= 48 else 64)
    row_tiles = -(-n // rows)
    k_tiles = -(-k // PROJ_TILE)
    split = 1
    while (split < PROJ_MAX_SPLIT and 2 * split <= k_tiles
           and col_tiles * row_tiles * split < PROJ_MIN_BLOCKS):
        split *= 2
    slice_ = -(-k_tiles // split)
    stages = min(slice_, PROJ_MAX_STAGES)
    while stages > 2 and _proj_smem(rows, slice_, stages,
                                    split) > PROJ_SMEM_BUDGET:
        stages -= 1
    return DensePlan(col_tiles, rows, row_tiles, k_tiles, split, slice_,
                     stages, _proj_smem(rows, slice_, stages, split))


def step_launches(nlc: int) -> int:
    """Kernels one step launches (csrc/fused_decode.cu `run_step`): 10 per
    cross layer (qkv, self-attention, self-out, cross-q, cross-attention,
    cross-out, adaptor down and up, MLP in and out; each LayerNorm but the
    last runs inside the projection that reads it), 5 for the output layer
    (qkv, self-attention, self-out, MLP in and out) and the final
    LayerNorm."""
    return 10 * nlc + 5 + 1


def packed_sizes(d: int, f: int, nlc: int) -> Tuple[int, int]:
    """(weight elements, bias elements) for nlc cross layers + the output
    layer."""
    _, _, wc, bc = layer_layout(d, f, True)
    _, _, wo, bo = layer_layout(d, f, False)
    return nlc * wc + wo, nlc * bc + bo


def layer_views(w_all: torch.Tensor, b_all: torch.Tensor, d: int, f: int,
                nlc: int) -> List[Dict[str, torch.Tensor]]:
    """Per-layer views into the packed tensors: "w_<name>" (rows, cols) and
    "b_<name>" (size,)."""
    out, woff, boff = [], 0, 0
    for i in range(nlc + 1):
        wl, bl, wsize, bsize = layer_layout(d, f, i < nlc)
        views = {}
        for name, (off, (r, c)) in wl.items():
            views["w_" + name] = w_all[woff + off:woff + off + r * c].view(
                r, c)
        for name, (off, size) in bl.items():
            views["b_" + name] = b_all[boff + off:boff + off + size]
        out.append(views)
        woff += wsize
        boff += bsize
    return out


@torch.no_grad()
def pack_decode_weights(decoder, dtype: torch.dtype
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a port RobertaCausalDecoder's layer weights: (w_all flat in
    `dtype`, b_all flat fp32), on the decoder's device."""
    cfg = decoder.cfg
    layers = decoder.cross_layers() + [decoder.output_layer]
    ws, bs = [], []
    for layer in layers:
        sa, so, mlp = layer.self_attn, layer.self_out, layer.mlp
        mats = [torch.cat([sa.query.weight, sa.key.weight, sa.value.weight]),
                so.dense.weight]
        vecs = [sa.query.bias, sa.key.bias, sa.value.bias, so.dense.bias,
                so.ln.weight, so.ln.bias]
        if layer.with_cross:
            ca, co, ad = layer.cross_attn, layer.cross_out, layer.adaptor
            mats += [ca.query.weight, co.dense.weight, ad.down_proj.weight,
                     ad.up_proj.weight]
            vecs += [ca.query.bias, co.dense.bias, co.ln.weight, co.ln.bias,
                     ad.down_proj.bias, ad.up_proj.bias,
                     ad.adaptor_ln.weight, ad.adaptor_ln.bias]
        mats += [mlp.intermediate.weight, mlp.out.dense.weight]
        vecs += [mlp.intermediate.bias, mlp.out.dense.bias, mlp.out.ln.weight,
                 mlp.out.ln.bias]
        ws += [m.to(dtype).reshape(-1) for m in mats]
        bs += [v.float().reshape(-1) for v in vecs]
    w_all, b_all = torch.cat(ws), torch.cat(bs)
    want = packed_sizes(cfg.hidden_size, cfg.intermediate_size,
                        cfg.num_hidden_layers)
    assert (w_all.numel(), b_all.numel()) == want, (w_all.shape, want)
    return w_all, b_all


def quantize_kv(x: torch.Tensor, heads: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of natural-layout cross K or V (B, L, D)
    with one fp32 scale per (sample, head): scale = max(amax over (L, Dh),
    1e-30) / 127, q = clip(round(x / scale), -127, 127), a true division,
    round half to even (JAX `quantize_kv_nat`). Returns (q int8 (B, L, D),
    scale fp32 (B, H))."""
    b, l, d = x.shape
    x4 = x.float().view(b, l, heads, d // heads)
    amax = x4.abs().amax(dim=(1, 3))
    scale = amax.clamp_min(1e-30) / 127.0
    q = torch.round(x4 / scale[:, None, :, None]).clamp_(-127, 127)
    return q.to(torch.int8).view(b, l, d), scale


def _dims(hidden0, w_all, b_all, self_k, cross_k, heads):
    n, d = hidden0.shape
    nl, t = self_k.shape[0], self_k.shape[1]
    nlc, b, l_enc = cross_k.shape[0], cross_k.shape[1], cross_k.shape[2]
    # w_all = nlc (8 d^2 + 2 f d) + 4 d^2 + 2 f d
    f = (w_all.numel() - (8 * nlc + 4) * d * d) // (2 * d * (nlc + 1))
    if (nl != nlc + 1 or n % b or d % heads
            or packed_sizes(d, f, nlc) != (w_all.numel(), b_all.numel())
            or tuple(self_k.shape) != (nl, t, n, d)
            or tuple(cross_k.shape) != (nlc, b, l_enc, d)):
        raise ValueError(
            f"fused_decode_step: hidden {tuple(hidden0.shape)} w_all "
            f"{w_all.numel()} b_all {b_all.numel()} self_k "
            f"{tuple(self_k.shape)} cross_k {tuple(cross_k.shape)} heads "
            f"{heads}")
    return n, d, f, nl, nlc, t, b, l_enc


def _dense(x, w, b):
    """flax Dense(dtype): fp32 sum rounded to the compute dtype, + bias in
    that dtype. w is (out, in)."""
    return (x.float() @ w.float().t()).to(x.dtype) + b.to(x.dtype)


def _ln(o, res, sb, eps):
    """fp32 LayerNorm of o + res (two-pass statistics), rounded."""
    d = o.shape[-1]
    x = o.float() + res.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps) * sb[:d] + sb[d:]
    return y.to(o.dtype)


def _check_scales(cross_k, cross_v, cross_ks, cross_vs, b, heads):
    """Raise unless int8 cross K/V come with (NLc, B, H) fp32 scales, or
    compute-dtype ones without."""
    quant = cross_k.dtype == torch.int8
    if cross_v.dtype != cross_k.dtype:
        raise ValueError(f"fused_decode_step: cross_k {cross_k.dtype}, "
                         f"cross_v {cross_v.dtype}")
    if not quant:
        if cross_ks is not None or cross_vs is not None:
            raise ValueError("fused_decode_step: scales given with "
                             f"{cross_k.dtype} cross K/V (int8 only)")
        return False
    want = (cross_k.shape[0], b, heads)
    for name, t in (("cross_ks", cross_ks), ("cross_vs", cross_vs)):
        if t is None or tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"fused_decode_step: int8 cross K/V need "
                             f"{name} fp32 {want}; got "
                             f"{None if t is None else (t.dtype, tuple(t.shape))}")
    return True


@torch.no_grad()
def fused_decode_step_reference(
        hidden0: torch.Tensor, w_all: torch.Tensor, b_all: torch.Tensor,
        self_k: torch.Tensor, self_v: torch.Tensor, key_mask: torch.Tensor,
        cross_k: torch.Tensor, cross_v: torch.Tensor, index: int,
        flat_beam: Optional[torch.Tensor] = None,
        out_k: Optional[torch.Tensor] = None,
        out_v: Optional[torch.Tensor] = None, *, heads: int,
        eps: float = 1e-5, cross_ks: Optional[torch.Tensor] = None,
        cross_vs: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The plain version of `fused_decode_step` (same arguments, same
    results, same in-place writes)."""
    n, d, f, nl, nlc, t, b, l_enc = _dims(hidden0, w_all, b_all, self_k,
                                          cross_k, heads)
    quant = _check_scales(cross_k, cross_v, cross_ks, cross_vs, b, heads)
    dtype = hidden0.dtype
    dh = d // heads
    beams = n // b
    scale = 1.0 / math.sqrt(dh)
    if flat_beam is None:
        out_k, out_v = self_k, self_v
    elif out_k is None:
        out_k, out_v = torch.empty_like(self_k), torch.empty_like(self_v)
    bias = ((1.0 - key_mask.float()) * NEG_INF)[:, None, :]      # (N, 1, T)
    k_new = torch.empty((nl, n, d), dtype=dtype, device=hidden0.device)
    v_new = torch.empty_like(k_new)
    x = hidden0
    for i, p in enumerate(layer_views(w_all, b_all, d, f, nlc)):
        qkv = _dense(x, p["w_qkv"], p["b_qkv"])
        q, k_new[i], v_new[i] = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
        if flat_beam is not None:
            # permute into the second buffer, then write the fresh column
            out_k[i] = self_k[i][:, flat_beam.long()]
            out_v[i] = self_v[i][:, flat_beam.long()]
        out_k[i, index] = k_new[i]
        out_v[i, index] = v_new[i]
        ck = out_k[i].float().view(t, n, heads, dh)
        cv = out_v[i].float().view(t, n, heads, dh)
        s = torch.einsum("nhd,tnhd->nht", q.float().view(n, heads, dh),
                         ck) * scale + bias
        pr = torch.softmax(s, dim=-1).to(dtype)
        att = torch.einsum("nht,tnhd->nhd", pr.float(), cv).to(dtype)
        o = _dense(att.reshape(n, d), p["w_self_out"], p["b_self_out"])
        x = _ln(o, x, p["b_ln1"], eps)
        if i < nlc:
            qc = _dense(x, p["w_cross_q"], p["b_cross_q"]).float()
            qc = qc.view(b, beams, heads, dh)
            kc = cross_k[i].float().view(b, l_enc, heads, dh)
            vc = cross_v[i].float().view(b, l_enc, heads, dh)
            if quant:   # the K scale into q, rounded (int8 K widens exactly)
                qc = (qc * cross_ks[i][:, None, :, None]).to(dtype).float()
            s = torch.einsum("bkhd,blhd->bkhl", qc, kc) * scale
            pn = torch.softmax(s, dim=-1)
            if quant:   # the V scale into the normalised probabilities
                pn = pn * cross_vs[i][:, None, :, None]
            pr = pn.to(dtype)
            co = torch.einsum("bkhl,blhd->bkhd", pr.float(), vc).to(dtype)
            o = _dense(co.reshape(n, d), p["w_cross_out"], p["b_cross_out"])
            x = _ln(o, x, p["b_ln2"], eps)
            a = _dense(x, p["w_ad_down"], p["b_ad_down"]).float().clamp_min(0)
            u = _dense((a * a).to(dtype), p["w_ad_up"], p["b_ad_up"])
            x = _ln(u, x, p["b_ln_ad"], eps)
        h1 = F.gelu(_dense(x, p["w_mlp_in"], p["b_mlp_in"]).float())
        h2 = _dense(h1.to(dtype), p["w_mlp_out"], p["b_mlp_out"])
        x = _ln(h2, x, p["b_ln3"], eps)
    return x, k_new, v_new, out_k, out_v


def fused_decode_step(hidden0: torch.Tensor, w_all: torch.Tensor,
                      b_all: torch.Tensor, self_k: torch.Tensor,
                      self_v: torch.Tensor, key_mask: torch.Tensor,
                      cross_k: torch.Tensor, cross_v: torch.Tensor,
                      index: int, flat_beam: Optional[torch.Tensor] = None,
                      out_k: Optional[torch.Tensor] = None,
                      out_v: Optional[torch.Tensor] = None, *, heads: int,
                      eps: float = 1e-5,
                      cross_ks: Optional[torch.Tensor] = None,
                      cross_vs: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """One whole decode step over all NL layers.

    hidden0 (N, D) embeddings output in the compute dtype; w_all / b_all
    from `pack_decode_weights`; self_k / self_v (NL, T, N, D); key_mask
    (N, T) {0, 1}, the validity of every cache column once column `index`
    holds this step's K/V; cross_k / cross_v (NLc, B, L, D) in the compute
    dtype, or int8 (`quantize_kv`) with their fp32 (NLc, B, H) scales
    cross_ks / cross_vs (required with int8, refused without).

    Without flat_beam the column `index` of self_k / self_v is written in
    place. With flat_beam (N,) int32, row n of each layer's caches is read
    from row flat_beam[n] (the beam-search reorder) and the permuted caches,
    column `index` included, are written to out_k / out_v (other buffers of
    the same shape; allocated when not given).

    Returns (hidden_out (N, D), k_new (NL, N, D), v_new (NL, N, D),
    caches_k, caches_v), the caches being self_k / self_v or out_k / out_v.
    """
    n, d, f, nl, nlc, t, b, l_enc = _dims(hidden0, w_all, b_all, self_k,
                                          cross_k, heads)
    if not 0 <= index < t or tuple(key_mask.shape) != (n, t):
        raise ValueError(f"fused_decode_step: index {index}, key_mask "
                         f"{tuple(key_mask.shape)}, T {t}")
    if flat_beam is not None:
        if out_k is None:
            out_k, out_v = torch.empty_like(self_k), torch.empty_like(self_v)
        if out_k.data_ptr() == self_k.data_ptr() or \
                out_v.data_ptr() == self_v.data_ptr():
            raise ValueError("fused_decode_step: the reorder cannot run in "
                             "place; out_k/out_v must be other buffers")
    quant = _check_scales(cross_k, cross_v, cross_ks, cross_vs, b, heads)
    if not hidden0.is_cuda:
        return fused_decode_step_reference(
            hidden0, w_all, b_all, self_k, self_v, key_mask, cross_k,
            cross_v, index, flat_beam, out_k, out_v, heads=heads, eps=eps,
            cross_ks=cross_ks, cross_vs=cross_vs)
    from prismer_tpu_torch.ops import _build

    dtype = hidden0.dtype
    dh = d // heads
    # the cross kernel reads a head's row in a power-of-two count of lane
    # slices (16 bytes, 8 values in int8): the head width is 64 in every
    # registry decoder
    lanes = dh // (8 if quant else 16 // hidden0.element_size())
    if dtype not in _DTYPE_CODES or d % 8 or f % 8 or dh % 8 or \
            not 0 < lanes <= 32 or lanes & (lanes - 1):
        raise ValueError(f"fused_decode_step: kernel takes "
                         f"{list(_DTYPE_CODES)} with D, F and the head "
                         f"width multiples of 8, a power-of-two count of "
                         f"lane slices per head row; got {dtype}, D {d}, F "
                         f"{f}, {heads} heads")
    if flat_beam is None:
        out_k, out_v = self_k, self_v
    key_mask = key_mask.to(torch.int32).contiguous()
    kv_dtype = torch.int8 if quant else dtype
    want = [("hidden0", hidden0, dtype), ("w_all", w_all, dtype),
            ("b_all", b_all, torch.float32), ("self_k", self_k, dtype),
            ("self_v", self_v, dtype), ("out_k", out_k, dtype),
            ("out_v", out_v, dtype), ("key_mask", key_mask, torch.int32),
            ("cross_k", cross_k, kv_dtype), ("cross_v", cross_v, kv_dtype)]
    if quant:
        want += [("cross_ks", cross_ks, torch.float32),
                 ("cross_vs", cross_vs, torch.float32)]
    if flat_beam is not None:
        want.append(("flat_beam", flat_beam, torch.int32))
    for name, x, dt in want:
        if x.dtype != dt or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"fused_decode_step: {name} is {x.dtype} "
                             f"{tuple(x.shape)}; kernel takes contiguous "
                             f"16-byte aligned {dt}")
    if tuple(out_k.shape) != tuple(self_k.shape) or \
            tuple(out_v.shape) != tuple(self_k.shape) or \
            tuple(self_v.shape) != tuple(self_k.shape) or \
            tuple(cross_v.shape) != tuple(cross_k.shape) or \
            (flat_beam is not None and tuple(flat_beam.shape) != (n,)):
        raise ValueError("fused_decode_step: cache / flat_beam shapes")
    dev = hidden0.device
    hidden_out = torch.empty((n, d), dtype=dtype, device=dev)
    k_new = torch.empty((nl, n, d), dtype=dtype, device=dev)
    v_new = torch.empty_like(k_new)
    work = torch.empty(n * (7 * d + max(d, f)), dtype=dtype, device=dev)
    with _build.launch_device("fused_decode_step",
                              *(x for _, x, _ in want)):
        err = _build.kernels().prismer_fused_decode_step(
            hidden0.data_ptr(), w_all.data_ptr(), b_all.data_ptr(),
            self_k.data_ptr(), self_v.data_ptr(), out_k.data_ptr(),
            out_v.data_ptr(),
            None if flat_beam is None else flat_beam.data_ptr(),
            key_mask.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
            cross_ks.data_ptr() if quant else None,
            cross_vs.data_ptr() if quant else None,
            hidden_out.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            work.data_ptr(), n, b, d, heads, f, nl, nlc, t, l_enc, index,
            _DTYPE_CODES[dtype], eps, 1.0 / math.sqrt(d // heads),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_decode_step")
    if quant:
        fused_decode_step.int8_launches += 1
    else:
        fused_decode_step.launches += 1
    return hidden_out, k_new, v_new, out_k, out_v


fused_decode_step.launches = 0        # kernel 4: compute-dtype cross K/V
fused_decode_step.int8_launches = 0   # kernel 4b: int8 cross K/V

