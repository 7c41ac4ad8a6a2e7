"""RoBERTa-style causal decoder with per-layer cross-attention and adaptors,
ported from prismer_tpu/models/roberta.py.

Each decoder layer runs self-attn -> cross-attn -> adaptor -> MLP; a final
layer without cross-attention finishes the stack; the LM head is dense ->
gelu -> LayerNorm -> tied-embedding projection + bias, accumulated in fp32.

Full-sequence passes take `cross_groups` G: G input rows per sample of
untiled encoder states, cross K/V projected once per sample (rank pass 2,
`SelfAttentionCore.attend_grouped_full`).

Training (`per_sample_loss(train=True)`): dropout after the embeddings' LN
and after each AttentionOutput dense (none on attention probabilities, as
in JAX), each layer rematerialised, and the loss through the fused LM-head
+ CE kernels (ops/fused_ce) when `use_fused_ce` says so.

Two cached decode paths, as in JAX (`set_fused_decode`):
  * per layer (fused decode off): self K and V in natural layout
    (NL, N, H, T, Dh), N = B * beams, each step writing its column in place;
    cross K/V projected once per sample, (NLc, B, H, L, Dh), shared by the
    sample's beams (never tiled, never reordered). Its grouped
    cross-attention (prefill and every step) runs the batched products
    ("matmul", the default, JAX's XLA einsum path) or the
    `ops/decode_attention` kernel ("kernel", JAX's PRISMER_DECODE_CROSS=
    pallas): `set_decode_cross`.
  * fused (the default on CUDA): one `ops/fused_decode` call per step runs
    every layer body. Self K/V (NL, T, N, D), so a step's column is one
    contiguous slab, plus a second pair of buffers for the beam reorder the
    step folds in; cross K/V natural and unpadded, (NLc, B, L, D); the
    packed weights ride in the cache (`pack_decode_collection`). With
    `set_kv_quant("int8")` (JAX's PRISMER_KV_QUANT=int8, off by default)
    the cached cross K/V are int8 with fp32 (NLc, B, H) scales.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from prismer_tpu_torch.config import TextDecoderConfig
from prismer_tpu_torch.models.layers import (Adaptor, Dense, Dropout,
                                             LayerNorm, attention,
                                             dot_product_attention,
                                             gelu_exact, matmul_f32,
                                             merge_heads, padding_mask_bias,
                                             remat, split_heads)

Cache = Dict[str, torch.Tensor]

# Fused whole-step decode (ops/fused_decode.py): 'auto' is on for CUDA tensors
# and off on the CPU, as the JAX package enables it only on its accelerator;
# 'on' / 'off' force it. Read when a cache is built and at each step.
_FUSED_DECODE = "auto"


def set_fused_decode(mode: str) -> None:
    """'on' | 'off' | 'auto'."""
    global _FUSED_DECODE
    if mode not in ("on", "off", "auto"):
        raise ValueError(f"fused decode mode {mode!r}")
    _FUSED_DECODE = mode


def use_fused_decode(device: torch.device) -> bool:
    """Whether decoding on `device` takes the fused path."""
    if _FUSED_DECODE == "auto":
        return torch.device(device).type == "cuda"
    return _FUSED_DECODE == "on"


# int8 cross K/V on the fused decode path (kernel 4b), off by default as in
# JAX. Read when a fused cache is built.
_KV_QUANT = "off"


def set_kv_quant(mode: str) -> None:
    """'int8' | 'off'."""
    global _KV_QUANT
    if mode not in ("int8", "off"):
        raise ValueError(f"kv quant mode {mode!r}")
    _KV_QUANT = mode


def use_kv_quant(device: torch.device) -> bool:
    """Whether a decode cache on `device` holds int8 cross K/V: only on the
    fused path, as JAX's `use_kv_quant`."""
    return _KV_QUANT == "int8" and use_fused_decode(device)


# The per-layer path's grouped cross-attention: "matmul" (the batched
# products, JAX's default XLA path) or "kernel" (ops/decode_attention, JAX's
# PRISMER_DECODE_CROSS=pallas). Read at each call.
_DECODE_CROSS = "matmul"


def set_decode_cross(mode: str) -> None:
    """'matmul' | 'kernel'."""
    global _DECODE_CROSS
    if mode not in ("matmul", "kernel"):
        raise ValueError(f"decode cross mode {mode!r}")
    _DECODE_CROSS = mode


def pack_decode_collection(decoder: "RobertaCausalDecoder",
                           with_emb: bool = False) -> Dict[str, torch.Tensor]:
    """The fused path's packed tensors: {"w_all", "b_all"} (layout in
    ops/fused_decode.py), and with `with_emb` the compute-dtype (V, D) tied
    embedding and the fp32 LM bias that ops/lm_topk reads ({"emb",
    "lm_bias"}). Serving builds these once (prismer.
    prepare_serving_variables); `init_cache` packs them itself otherwise."""
    from prismer_tpu_torch.ops.fused_decode import pack_decode_weights
    w_all, b_all = pack_decode_weights(decoder, decoder.dtype)
    out = {"w_all": w_all, "b_all": b_all}
    if with_emb:
        out["emb"] = decoder.embeddings.word_embeddings.detach().to(
            decoder.dtype).contiguous()
        out["lm_bias"] = decoder.lm_head.bias.detach().float().contiguous()
    return out


def create_position_ids(input_ids: torch.Tensor, attention_mask: torch.Tensor,
                        padding_idx: int) -> torch.Tensor:
    """Non-pad tokens numbered from padding_idx + 1; pads get padding_idx."""
    mask = attention_mask.long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class SelfAttentionCore(nn.Module):
    """q/k/v projections + fp32-softmax attention; separate q and kv paths
    so the cache can be kept outside."""

    def __init__(self, cfg: TextDecoderConfig, kv_dim: int, dtype,
                 device=None):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.query = Dense(d, d, dtype, device)
        self.key = Dense(kv_dim, d, dtype, device)
        self.value = Dense(kv_dim, d, dtype, device)

    def project_q(self, hidden: torch.Tensor) -> torch.Tensor:
        return split_heads(self.query(hidden), self.num_heads)

    def project_kv(self, source: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (split_heads(self.key(source), self.num_heads),
                split_heads(self.value(source), self.num_heads))

    def forward(self, hidden: torch.Tensor, kv_source: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        """Full-sequence attention through the flash kernel."""
        q = self.project_q(hidden)
        k, v = self.project_kv(kv_source)
        return merge_heads(attention(q, k, v, key_mask, causal))

    def attend_t(self, hidden: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """One-token attention over a cached K/V, both (N, H, T, Dh) here
        (JAX keeps K pre-transposed; the name is kept for the mapping)."""
        return merge_heads(dot_product_attention(self.project_q(hidden), k, v,
                                                 mask_bias))

    def attend_grouped(self, hidden: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, beams: int,
                       kernel: bool = False) -> torch.Tensor:
        """Cross-attention of (B*beams, P, D) queries against per-sample
        K/V (B, H, L, Dh), shared by a sample's beams; with `kernel` through
        ops/decode_attention (kernel 11's rounding)."""
        n, p, _ = hidden.shape
        b = n // beams
        q = self.project_q(hidden)                          # (N, H, P, Dh)
        h, dh = q.shape[1], q.shape[3]
        q = q.reshape(b, beams, h, p, dh).permute(0, 2, 1, 3, 4)
        q = q.reshape(b, h, beams * p, dh)
        if kernel:
            from prismer_tpu_torch.ops.decode_attention import \
                grouped_cross_attention
            # K/V as they are: the decode cache, or the prefill's
            # head-split views of the projected (B, L, D) K/V, which the
            # kernel's TMA loads read through their strides
            out = grouped_cross_attention(q.contiguous(), k, v, "cross_t")
        else:
            out = dot_product_attention(q, k, v)
        out = out.reshape(b, h, beams, p, dh).permute(0, 2, 1, 3, 4)
        return merge_heads(out.reshape(n, h, p, dh))

    def attend_grouped_full(self, hidden: torch.Tensor,
                            kv_source: torch.Tensor,
                            groups: int) -> torch.Tensor:
        """Full-sequence cross-attention of (B*G, P, D) queries, G rows per
        sample, against K/V projected once per sample from kv_source
        (B, L, D): rank pass 2 scores G candidate answers per sample without
        tiling the encoder states. No key mask (encoder states are
        full-length).

        JAX divides the fp32 scores by sqrt(Dh); `attend_grouped`
        multiplies them by its reciprocal, which is the same fp32 value only
        when sqrt(Dh) is a power of two (Dh 64 in every registry decoder),
        so other head widths are refused."""
        n = hidden.shape[0]
        b = kv_source.shape[0]
        if n != b * groups:
            raise ValueError(f"{n} query rows for {b} samples x {groups}")
        dh = self.query.out_features // self.num_heads
        if math.frexp(math.sqrt(dh))[0] != 0.5:
            raise ValueError(f"head width {dh}: sqrt is not a power of two")
        k, v = self.project_kv(kv_source)                   # (B, H, L, Dh)
        return self.attend_grouped(hidden, k, v, groups)


class AttentionOutput(nn.Module):
    """dense -> dropout -> LayerNorm(+ residual)."""

    def __init__(self, in_dim: int, cfg: TextDecoderConfig, dtype,
                 device=None):
        super().__init__()
        self.dense = Dense(in_dim, cfg.hidden_size, dtype, device)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor,
                dropout: Optional[Dropout] = None) -> torch.Tensor:
        hidden = self.dense(hidden)
        if dropout is not None:
            hidden = dropout(hidden)
        return self.ln(hidden + residual)


class FeedForward(nn.Module):
    """intermediate dense + gelu, then output dense + LN(residual)."""

    def __init__(self, cfg: TextDecoderConfig, dtype, device=None):
        super().__init__()
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size,
                                  dtype, device)
        self.out = AttentionOutput(cfg.intermediate_size, cfg, dtype, device)

    def forward(self, hidden: torch.Tensor,
                dropout: Optional[Dropout] = None) -> torch.Tensor:
        return self.out(gelu_exact(self.intermediate(hidden)), hidden,
                        dropout)


class DecoderLayer(nn.Module):
    """[self-attn, cross-attn, adaptor, MLP]; with_cross=False gives the
    final output_layer."""

    def __init__(self, cfg: TextDecoderConfig, with_cross: bool, dtype,
                 device=None):
        super().__init__()
        self.with_cross = with_cross
        self.dropout_rate = cfg.hidden_dropout_prob
        self.self_attn = SelfAttentionCore(cfg, cfg.hidden_size, dtype, device)
        self.self_out = AttentionOutput(cfg.hidden_size, cfg, dtype, device)
        if with_cross:
            self.cross_attn = SelfAttentionCore(cfg, cfg.vision_hidden_size,
                                                dtype, device)
            self.cross_out = AttentionOutput(cfg.hidden_size, cfg, dtype,
                                             device)
            self.adaptor = Adaptor(cfg.hidden_size, True, dtype, device,
                                   eps=1e-5)
        self.mlp = FeedForward(cfg, dtype, device)

    def forward(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor],
                dropout_seed: Optional[int] = None,
                cross_groups: int = 1) -> torch.Tensor:
        """Full-sequence pass; with a dropout seed (training) the three
        (two without cross-attention) dropout sites draw their masks, in
        order, from that seed. cross_groups > 1: the rows are that many
        per sample of the untiled encoder states (attend_grouped_full)."""
        drop = Dropout(self.dropout_rate, dropout_seed, hidden.device)
        h = self.self_attn(hidden, hidden, attention_mask, causal=True)
        hidden = self.self_out(h, hidden, drop)
        if self.with_cross:
            if cross_groups > 1:
                h = self.cross_attn.attend_grouped_full(
                    hidden, encoder_hidden_states, cross_groups)
            else:
                h = self.cross_attn(hidden, encoder_hidden_states)
            hidden = self.adaptor(self.cross_out(h, hidden, drop))
        return self.mlp(hidden, drop)

    def prefill(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
                cross_k: Optional[torch.Tensor],
                cross_v: Optional[torch.Tensor], beams: int = 1,
                cross_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full pass over the prompt: (hidden, k, v), k/v (N, H, P, Dh).
        hidden may be beam-tiled while cross K/V stay per sample."""
        q = self.self_attn.project_q(hidden)
        k, v = self.self_attn.project_kv(hidden)
        h = merge_heads(attention(q, k, v, attention_mask, causal=True))
        hidden = self.self_out(h, hidden)
        if self.with_cross:
            h = self.cross_attn.attend_grouped(hidden, cross_k, cross_v, beams,
                                               cross_kernel)
            hidden = self.adaptor(self.cross_out(h, hidden))
        return self.mlp(hidden), k, v

    def decode_attend(self, hidden: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, key_mask_bias: torch.Tensor,
                      cross_k: Optional[torch.Tensor],
                      cross_v: Optional[torch.Tensor],
                      beams: int = 1) -> torch.Tensor:
        """One-token step over an already-updated cache slice."""
        h = self.self_attn.attend_t(hidden, k_cache, v_cache, key_mask_bias)
        hidden = self.self_out(h, hidden)
        if self.with_cross:
            h = self.cross_attn.attend_grouped(hidden, cross_k, cross_v, beams,
                                               _DECODE_CROSS == "kernel")
            hidden = self.adaptor(self.cross_out(h, hidden))
        return self.mlp(hidden)


class Embeddings(nn.Module):
    """word + position + token-type embeddings (fp32 sum), cast, LN,
    dropout."""

    def __init__(self, cfg: TextDecoderConfig, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        d = cfg.hidden_size
        self.word_embeddings = nn.Parameter(
            torch.zeros(cfg.vocab_size, d, device=device))
        self.position_embeddings = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, d, device=device))
        self.token_type_embeddings = nn.Parameter(
            torch.zeros(cfg.type_vocab_size, d, device=device))
        self.ln = LayerNorm(d, cfg.layer_norm_eps, device)

    def forward(self, input_ids: torch.Tensor, position_ids: torch.Tensor,
                dropout: Optional[Dropout] = None) -> torch.Tensor:
        emb = (self.word_embeddings[input_ids.long()]
               + self.position_embeddings[position_ids.long()]
               + self.token_type_embeddings[0][None, None, :])
        emb = self.ln(emb.to(self.dtype))
        return emb if dropout is None else dropout(emb)


class LMHead(nn.Module):
    """dense -> gelu -> LN -> tied-embedding projection + bias; the
    projection takes compute-dtype operands and accumulates in fp32, so the
    logits are never rounded to the compute dtype."""

    def __init__(self, cfg: TextDecoderConfig, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, dtype, device)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=device))

    def features(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.ln(gelu_exact(self.dense(hidden)))

    def forward(self, hidden: torch.Tensor,
                word_embeddings: torch.Tensor) -> torch.Tensor:
        h = self.features(hidden).to(self.dtype)
        logits = matmul_f32(h, word_embeddings.to(self.dtype).t())
        return logits + self.bias


class RobertaCausalDecoder(nn.Module):
    """embeddings -> N x DecoderLayer -> output layer -> LM head.

    Entry points: forward (full-sequence logits), per_sample_loss (the
    training / eval loss), init_cache (prefill the prompt, build the cache,
    last-position logits), decode_step (one cached token step)."""

    def __init__(self, cfg: TextDecoderConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = Embeddings(cfg, dtype, device)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layers_{i}",
                            DecoderLayer(cfg, True, dtype, device))
        self.output_layer = DecoderLayer(cfg, False, dtype, device)
        self.lm_head = LMHead(cfg, dtype, device)

    def cross_layers(self):
        return [getattr(self, f"layers_{i}")
                for i in range(self.cfg.num_hidden_layers)]

    def _trunk(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               encoder_hidden_states: torch.Tensor, train: bool,
               generator: Optional[torch.Generator],
               cross_groups: int = 1) -> torch.Tensor:
        """Embeddings and every layer. In training one dropout seed per
        site group is drawn from `generator` before any layer runs, and
        each layer is rematerialised with its seed as an argument.
        cross_groups > 1: G input rows per sample of the untiled encoder
        states (rank pass 2)."""
        c = self.cfg
        layers = self.cross_layers() + [self.output_layer]
        seeds = [None] * (len(layers) + 1)
        if train:
            if generator is None:
                raise ValueError("training needs a generator for dropout")
            seeds = torch.randint(0, 2 ** 62, (len(seeds),),
                                  generator=generator).tolist()
        pos = create_position_ids(input_ids, attention_mask, c.pad_token_id)
        hidden = self.embeddings(input_ids, pos, Dropout(
            c.hidden_dropout_prob, seeds[0], input_ids.device))
        enc = encoder_hidden_states.to(self.dtype)
        for layer, seed in zip(layers, seeds[1:]):
            src = enc if layer.with_cross else None
            if train:
                hidden = remat(layer, hidden, attention_mask, src, seed,
                               cross_groups)
            else:
                hidden = layer(hidden, attention_mask, src, None,
                               cross_groups)
        return hidden

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                encoder_hidden_states: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                cross_groups: int = 1) -> torch.Tensor:
        """Full-sequence logits (B, L, V) fp32."""
        hidden = self._trunk(input_ids, attention_mask,
                             encoder_hidden_states, train, generator,
                             cross_groups)
        return self.lm_head(hidden, self.embeddings.word_embeddings)

    def per_sample_loss(self, input_ids: torch.Tensor,
                        attention_mask: torch.Tensor,
                        encoder_hidden_states: torch.Tensor,
                        targets: torch.Tensor, train: bool = False,
                        generator: Optional[torch.Generator] = None,
                        cross_groups: int = 1) -> torch.Tensor:
        """Per-sample summed label-smoothed CE (B,) fp32: through the fused
        LM-head + CE kernels when `use_fused_ce(train, device)`, else from
        the materialised logits (`label_smoothed_loss`)."""
        from prismer_tpu_torch.ops.fused_ce import (fused_label_smoothed_loss,
                                                    use_fused_ce)
        hidden = self._trunk(input_ids, attention_mask,
                             encoder_hidden_states, train, generator,
                             cross_groups)
        if use_fused_ce(train, hidden.device):
            h = self.lm_head.features(hidden).to(self.dtype)
            emb = self.embeddings.word_embeddings.to(self.dtype)
            return fused_label_smoothed_loss(h, emb, self.lm_head.bias,
                                             targets)
        logits = self.lm_head(hidden, self.embeddings.word_embeddings)
        return label_smoothed_loss(logits, targets)

    def init_cache(self, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor,
                   encoder_hidden_states: torch.Tensor, max_len: int,
                   beams: int = 1, return_h: bool = False,
                   packed: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Cache]:
        """Prefill the right-padded prompt. Returns (logits at the last
        prompt column (N, V) fp32, cache); with return_h the LM-head
        features (N, D) there instead (the ops/lm_topk path). Pass the
        untiled encoder states (B, L, D) with beam-tiled ids/mask (B*beams
        rows). On the fused path the cache carries `packed` (from
        `pack_decode_collection`), or packs the weights itself, and with
        `use_kv_quant` int8 cross K/V plus their scales ("cross_ks",
        "cross_vs"). The prompt's own cross-attention reads the unrounded
        K/V, and on the fused path always runs the batched products (JAX's
        `attend_grouped_nat`)."""
        c = self.cfg
        n, p = input_ids.shape
        fused = use_fused_decode(input_ids.device)
        quant = use_kv_quant(input_ids.device)
        if quant:
            from prismer_tpu_torch.ops.fused_decode import quantize_kv
        cross_kernel = not fused and _DECODE_CROSS == "kernel"
        pos = create_position_ids(input_ids, attention_mask, c.pad_token_id)
        hidden = self.embeddings(input_ids, pos)
        enc = encoder_hidden_states.to(self.dtype)
        h, dh, d = c.num_attention_heads, c.head_dim, c.hidden_size
        nl = c.num_hidden_layers + 1
        if fused:
            self_k = torch.zeros((nl, max_len, n, d), dtype=self.dtype,
                                 device=hidden.device)
        else:
            self_k = torch.zeros((nl, n, h, max_len, dh), dtype=self.dtype,
                                 device=hidden.device)
        self_v = torch.zeros_like(self_k)
        cross_k, cross_v, cross_ks, cross_vs = [], [], [], []
        for i, layer in enumerate(self.cross_layers() + [self.output_layer]):
            ck = cv = None
            if layer.with_cross:
                ck_nat = layer.cross_attn.key(enc)            # (B, L, D)
                cv_nat = layer.cross_attn.value(enc)
                ck, cv = split_heads(ck_nat, h), split_heads(cv_nat, h)
                # the fused cache keeps the natural layout (int8 with
                # `quant`), the per-layer one the head-split (B, H, L, Dh)
                if quant:
                    for nat, vals, scales in ((ck_nat, cross_k, cross_ks),
                                              (cv_nat, cross_v, cross_vs)):
                        q8, scale = quantize_kv(nat, h)
                        vals.append(q8)
                        scales.append(scale)
                else:
                    cross_k.append(ck_nat if fused else ck)
                    cross_v.append(cv_nat if fused else cv)
            hidden, k, v = layer.prefill(hidden, attention_mask, ck, cv, beams,
                                         cross_kernel)
            if fused:  # (N, H, P, Dh) -> (P, N, D)
                self_k[i, :p] = k.permute(2, 0, 1, 3).reshape(p, n, d)
                self_v[i, :p] = v.permute(2, 0, 1, 3).reshape(p, n, d)
            else:
                self_k[i, :, :, :p] = k
                self_v[i, :, :, :p] = v
        last = hidden[:, -1:, :]
        if return_h:
            out = self.lm_head.features(last)[:, 0, :]
        else:
            out = self.lm_head(last, self.embeddings.word_embeddings)[:, 0, :]
        if not fused:
            return out, {"self_k": self_k, "self_v": self_v,
                         "cross_k": torch.stack(cross_k),
                         "cross_v": torch.stack(cross_v)}
        if packed is None:
            packed = pack_decode_collection(self)
        cache = {"self_k_tn": self_k, "self_v_tn": self_v,
                 "self_k_spare": torch.empty_like(self_k),
                 "self_v_spare": torch.empty_like(self_v),
                 "cross_k": torch.stack(cross_k),
                 "cross_v": torch.stack(cross_v),
                 "w_all": packed["w_all"], "b_all": packed["b_all"]}
        if quant:
            cache["cross_ks"] = torch.stack(cross_ks)
            cache["cross_vs"] = torch.stack(cross_vs)
        return out, cache

    def decode_step(self, token_ids: torch.Tensor, index: int,
                    position_ids: torch.Tensor, key_mask: torch.Tensor,
                    cache: Cache, beams: int = 1,
                    cross_len: Optional[int] = None,
                    perm: Optional[torch.Tensor] = None,
                    return_h: bool = False) -> Tuple[torch.Tensor, Cache]:
        """One decode step; updates the self caches IN PLACE at column
        `index`. token_ids/position_ids (N,); key_mask (N, T) {0,1} validity
        of every cache column after this token is written. Returns
        (next-token logits (N, V) fp32, cache), or with return_h the
        LM-head features (N, D).

        On the fused path (a cache from a fused `init_cache`), perm (N,)
        int32 folds the beam reorder of the self caches into the step, and
        cross_len, when given, must equal the cached encoder length."""
        if "w_all" in cache:
            return self._fused_decode_step(token_ids, index, position_ids,
                                           key_mask, cache, cross_len, perm,
                                           return_h)
        if perm is not None or return_h:
            raise ValueError("perm and return_h need the fused decode path")
        hidden = self.embeddings(token_ids[:, None], position_ids[:, None])
        key_bias = padding_mask_bias(key_mask)
        self_k, self_v = cache["self_k"], cache["self_v"]
        layers = self.cross_layers() + [self.output_layer]
        for i, layer in enumerate(layers):
            k_new, v_new = layer.self_attn.project_kv(hidden)  # (N,H,1,Dh)
            self_k[i, :, :, index] = k_new[:, :, 0]
            self_v[i, :, :, index] = v_new[:, :, 0]
            cross = layer.with_cross
            hidden = layer.decode_attend(
                hidden, self_k[i], self_v[i], key_bias,
                cache["cross_k"][i] if cross else None,
                cache["cross_v"][i] if cross else None, beams)
        logits = self.lm_head(hidden, self.embeddings.word_embeddings)
        return logits[:, 0, :], cache

    def _fused_decode_step(self, token_ids: torch.Tensor, index: int,
                           position_ids: torch.Tensor, key_mask: torch.Tensor,
                           cache: Cache, cross_len: Optional[int],
                           perm: Optional[torch.Tensor], return_h: bool
                           ) -> Tuple[torch.Tensor, Cache]:
        """Every layer body in one ops/fused_decode call; the embeddings and
        the LM head stay outside. With perm the step reads the current
        caches and writes the reordered ones into the spare pair, which
        becomes the current pair."""
        from prismer_tpu_torch.ops.fused_decode import fused_decode_step
        c = self.cfg
        if cross_len is not None and cross_len != cache["cross_k"].shape[2]:
            raise ValueError(f"cross_len {cross_len} != cached "
                             f"{cache['cross_k'].shape[2]}")
        hidden = self.embeddings(token_ids[:, None],
                                 position_ids[:, None])[:, 0, :]
        spare = (None, None) if perm is None else (cache["self_k_spare"],
                                                   cache["self_v_spare"])
        hidden, _, _, self_k, self_v = fused_decode_step(
            hidden, cache["w_all"], cache["b_all"], cache["self_k_tn"],
            cache["self_v_tn"], key_mask, cache["cross_k"], cache["cross_v"],
            index, perm, *spare, heads=c.num_attention_heads,
            eps=c.layer_norm_eps, cross_ks=cache.get("cross_ks"),
            cross_vs=cache.get("cross_vs"))
        new = dict(cache, self_k_tn=self_k, self_v_tn=self_v)
        if perm is not None:
            new["self_k_spare"] = cache["self_k_tn"]
            new["self_v_spare"] = cache["self_v_tn"]
        cache = new
        if return_h:
            return self.lm_head.features(hidden[:, None, :])[:, 0, :], cache
        logits = self.lm_head(hidden[:, None, :],
                              self.embeddings.word_embeddings)
        return logits[:, 0, :], cache


def label_smoothed_loss(logits: torch.Tensor, labels: torch.Tensor,
                        smoothing: float = 0.1) -> torch.Tensor:
    """Per-sample summed label-smoothed CE with -100 ignored: logits (B, L,
    V) shifted off the last position, labels off the first
    (torch CrossEntropyLoss(label_smoothing=0.1, reduction='none') summed
    per sample)."""
    shift = logits[:, :-1, :].float()
    labels = labels[:, 1:]
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(shift, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    per_tok = (1.0 - smoothing) * nll + smoothing * (-logp.mean(-1))
    return torch.where(valid, per_tok, torch.zeros_like(per_tok)).sum(1)


def num_valid_targets(labels: torch.Tensor) -> torch.Tensor:
    """Supervised positions per sample of the unshifted labels (B,) int32:
    the rank-inference normaliser."""
    return (labels != -100).sum(dim=1, dtype=torch.int32)
