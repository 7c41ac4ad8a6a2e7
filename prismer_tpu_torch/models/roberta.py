"""RoBERTa-style causal decoder with per-layer cross-attention and adaptors,
ported from prismer_tpu/models/roberta.py (the non-fused decode path).

Each decoder layer runs self-attn -> cross-attn -> adaptor -> MLP; a final
layer without cross-attention finishes the stack; the LM head is dense ->
gelu -> LayerNorm -> tied-embedding projection + bias, accumulated in fp32.

Cache layout (the port's own): self K and V are both kept in natural layout
(NL, N, H, T, Dh), N = B * beams, and each decode step writes its column in
place. Cross K/V are projected once per sample, (NLc, B, H, L, Dh), and are
shared by that sample's beams (never tiled, never reordered). The JAX fused
decode path, its packed weights and int8 cross-KV are later work.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from prismer_tpu_torch.config import TextDecoderConfig
from prismer_tpu_torch.models.layers import (Adaptor, Dense, LayerNorm,
                                             attention, dot_product_attention,
                                             gelu_exact, matmul_f32,
                                             merge_heads, padding_mask_bias,
                                             split_heads)

Cache = Dict[str, torch.Tensor]


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
                       v: torch.Tensor, beams: int) -> torch.Tensor:
        """Cross-attention of (B*beams, P, D) queries against per-sample
        K/V (B, H, L, Dh), shared by a sample's beams."""
        n, p, _ = hidden.shape
        b = n // beams
        q = self.project_q(hidden)                          # (N, H, P, Dh)
        h, dh = q.shape[1], q.shape[3]
        q = q.reshape(b, beams, h, p, dh).permute(0, 2, 1, 3, 4)
        out = dot_product_attention(q.reshape(b, h, beams * p, dh), k, v)
        out = out.reshape(b, h, beams, p, dh).permute(0, 2, 1, 3, 4)
        return merge_heads(out.reshape(n, h, p, dh))


class AttentionOutput(nn.Module):
    """dense -> LayerNorm(+ residual)."""

    def __init__(self, in_dim: int, cfg: TextDecoderConfig, dtype,
                 device=None):
        super().__init__()
        self.dense = Dense(in_dim, cfg.hidden_size, dtype, device)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)

    def forward(self, hidden: torch.Tensor,
                residual: torch.Tensor) -> torch.Tensor:
        return self.ln(self.dense(hidden) + residual)


class FeedForward(nn.Module):
    """intermediate dense + gelu, then output dense + LN(residual)."""

    def __init__(self, cfg: TextDecoderConfig, dtype, device=None):
        super().__init__()
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size,
                                  dtype, device)
        self.out = AttentionOutput(cfg.intermediate_size, cfg, dtype, device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.out(gelu_exact(self.intermediate(hidden)), hidden)


class DecoderLayer(nn.Module):
    """[self-attn, cross-attn, adaptor, MLP]; with_cross=False gives the
    final output_layer."""

    def __init__(self, cfg: TextDecoderConfig, with_cross: bool, dtype,
                 device=None):
        super().__init__()
        self.with_cross = with_cross
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
                encoder_hidden_states: Optional[torch.Tensor]
                ) -> torch.Tensor:
        h = self.self_attn(hidden, hidden, attention_mask, causal=True)
        hidden = self.self_out(h, hidden)
        if self.with_cross:
            h = self.cross_attn(hidden, encoder_hidden_states)
            hidden = self.adaptor(self.cross_out(h, hidden))
        return self.mlp(hidden)

    def prefill(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
                cross_k: Optional[torch.Tensor],
                cross_v: Optional[torch.Tensor], beams: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full pass over the prompt: (hidden, k, v), k/v (N, H, P, Dh).
        hidden may be beam-tiled while cross K/V stay per sample."""
        q = self.self_attn.project_q(hidden)
        k, v = self.self_attn.project_kv(hidden)
        h = merge_heads(attention(q, k, v, attention_mask, causal=True))
        hidden = self.self_out(h, hidden)
        if self.with_cross:
            h = self.cross_attn.attend_grouped(hidden, cross_k, cross_v, beams)
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
            h = self.cross_attn.attend_grouped(hidden, cross_k, cross_v, beams)
            hidden = self.adaptor(self.cross_out(h, hidden))
        return self.mlp(hidden)

    def project_cross_kv(self, encoder_hidden_states: torch.Tensor):
        return self.cross_attn.project_kv(encoder_hidden_states)


class Embeddings(nn.Module):
    """word + position + token-type embeddings (fp32 sum), cast, LN."""

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

    def forward(self, input_ids: torch.Tensor,
                position_ids: torch.Tensor) -> torch.Tensor:
        emb = (self.word_embeddings[input_ids.long()]
               + self.position_embeddings[position_ids.long()]
               + self.token_type_embeddings[0][None, None, :])
        return self.ln(emb.to(self.dtype))


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

    Entry points: forward (full-sequence logits), init_cache (prefill the
    prompt, build the cache, last-position logits), decode_step (one cached
    token step)."""

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

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        pos = create_position_ids(input_ids, attention_mask, c.pad_token_id)
        hidden = self.embeddings(input_ids, pos)
        enc = encoder_hidden_states.to(self.dtype)
        for layer in self.cross_layers():
            hidden = layer(hidden, attention_mask, enc)
        hidden = self.output_layer(hidden, attention_mask, None)
        return self.lm_head(hidden, self.embeddings.word_embeddings)

    def init_cache(self, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor,
                   encoder_hidden_states: torch.Tensor, max_len: int,
                   beams: int = 1) -> Tuple[torch.Tensor, Cache]:
        """Prefill the right-padded prompt. Returns (logits at the last
        prompt column (N, V) fp32, cache). Pass the untiled encoder states
        (B, L, D) with beam-tiled ids/mask (B*beams rows)."""
        c = self.cfg
        n, p = input_ids.shape
        pos = create_position_ids(input_ids, attention_mask, c.pad_token_id)
        hidden = self.embeddings(input_ids, pos)
        enc = encoder_hidden_states.to(self.dtype)
        h, dh = c.num_attention_heads, c.head_dim
        nl = c.num_hidden_layers + 1
        self_k = torch.zeros((nl, n, h, max_len, dh), dtype=self.dtype,
                             device=hidden.device)
        self_v = torch.zeros_like(self_k)
        cross_k, cross_v = [], []
        for i, layer in enumerate(self.cross_layers()):
            ck, cv = layer.project_cross_kv(enc)
            cross_k.append(ck)
            cross_v.append(cv)
            hidden, k, v = layer.prefill(hidden, attention_mask, ck, cv, beams)
            self_k[i, :, :, :p] = k
            self_v[i, :, :, :p] = v
        hidden, k, v = self.output_layer.prefill(hidden, attention_mask,
                                                 None, None)
        self_k[nl - 1, :, :, :p] = k
        self_v[nl - 1, :, :, :p] = v
        logits = self.lm_head(hidden[:, -1:, :],
                              self.embeddings.word_embeddings)[:, 0, :]
        cache = {"self_k": self_k, "self_v": self_v,
                 "cross_k": torch.stack(cross_k),
                 "cross_v": torch.stack(cross_v)}
        return logits, cache

    def decode_step(self, token_ids: torch.Tensor, index: int,
                    position_ids: torch.Tensor, key_mask: torch.Tensor,
                    cache: Cache, beams: int = 1
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step; updates the self caches IN PLACE at column
        `index`. token_ids/position_ids (N,); key_mask (N, T) {0,1} validity
        of every cache column after this token is written. Returns
        (next-token logits (N, V) fp32, cache)."""
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
