"""Perceiver-style experts resampler, ported from
prismer_tpu/models/resampler.py. Per block:

    latents += Attn(q = LN1(latents), kv = concat[LN1(latents), LN2(x)])
    latents += MLP_sq_relu(LN_ff(latents))

The cross-attention runs through the packed flash kernel (Dh = 96 at
Prismer-BASE: width 768, 8 heads).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from prismer_tpu_torch.models.layers import LayerNorm, Mlp, MultiHeadAttention


class PerceiverAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(dim, device=device)
        self.ln_2 = LayerNorm(dim, device=device)
        self.ln_ff = LayerNorm(dim, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, dtype, device)
        self.mlp = Mlp(dim, dim * 4, dim, "squared_relu", dtype, device)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        q = self.ln_1(latents)
        kv = torch.cat([q, self.ln_2(x)], dim=1)
        latents = latents + self.attn(q, kv)
        return latents + self.mlp(self.ln_ff(latents))


class PerceiverResampler(nn.Module):
    """num_latents learned latents attending over the expert tokens."""

    def __init__(self, dim: int, layers: int = 4, num_heads: int = 8,
                 num_latents: int = 64, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.latents = nn.Parameter(torch.zeros(num_latents, dim,
                                                device=device))
        for i in range(layers):
            self.add_module(f"blocks_{i}", PerceiverAttentionBlock(
                dim, num_heads, dtype, device))
        self.num_layers = layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        lat = self.latents.to(self.dtype)[None].expand(b, -1, -1)
        for i in range(self.num_layers):
            lat = getattr(self, f"blocks_{i}")(x, lat)
        return lat
