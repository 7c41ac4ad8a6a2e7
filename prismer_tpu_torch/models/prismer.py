"""Prismer core model (expert encoder + text decoder), ported from
prismer_tpu/models/prismer.py, plus a seeded random initialisation for runs
without converted weights.

Submodule names equal the flax scope names, so `state_dict` keys are the
flax parameter paths joined by '.' (convert/from_jax.py relies on that).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from prismer_tpu_torch.config import PrismerConfig
from prismer_tpu_torch.models.layers import Conv, Dense, LayerNorm
from prismer_tpu_torch.models.roberta import (Cache, RobertaCausalDecoder,
                                              pack_decode_collection,
                                              use_fused_decode)
from prismer_tpu_torch.models.vit import BatchNorm, VisionTransformer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def compute_dtype(cfg: PrismerConfig) -> torch.dtype:
    """The model's compute dtype, also the storage dtype for expert inputs
    (data/device.materialize_experts)."""
    return _DTYPES[cfg.dtype]


class Prismer(nn.Module):
    """Expert encoder + text decoder; the task heads build on these methods.
    Inference only: dropout and BatchNorm statistics updates are not
    ported."""

    def __init__(self, cfg: PrismerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.expert_encoder = VisionTransformer(cfg.vision, dtype, device)
        self.text_decoder = RobertaCausalDecoder(cfg.decoder, dtype, device)

    def encode(self, experts: Dict[str, Any],
               instance_slots: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The multi-modal encoder: (B, L, vision_hidden)."""
        return self.expert_encoder(experts, instance_slots)

    def decode_logits(self, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor,
                      encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """Full-sequence decoder logits (B, L, V) fp32."""
        return self.text_decoder(input_ids, attention_mask,
                                 encoder_hidden_states)

    def init_cache(self, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor,
                   encoder_hidden_states: torch.Tensor, max_len: int,
                   beams: int = 1, return_h: bool = False,
                   packed: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Cache]:
        return self.text_decoder.init_cache(
            input_ids, attention_mask, encoder_hidden_states, max_len, beams,
            return_h=return_h, packed=packed)

    def decode_step(self, token_ids: torch.Tensor, index: int,
                    position_ids: torch.Tensor, key_mask: torch.Tensor,
                    cache: Cache, beams: int = 1,
                    cross_len: Optional[int] = None,
                    perm: Optional[torch.Tensor] = None,
                    return_h: bool = False) -> Tuple[torch.Tensor, Cache]:
        return self.text_decoder.decode_step(
            token_ids, index, position_ids, key_mask, cache, beams,
            cross_len=cross_len, perm=perm, return_h=return_h)


@torch.no_grad()
def prepare_serving_variables(model: Prismer
                              ) -> Optional[Dict[str, torch.Tensor]]:
    """One-time serving setup for the fused decode path, on the model's
    device: the packed decoder weights in the compute dtype, the
    compute-dtype (V, D) tied embedding and the fp32 LM bias
    (roberta.pack_decode_collection). None when fused decode is not in use
    there; beam_search then takes the per-layer path."""
    device = next(model.parameters()).device
    if not use_fused_decode(device):
        return None
    return pack_decode_collection(model.text_decoder, with_emb=True)


@torch.no_grad()
def init_random_(model: Prismer, seed: int) -> Prismer:
    """Fill every parameter and buffer from `seed`, flax-style: lecun-normal
    Dense/Conv kernels, zero biases, unit LN/BN scales, N(0, 0.02) word,
    position and token-type tables, width**-0.5 * N(0, 1) positional
    embedding, latents and instance table, BN running mean 0 and var 1.

    Draws happen on the CPU in fp32 and in module order, so one seed gives
    the same weights on every device and in every compute dtype (the
    bf16 model holds the bf16 rounding of the fp32 model's weights)."""
    gen = torch.Generator().manual_seed(seed)

    def fill(t: torch.Tensor, values: torch.Tensor) -> None:
        t.copy_(values.to(device=t.device, dtype=t.dtype))

    def normal(t: torch.Tensor, std: float) -> None:
        fill(t, torch.randn(t.shape, generator=gen) * std)

    for mod in model.modules():
        if isinstance(mod, (Dense, Conv)):
            fan_in = mod.weight[0].numel()
            normal(mod.weight, 1.0 / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("word_embeddings", "position_embeddings",
                    "token_type_embeddings"):
            normal(p, model.cfg.decoder.initializer_range)
        elif leaf in ("positional_embedding", "latents",
                      "instance_embedding"):
            normal(p, p.shape[-1] ** -0.5)
        elif name == "text_decoder.lm_head.bias":
            p.zero_()
    return model


def build_random_prismer(cfg: PrismerConfig, seed: int,
                         device: torch.device | str = "cpu") -> Prismer:
    """A Prismer on `device` with weights drawn from `seed` (no default
    initialisation runs: the module is built on the meta device first)."""
    model = Prismer(cfg, device="meta").to_empty(device=device)
    init_random_(model, seed)
    return model.eval()
