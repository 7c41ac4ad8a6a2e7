"""Prismer core model (expert encoder + text decoder), ported from
prismer_tpu/models/prismer.py, plus a seeded random initialisation for runs
without converted weights.

Submodule names equal the flax scope names, so `state_dict` keys are the
flax parameter paths joined by '.' (convert/from_jax.py and train/optim.py
rely on that).
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
from prismer_tpu_torch.models.vit import (BatchNorm, VisionTransformer,
                                          draw_instance_slots)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def compute_dtype(cfg: PrismerConfig) -> torch.dtype:
    """The model's compute dtype, also the storage dtype for expert inputs
    (data/device.materialize_experts)."""
    return _DTYPES[cfg.dtype]


class Prismer(nn.Module):
    """Expert encoder + text decoder; the task heads build on these
    methods. Training mode (`train=True`) takes an explicit generator for
    the random instance slots and the dropout seeds."""

    def __init__(self, cfg: PrismerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.expert_encoder = VisionTransformer(cfg.vision, dtype, device)
        self.text_decoder = RobertaCausalDecoder(cfg.decoder, dtype, device)

    def encode(self, experts: Dict[str, Any],
               instance_slots: Optional[torch.Tensor] = None,
               train: bool = False) -> torch.Tensor:
        """The multi-modal encoder: (B, L, vision_hidden)."""
        return self.expert_encoder(experts, instance_slots, train)

    def decode_logits(self, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor,
                      encoder_hidden_states: torch.Tensor,
                      cross_groups: int = 1) -> torch.Tensor:
        """Full-sequence decoder logits (B, L, V) fp32.

        cross_groups > 1: the input rows are G candidates per sample while
        encoder_hidden_states stays untiled (B, L, D), so cross K/V are
        projected once per sample (rank pass 2)."""
        return self.text_decoder(input_ids, attention_mask,
                                 encoder_hidden_states,
                                 cross_groups=cross_groups)

    def decode_loss(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor,
                    encoder_hidden_states: torch.Tensor,
                    targets: torch.Tensor, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    cross_groups: int = 1) -> torch.Tensor:
        """Per-sample summed label-smoothed CE (B,) fp32 (through the
        fused LM-head + CE kernels when ops/fused_ce.use_fused_ce says so);
        cross_groups as in `decode_logits`."""
        return self.text_decoder.per_sample_loss(
            input_ids, attention_mask, encoder_hidden_states, targets, train,
            generator, cross_groups)

    def forward_loss(self, experts: Dict[str, Any], input_ids: torch.Tensor,
                     attention_mask: torch.Tensor, targets: torch.Tensor,
                     train: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Encoder + decoder -> (B,) per-sample summed smoothed CE. In
        training the instance slots and then the dropout seeds are drawn
        from `generator` (the JAX step's 'instance' and 'dropout' streams),
        and the stems' BatchNorm running statistics are updated in place."""
        slots = None
        if train:
            if generator is None:
                raise ValueError("training needs a generator")
            v = self.cfg.vision
            if "obj_detection" in v.experts_dict:
                slots = draw_instance_slots(v.max_instances,
                                            v.num_instance_slots, generator)
        enc = self.encode(experts, slots, train)
        return self.decode_loss(input_ids, attention_mask, enc, targets,
                                train, generator)

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


def random_values(model: Prismer, seed: int) -> Dict[str, torch.Tensor]:
    """The fp32 value of every parameter and buffer drawn from `seed`, on
    the CPU, keyed by state_dict name: lecun-normal Dense/Conv kernels, zero
    biases, unit LN/BN scales, N(0, 0.02) word, position and token-type
    tables, width**-0.5 * N(0, 1) positional embedding, latents and
    instance table, BN running mean 0 and var 1.

    Draws happen in fp32 and in module order, so one seed gives the same
    values for every device and compute dtype."""
    gen = torch.Generator().manual_seed(seed)
    names = {t: n for n, t in model.state_dict(keep_vars=True).items()}
    values: Dict[str, torch.Tensor] = {}

    def put(t: torch.Tensor, value: torch.Tensor) -> None:
        values[names[t]] = value

    def normal(t: torch.Tensor, std: float) -> None:
        put(t, torch.randn(t.shape, generator=gen) * std)

    for mod in model.modules():
        if isinstance(mod, (Dense, Conv)):
            fan_in = mod.weight[0].numel()
            normal(mod.weight, 1.0 / math.sqrt(fan_in))
            if mod.bias is not None:
                put(mod.bias, torch.zeros(mod.bias.shape))
        elif isinstance(mod, (LayerNorm, BatchNorm)):
            put(mod.weight, torch.ones(mod.weight.shape))
            put(mod.bias, torch.zeros(mod.bias.shape))
            if isinstance(mod, BatchNorm):
                put(mod.running_mean, torch.zeros(mod.running_mean.shape))
                put(mod.running_var, torch.ones(mod.running_var.shape))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("word_embeddings", "position_embeddings",
                    "token_type_embeddings"):
            normal(p, model.cfg.decoder.initializer_range)
        elif leaf in ("positional_embedding", "latents",
                      "instance_embedding"):
            normal(p, p.shape[-1] ** -0.5)
        elif name == "text_decoder.lm_head.bias":
            put(p, torch.zeros(p.shape))
    return values


@torch.no_grad()
def init_random_(model: Prismer, seed: int) -> Prismer:
    """Fill every parameter and buffer with `random_values(model, seed)`
    (the bf16 model holds the bf16 rounding of the fp32 model's weights)."""
    tensors = model.state_dict(keep_vars=True)
    for name, value in random_values(model, seed).items():
        t = tensors[name]
        t.copy_(value.to(device=t.device, dtype=t.dtype))
    return model


def random_masters(model: Prismer, seed: int) -> Dict[str, torch.Tensor]:
    """fp32 master values of the parameters the model stores in a lower
    precision, as drawn from `seed` (never the rounded weights), on the
    model's device: the train state's masters for a randomly initialised
    model."""
    values = random_values(model, seed)
    return {name: values[name].to(p.device)
            for name, p in model.named_parameters()
            if p.dtype != torch.float32}


def build_random_prismer(cfg: PrismerConfig, seed: int,
                         device: torch.device | str = "cuda") -> Prismer:
    """A Prismer on `device` (the card unless the caller names the CPU)
    with weights drawn from `seed` (no default initialisation runs: the
    module is built on the meta device first)."""
    model = Prismer(cfg, device="meta").to_empty(device=device)
    init_random_(model, seed)
    return model.eval()
