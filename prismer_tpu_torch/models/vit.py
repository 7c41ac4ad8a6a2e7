"""Multi-modal ViT encoder, ported from prismer_tpu/models/vit.py.

Per-modality stems (a VALID patch conv for rgb; bilinear resize + conv/BN/
ReLU stacks for the expert label maps), the shared positional embedding
re-interpolated per modality, the random-slot instance embedding for
obj_detection, the Perceiver resampler over all expert tokens, and a trunk
of pre-LN blocks with an adaptor between attention and MLP (with
`layers.set_ln_proj(True)`, each block's LayerNorms run inside the
`ops/ln_proj` kernels). Inputs are NHWC and activations batch-first
(B, L, D), as in JAX. In training (`forward(train=True)`) the stems'
BatchNorms normalise with batch statistics and update their running ones,
and the trunk blocks are rematerialised.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed.nn.functional as dist_nn
import torch.nn as nn
import torch.nn.functional as F

from prismer_tpu_torch.config import VisionEncoderConfig
from prismer_tpu_torch.models.layers import (Adaptor, Conv, LayerNorm, Mlp,
                                             MultiHeadAttention,
                                             current_batch_shard,
                                             interpolate_pos_embed, remat)
from prismer_tpu_torch.models.resampler import PerceiverResampler
from prismer_tpu_torch.ops.resize import (bilinear_resize_align_corners,
                                          nearest_resize)

ID_MAP_EXPERTS = ("seg", "obj_detection", "ocr_detection")


def draw_instance_slots(max_instances: int, num_slots: int,
                        generator: torch.Generator) -> torch.Tensor:
    """One random slot of the instance table per possible instance id.

    The JAX package draws these from a jax.random key; no torch generator
    reproduces those bits, so callers that need both packages to agree pass
    the same slots to each (`VisionTransformer.forward(instance_slots=)`)."""
    return torch.randint(0, num_slots, (max_instances,), generator=generator)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis in fp32, flax
    BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32) semantics.

    Eval: the running statistics. Train: the batch statistics over
    (B, H, W), with flax's variance max(0, E[x^2] - E[x]^2) (biased), and the
    running statistics become 0.9 * old + 0.1 * batch in place.
    `nn.BatchNorm2d` is not used: its momentum weighs the other way and it
    keeps an unbiased running variance.

    Under data parallelism (`layers.batch_shard`) the sums of x and x^2 are
    all-reduced over the ranks of the batch before the mean and variance
    are formed, through an all-reduce the gradient flows back through: the
    statistics of the global batch, as JAX's BatchNorm computes them on a
    batch-sharded array."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = 0.9
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.float()
        if train:
            axes = tuple(range(x.ndim - 1))
            shard = current_batch_shard()
            if shard is not None:
                sums = torch.stack([x32.sum(axes), (x32 * x32).sum(axes)])
                sums = dist_nn.all_reduce(sums, group=shard.group)
                count = x32[..., 0].numel() * shard.total // shard.rows
                mean, mean_sq = sums[0] / count, sums[1] / count
            else:
                mean, mean_sq = x32.mean(axes), (x32 * x32).mean(axes)
            var = (mean_sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x32 - mean) * mul + self.bias


class ResidualAttentionBlock(nn.Module):
    """Pre-LN CLIP block with the adaptor between attention and MLP."""

    def __init__(self, dim: int, num_heads: int, dtype, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(dim, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, dtype, device)
        self.adaptor = Adaptor(dim, False, dtype, device)
        self.ln_2 = LayerNorm(dim, device=device)
        self.mlp = Mlp(dim, dim * 4, dim, "quick_gelu", dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # ln_1 / ln_2 are applied by attn and mlp: inside their kernels with
        # set_ln_proj(True), as fp32_layer_norm before them otherwise; the
        # parameters stay where they are, so the state_dict is the same
        ln_1, ln_2 = self.ln_1, self.ln_2
        x = x + self.attn(x, pre_ln=(ln_1.weight, ln_1.bias))
        x = self.adaptor(x)
        return x + self.mlp(x, pre_ln=(ln_2.weight, ln_2.bias))


class LabelStem(nn.Module):
    """Downsampling conv stack for expert label maps.

    id_map=True: bilinear scale 4/patch, strides (2, 2, 1, 1) (64-channel
    experts); id_map=False: scale 16/patch, strides (2, 2, 2, 2) (dense
    experts). Bias-free convs; BatchNorm + ReLU after each but the final 1x1.
    """

    def __init__(self, in_ch: int, width: int, patch_size: int, id_map: bool,
                 dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = (4 if id_map else 16) / patch_size
        strides = (2, 2, 1, 1) if id_map else (2, 2, 2, 2)
        widths = (width // 8, width // 4, width // 2, width)
        cin = in_ch
        for i, (s, f) in enumerate(zip(strides, widths)):
            self.add_module(f"Conv_{i}", Conv(cin, f, 3, s, 1, dtype, device))
            self.add_module(f"bn_{i}", BatchNorm(f, device=device))
            cin = f
        self.proj = Conv(width, width, 1, 1, 0, dtype, device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        x = bilinear_resize_align_corners(x.to(self.dtype), int(h * self.scale),
                                          int(w * self.scale))
        for i in range(4):
            x = getattr(self, f"Conv_{i}")(x)
            x = F.relu(getattr(self, f"bn_{i}")(x, train).to(self.dtype))
        return self.proj(x)


class VisionTransformer(nn.Module):
    """The full multi-modal encoder. Returns (B, L, D) in the compute dtype."""

    def __init__(self, cfg: VisionEncoderConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        width = cfg.width
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.rgb_tokens, width, device=device))
        for exp, ch in cfg.experts:
            if exp == "rgb":
                self.conv1_rgb = Conv(ch, width, cfg.patch_size,
                                      cfg.patch_size, 0, dtype, device)
            else:
                self.add_module(f"conv1_{exp}", LabelStem(
                    ch, width, cfg.patch_size, exp in ID_MAP_EXPERTS, dtype,
                    device))
        if "obj_detection" in cfg.experts_dict:
            self.instance_embedding = nn.Parameter(
                torch.zeros(cfg.num_instance_slots, width, device=device))
        if cfg.has_experts:
            self.resampler = PerceiverResampler(
                width, cfg.resampler_layers, cfg.resampler_heads,
                cfg.resampler_latents, dtype, device)
        self.ln_pre = LayerNorm(width, device=device)
        for i in range(cfg.layers):
            self.add_module(f"resblocks_{i}", ResidualAttentionBlock(
                width, cfg.heads, dtype, device))
        self.ln_post = LayerNorm(width, device=device)

    def forward(self, inputs: Dict[str, Any],
                instance_slots: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        cfg = self.cfg
        pos = self.positional_embedding
        experts_tokens = []
        rgb_tokens = None
        for exp, _ in cfg.experts:
            if exp not in inputs:
                raise KeyError(f"missing modality input: {exp}")
            if exp == "rgb":
                x = self.conv1_rgb(inputs[exp])
            elif exp == "obj_detection":
                x = getattr(self, f"conv1_{exp}")(inputs[exp]["label"], train)
                x = self._add_instance_embedding(
                    x, inputs[exp]["instance"], instance_slots)
            else:
                x = getattr(self, f"conv1_{exp}")(inputs[exp], train)
            b, h, w, d = x.shape
            x = x.reshape(b, h * w, d)
            if exp == "rgb":
                rgb_tokens = x + pos.to(x.dtype)
            else:
                pe = interpolate_pos_embed(pos, x.shape[1]).to(x.dtype)
                experts_tokens.append(x + pe)

        if experts_tokens:
            latents = self.resampler(torch.cat(experts_tokens, dim=1))
            x = torch.cat([rgb_tokens, latents], dim=1)
        else:
            x = rgb_tokens
        x = self.ln_pre(x)
        for i in range(cfg.layers):
            block = getattr(self, f"resblocks_{i}")
            x = remat(block, x) if train else block(x)
        return self.ln_post(x)

    def _add_instance_embedding(self, x: torch.Tensor, instance: torch.Tensor,
                                slots: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, h, w, D) + the table row of each instance id's slot; the
        (B, H, W, 1) id map is nearest-downsampled to the stem grid."""
        cfg = self.cfg
        if slots is None:  # a fixed draw, as JAX uses a fixed key
            slots = draw_instance_slots(cfg.max_instances,
                                        cfg.num_instance_slots,
                                        torch.Generator().manual_seed(0))
        slots = slots.to(device=x.device, dtype=torch.long)
        inst = nearest_resize(instance.long(), x.shape[1], x.shape[2])[..., 0]
        return x + self.instance_embedding.to(x.dtype)[slots[inst]]
