"""Mask2Former segmentation expert (inference), NHWC: port of
prismer_tpu/experts/segmentation/mask2former.py.

Semantic inference only, as the Prismer pipeline runs it:
  * the Swin-L backbone (swin.py here);
  * the MSDeformAttn pixel decoder: res3-5 projected to 256 + GroupNorm-32,
    sine position + level embeddings, 6 deformable-attention encoder layers
    (8 heads, 3 levels, 4 points, FFN 1024, post-LN), one FPN step onto
    res2 and a 1x1 mask-feature conv;
  * the masked transformer decoder: 200 learned queries, 9 layers cycling
    the 3 scales; per layer masked cross-attention (keys where the previous
    prediction's sigmoid < 0.5 are blocked with -1e9; a row blocked
    everywhere is unblocked), then self-attention, then the FFN, all
    post-norm; prediction heads LN + class Linear(C+1) + 3-layer mask MLP;
  * semantic logits softmax(cls)[..., :-1]^T sigmoid(masks) at H/4.

The deformable attention core is `experts.ops.deform_attn.ms_deform_attn`:
the CUDA kernel (csrc/ms_deform_attn.cu) on the card, its plain gather
version on the CPU. The other attentions are plain matmul + softmax in fp32.
Bilinear resizes are `F.interpolate(mode='bilinear', align_corners=False)`
without antialiasing, which computes what the JAX package's half-pixel
matrices do (experts/depth/model.py `_bilinear_half_pixel_matrix`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from prismer_tpu_torch.experts.layers import build_random, normal_init
from prismer_tpu_torch.experts.ops.deform_attn import ms_deform_attn
from prismer_tpu_torch.experts.segmentation.swin import (FP32,
                                                        SwinTransformer,
                                                        cached_constant,
                                                        merge_heads,
                                                        split_heads)
from prismer_tpu_torch.models.layers import Conv, Dense, LayerNorm

MASK_BLOCKED = -1e9   # the masked cross-attention's bias


def sine_position_embedding(h: int, w: int, dim: int = 256) -> np.ndarray:
    """PositionEmbeddingSine(normalize=True); (h, w, dim) with the
    reference's [y; x] channel order."""
    half = dim // 2
    eps, scale = 1e-6, 2 * math.pi
    y = (np.arange(1, h + 1, dtype=np.float32)[:, None]
         / (h + eps) * scale)
    x = (np.arange(1, w + 1, dtype=np.float32)[None, :]
         / (w + eps) * scale)
    dim_t = 10000.0 ** (2 * (np.arange(half, dtype=np.float32) // 2) / half)
    pos_x = np.broadcast_to(x[:, :, None], (h, w, half)) / dim_t
    pos_y = np.broadcast_to(np.broadcast_to(y, (h, w))[:, :, None],
                            (h, w, half)) / dim_t

    def interleave(p):
        return np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])],
                        axis=-1).reshape(h, w, half)

    return np.concatenate([interleave(pos_y), interleave(pos_x)],
                          axis=-1).astype(np.float32)


def encoder_reference_points(spatial_shapes) -> np.ndarray:
    """(S, L, 2) normalised pixel centres replicated over levels (valid
    ratios 1)."""
    pts = []
    for hl, wl in spatial_shapes:
        ys, xs = np.meshgrid(
            (np.arange(hl, dtype=np.float32) + 0.5) / hl,
            (np.arange(wl, dtype=np.float32) + 0.5) / wl, indexing="ij")
        pts.append(np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1))
    ref = np.concatenate(pts, axis=0)
    return np.broadcast_to(ref[:, None, :],
                           (ref.shape[0], len(spatial_shapes), 2)).copy()


def resize_bilinear_half(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor, align_corners=False, no
    antialiasing (torch's default), in fp32."""
    return F.interpolate(x.float(), size=(oh, ow), mode="bilinear",
                         align_corners=False)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm on NHWC tensors: statistics over (H, W, C/G) per
    group in fp32, then the per-channel affine."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        xg = x.float().reshape(b, -1, self.groups, c // self.groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True,
                                   correction=0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias


class MSDeformAttnLayer(nn.Module):
    """Deformable DETR attention (heads 8, levels 3, points 4)."""

    def __init__(self, dim: int, heads: int = 8, levels: int = 3,
                 points: int = 4, device=None):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        hlp = heads * levels * points
        self.value_proj = Dense(dim, dim, FP32, device)
        self.sampling_offsets = Dense(dim, 2 * hlp, FP32, device)
        self.attention_weights = Dense(dim, hlp, FP32, device)
        self.output_proj = Dense(dim, dim, FP32, device)
        self._consts: Dict = {}

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                value_src: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query / value_src (B, S, D); reference_points (B, S, L, 2)."""
        b, s, d = query.shape
        hd, nl, p = self.heads, self.levels, self.points
        value = self.value_proj(value_src).reshape(b, s, hd, d // hd)
        offsets = self.sampling_offsets(query).reshape(b, s, hd, nl, p, 2)
        weights = torch.softmax(
            self.attention_weights(query).reshape(b, s, hd, nl * p).float(),
            dim=-1).reshape(b, s, hd, nl, p)
        normalizer = cached_constant(
            self._consts, tuple(spatial_shapes), query.device,
            lambda: np.asarray([[wl, hl] for hl, wl in spatial_shapes],
                               np.float32))               # (L, 2) as (W, H)
        locs = (reference_points[:, :, None, :, None, :]
                + offsets.float() / normalizer[None, None, None, :, None, :])
        out = ms_deform_attn(value.float().contiguous(), spatial_shapes,
                             locs.contiguous(), weights.contiguous())
        return self.output_proj(out)


class DeformableEncoderLayer(nn.Module):
    def __init__(self, dim: int, ffn: int = 1024, device=None):
        super().__init__()
        self.self_attn = MSDeformAttnLayer(dim, device=device)
        self.norm1 = LayerNorm(dim, 1e-5, device)
        self.linear1 = Dense(dim, ffn, FP32, device)
        self.linear2 = Dense(ffn, dim, FP32, device)
        self.norm2 = LayerNorm(dim, 1e-5, device)

    def forward(self, src, pos, reference_points, spatial_shapes):
        h = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = self.norm1(src + h)
        f = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + f)


class PixelDecoder(nn.Module):
    """MSDeformAttnPixelDecoder. Takes the backbone's {'res2'..'res5'}
    (channels `in_channels`, in that order); returns (mask_features
    (B, H/4, W/4, mask_dim), [res5', res4', res3'] at conv_dim)."""

    def __init__(self, in_channels: Sequence[int], conv_dim: int = 256,
                 mask_dim: int = 256, enc_layers: int = 6, device=None):
        super().__init__()
        self.conv_dim = conv_dim
        self.enc_layers = enc_layers
        self.level_embed = nn.Parameter(torch.zeros(3, conv_dim,
                                                    device=device))
        for i, ch in enumerate(reversed(in_channels[1:])):   # res5, res4, res3
            setattr(self, f"input_proj_{i}",
                    Conv(ch, conv_dim, 1, 1, 0, FP32, device, bias=True))
            setattr(self, f"input_norm_{i}",
                    GroupNorm(32, conv_dim, device=device))
        for i in range(enc_layers):
            setattr(self, f"enc_{i}", DeformableEncoderLayer(conv_dim,
                                                             device=device))
        self.adapter_1 = Conv(in_channels[0], conv_dim, 1, 1, 0, FP32, device)
        self.adapter_norm_1 = GroupNorm(32, conv_dim, device=device)
        self.layer_1 = Conv(conv_dim, conv_dim, 3, 1, 1, FP32, device)
        self.layer_norm_1 = GroupNorm(32, conv_dim, device=device)
        self.mask_features = Conv(conv_dim, mask_dim, 1, 1, 0, FP32, device,
                                  bias=True)
        self._consts: Dict = {}

    def forward(self, features: Dict[str, torch.Tensor]):
        c = self.conv_dim
        srcs, poss, shapes = [], [], []
        for i, name in enumerate(("res5", "res4", "res3")):
            x = getattr(self, f"input_norm_{i}")(
                getattr(self, f"input_proj_{i}")(features[name]))
            b, h, w, _ = x.shape
            pe = cached_constant(self._consts, ("pe", h, w), x.device,
                                 lambda: sine_position_embedding(h, w, c))
            srcs.append(x.reshape(b, h * w, c))
            poss.append(pe.reshape(1, h * w, c) + self.level_embed[i])
            shapes.append((h, w))
        src = torch.cat(srcs, dim=1)
        pos = torch.cat(poss, dim=1)
        ref = cached_constant(self._consts, ("ref", tuple(shapes)), src.device,
                              lambda: encoder_reference_points(shapes))
        ref = ref[None].expand(src.shape[0], -1, -1, -1)
        for i in range(self.enc_layers):
            src = getattr(self, f"enc_{i}")(src, pos, ref, shapes)

        out, start = [], 0
        for h, w in shapes:
            out.append(src[:, start:start + h * w].reshape(-1, h, w, c))
            start += h * w

        r2 = features["res2"]
        lateral = self.adapter_norm_1(self.adapter_1(r2))
        up = resize_bilinear_half(out[-1].permute(0, 3, 1, 2), r2.shape[1],
                                  r2.shape[2]).permute(0, 2, 3, 1)
        y = F.relu(self.layer_norm_1(self.layer_1(lateral + up)))
        return self.mask_features(y), out


class MHA(nn.Module):
    """torch nn.MultiheadAttention equivalent with an additive fp32 mask."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(dim, dim, FP32, device)
        self.k_proj = Dense(dim, dim, FP32, device)
        self.v_proj = Dense(dim, dim, FP32, device)
        self.out_proj = Dense(dim, dim, FP32, device)

    def forward(self, q, k, v, mask_bias: Optional[torch.Tensor] = None):
        qh = split_heads(self.q_proj(q), self.heads)
        kh = split_heads(self.k_proj(k), self.heads)
        vh = split_heads(self.v_proj(v), self.heads)
        s = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
        if mask_bias is not None:
            s = s + mask_bias
        o = torch.matmul(torch.softmax(s, dim=-1), vh)
        return self.out_proj(merge_heads(o))


class MaskedTransformerDecoder(nn.Module):
    """MultiScaleMaskedTransformerDecoder (post-norm variant). Returns
    (class logits (B, Q, C+1), mask logits (B, Q, H/4, W/4))."""

    def __init__(self, num_queries: int = 200, hidden_dim: int = 256,
                 heads: int = 8, dec_layers: int = 9, num_classes: int = 133,
                 mask_dim: int = 256, ffn: int = 2048, device=None):
        super().__init__()
        self.dec_layers = dec_layers
        hd = hidden_dim
        self.query_feat = nn.Parameter(torch.zeros(num_queries, hd,
                                                   device=device))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, hd,
                                                    device=device))
        self.level_embed = nn.Parameter(torch.zeros(3, hd, device=device))
        self.decoder_norm = LayerNorm(hd, 1e-5, device)
        self.class_embed = Dense(hd, num_classes + 1, FP32, device)
        self.mask_mlp_0 = Dense(hd, hd, FP32, device)
        self.mask_mlp_1 = Dense(hd, hd, FP32, device)
        self.mask_mlp_2 = Dense(hd, mask_dim, FP32, device)
        for i in range(dec_layers):
            setattr(self, f"cross_{i}", MHA(hd, heads, device))
            setattr(self, f"cross_norm_{i}", LayerNorm(hd, 1e-5, device))
            setattr(self, f"self_{i}", MHA(hd, heads, device))
            setattr(self, f"self_norm_{i}", LayerNorm(hd, 1e-5, device))
            setattr(self, f"ffn1_{i}", Dense(hd, ffn, FP32, device))
            setattr(self, f"ffn2_{i}", Dense(ffn, hd, FP32, device))
            setattr(self, f"ffn_norm_{i}", LayerNorm(hd, 1e-5, device))
        self._consts: Dict = {}

    def prediction(self, output: torch.Tensor, mask_features: torch.Tensor,
                   target_size: Tuple[int, int]):
        """(class logits, mask logits, attention bias (B, 1, Q, h*w) for the
        next layer at `target_size`)."""
        b, q = output.shape[:2]
        dec = self.decoder_norm(output)
        cls = self.class_embed(dec)
        m = F.relu(self.mask_mlp_0(dec))
        m = F.relu(self.mask_mlp_1(m))
        m = self.mask_mlp_2(m)
        masks = torch.einsum("bqc,bhwc->bqhw", m.float(),
                             mask_features.float())
        small = resize_bilinear_half(masks, *target_size)   # (B, Q, h, w)
        blocked = (torch.sigmoid(small) < 0.5).reshape(b, q, -1)
        blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
        bias = torch.zeros(blocked.shape, dtype=FP32, device=output.device)
        bias.masked_fill_(blocked, MASK_BLOCKED)
        return cls, masks, bias[:, None]

    def forward(self, ms_features: List[torch.Tensor],
                mask_features: torch.Tensor):
        b = mask_features.shape[0]
        hd = self.query_feat.shape[1]
        srcs, poss, sizes = [], [], []
        for i, x in enumerate(ms_features):
            _, h, w, _ = x.shape
            pe = cached_constant(self._consts, (h, w), x.device,
                                 lambda: sine_position_embedding(h, w, hd))
            srcs.append(x.reshape(b, h * w, hd).float() + self.level_embed[i])
            poss.append(pe.reshape(1, h * w, hd))
            sizes.append((h, w))

        output = self.query_feat[None].expand(b, -1, -1)
        qpos = self.query_embed[None]
        classes, masks, bias = self.prediction(output, mask_features,
                                               sizes[0])
        for i in range(self.dec_layers):
            li = i % 3
            h = getattr(self, f"cross_{i}")(output + qpos, srcs[li] + poss[li],
                                            srcs[li], bias)
            output = getattr(self, f"cross_norm_{i}")(output + h)
            h = getattr(self, f"self_{i}")(output + qpos, output + qpos, output)
            output = getattr(self, f"self_norm_{i}")(output + h)
            f = getattr(self, f"ffn2_{i}")(F.relu(
                getattr(self, f"ffn1_{i}")(output)))
            output = getattr(self, f"ffn_norm_{i}")(output + f)
            classes, masks, bias = self.prediction(output, mask_features,
                                                   sizes[(i + 1) % 3])
        return classes, masks


def semantic_logits(classes: torch.Tensor, masks: torch.Tensor
                    ) -> torch.Tensor:
    """softmax(cls)[..., :-1] against sigmoid(masks): (B, C, H/4, W/4)."""
    cls_prob = torch.softmax(classes.float(), dim=-1)[..., :-1]
    return torch.einsum("bqc,bqhw->bchw", cls_prob, torch.sigmoid(masks))


class MaskFormer(nn.Module):
    """The segmentation expert. Input: (B, H, W, 3) fp32 normalised with the
    detectron2 pixel statistics (the caller's preprocess). Output: semantic
    logits (B, num_classes, H/4, W/4). The widths default to Swin-L and the
    published Mask2Former head; the tests pass small ones."""

    def __init__(self, num_classes: int = 133, num_queries: int = 200, *,
                 embed_dim: int = 192, depths: Sequence[int] = (2, 2, 18, 2),
                 swin_heads: Sequence[int] = (6, 12, 24, 48),
                 window: int = 12, conv_dim: int = 256, mask_dim: int = 256,
                 enc_layers: int = 6, dec_heads: int = 8,
                 dec_layers: int = 9, device=None):
        super().__init__()
        self.backbone = SwinTransformer(embed_dim, depths, swin_heads, window,
                                        device)
        self.pixel_decoder = PixelDecoder(self.backbone.channels, conv_dim,
                                          mask_dim, enc_layers, device)
        self.predictor = MaskedTransformerDecoder(
            num_queries, conv_dim, dec_heads, dec_layers, num_classes,
            mask_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mask_features, ms = self.pixel_decoder(self.backbone(x))
        return semantic_logits(*self.predictor(ms, mask_features))


# flax initialisers of the raw parameters (the kernels, biases and norm
# scales follow `experts.layers.init_random_`)
RAW_INIT = {"rel_pos_bias": normal_init(0.02), "level_embed": normal_init(1.0),
            "query_feat": normal_init(1.0), "query_embed": normal_init(1.0)}


def build_random_maskformer(seed: int, device: torch.device | str = "cuda",
                            **widths) -> MaskFormer:
    """A frozen MaskFormer in eval mode on `device` with weights drawn from
    `seed` with flax's initialisers (built on the meta device first, so no
    default initialisation runs). `widths` are MaskFormer's arguments."""
    return build_random(MaskFormer, seed, device, RAW_INIT, **widths)
