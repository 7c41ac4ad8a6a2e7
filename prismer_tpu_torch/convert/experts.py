"""Published expert checkpoints -> flax-layout parameter trees, numpy only.

Copied from prismer_tpu/convert/experts.py (`convert_swin`, `_torch_mha`,
`convert_mask2former`, `_layer_norm_t`, `_gn`) and
prismer_tpu/convert/torch_to_jax.py (`_np`, `linear`, `conv`), which the
port cannot import. The tree they return is what the JAX package would load;
`convert.from_jax.load_jax_variables` places it into the port.

Layout rules: torch Linear weight (out, in) -> Dense kernel (in, out);
torch Conv2d weight (O, I, H, W) -> Conv kernel (H, W, I, O).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()  # torch tensor


def linear(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def conv(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _layer_norm_t(sd, p):
    return {"scale": _np(sd[f"{p}.weight"]), "bias": _np(sd[f"{p}.bias"])}


def _gn(sd, p):
    return {"scale": _np(sd[f"{p}.weight"]), "bias": _np(sd[f"{p}.bias"])}


SWIN_L_DEPTHS = (2, 2, 18, 2)


def convert_swin(sd: Dict[str, Any], prefix: str = "backbone."
                 ) -> Dict[str, Any]:
    """Swin-L keys -> params of the SwinTransformer."""
    P: Dict[str, Any] = {
        "patch_embed": conv(sd, f"{prefix}patch_embed.proj"),
        "patch_norm": _layer_norm_t(sd, f"{prefix}patch_embed.norm"),
    }
    for s, depth in enumerate(SWIN_L_DEPTHS):
        for b in range(depth):
            q = f"{prefix}layers.{s}.blocks.{b}"
            P[f"stage{s}_block{b}"] = {
                "norm1": _layer_norm_t(sd, f"{q}.norm1"),
                "norm2": _layer_norm_t(sd, f"{q}.norm2"),
                "attn": {
                    "qkv": linear(sd, f"{q}.attn.qkv"),
                    "proj": linear(sd, f"{q}.attn.proj"),
                    "rel_pos_bias": _np(
                        sd[f"{q}.attn.relative_position_bias_table"]),
                },
                "fc1": linear(sd, f"{q}.mlp.fc1"),
                "fc2": linear(sd, f"{q}.mlp.fc2"),
            }
        if s < len(SWIN_L_DEPTHS) - 1:
            q = f"{prefix}layers.{s}.downsample"
            P[f"downsample{s}"] = {
                "norm": _layer_norm_t(sd, f"{q}.norm"),
                "reduction": {"kernel": _np(sd[f"{q}.reduction.weight"]).T},
            }
        P[f"out_norm{s}"] = _layer_norm_t(sd, f"{prefix}norm{s}")
    return P


def _torch_mha(sd, p):
    w = _np(sd[f"{p}.in_proj_weight"])
    b = np.split(_np(sd[f"{p}.in_proj_bias"]), 3)
    wq, wk, wv = np.split(w, 3, axis=0)
    return {"q_proj": {"kernel": wq.T, "bias": b[0]},
            "k_proj": {"kernel": wk.T, "bias": b[1]},
            "v_proj": {"kernel": wv.T, "bias": b[2]},
            "out_proj": linear(sd, f"{p}.out_proj")}


def convert_mask2former(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Full Mask2Former checkpoint (the 'model' dict of a detectron2 .pkl)
    -> {'params': tree} of the MaskFormer."""
    P: Dict[str, Any] = {"backbone": convert_swin(sd)}

    pd: Dict[str, Any] = {}
    base = "sem_seg_head.pixel_decoder"
    pd["level_embed"] = _np(sd[f"{base}.transformer.level_embed"])
    for i in range(3):
        pd[f"input_proj_{i}"] = conv(sd, f"{base}.input_proj.{i}.0")
        pd[f"input_norm_{i}"] = _gn(sd, f"{base}.input_proj.{i}.1")
    for i in range(6):
        q = f"{base}.transformer.encoder.layers.{i}"
        pd[f"enc_{i}"] = {
            "self_attn": {
                "sampling_offsets": linear(sd, f"{q}.self_attn.sampling_offsets"),
                "attention_weights": linear(sd, f"{q}.self_attn.attention_weights"),
                "value_proj": linear(sd, f"{q}.self_attn.value_proj"),
                "output_proj": linear(sd, f"{q}.self_attn.output_proj"),
            },
            "norm1": _layer_norm_t(sd, f"{q}.norm1"),
            "norm2": _layer_norm_t(sd, f"{q}.norm2"),
            "linear1": linear(sd, f"{q}.linear1"),
            "linear2": linear(sd, f"{q}.linear2"),
        }
    pd["adapter_1"] = conv(sd, f"{base}.adapter_1")
    pd["adapter_norm_1"] = _gn(sd, f"{base}.adapter_1.norm")
    pd["layer_1"] = conv(sd, f"{base}.layer_1")
    pd["layer_norm_1"] = _gn(sd, f"{base}.layer_1.norm")
    pd["mask_features"] = conv(sd, f"{base}.mask_features")
    P["pixel_decoder"] = pd

    pr: Dict[str, Any] = {}
    base = "sem_seg_head.predictor"
    pr["query_feat"] = _np(sd[f"{base}.query_feat.weight"])
    pr["query_embed"] = _np(sd[f"{base}.query_embed.weight"])
    pr["level_embed"] = _np(sd[f"{base}.level_embed.weight"])
    pr["decoder_norm"] = _layer_norm_t(sd, f"{base}.decoder_norm")
    pr["class_embed"] = linear(sd, f"{base}.class_embed")
    for i in range(3):
        pr[f"mask_mlp_{i}"] = linear(sd, f"{base}.mask_embed.layers.{i}")
    for i in range(9):
        pr[f"cross_{i}"] = _torch_mha(
            sd, f"{base}.transformer_cross_attention_layers.{i}.multihead_attn")
        pr[f"cross_norm_{i}"] = _layer_norm_t(
            sd, f"{base}.transformer_cross_attention_layers.{i}.norm")
        pr[f"self_{i}"] = _torch_mha(
            sd, f"{base}.transformer_self_attention_layers.{i}.self_attn")
        pr[f"self_norm_{i}"] = _layer_norm_t(
            sd, f"{base}.transformer_self_attention_layers.{i}.norm")
        pr[f"ffn1_{i}"] = linear(
            sd, f"{base}.transformer_ffn_layers.{i}.linear1")
        pr[f"ffn2_{i}"] = linear(
            sd, f"{base}.transformer_ffn_layers.{i}.linear2")
        pr[f"ffn_norm_{i}"] = _layer_norm_t(
            sd, f"{base}.transformer_ffn_layers.{i}.norm")
    P["predictor"] = pr
    return {"params": P}
