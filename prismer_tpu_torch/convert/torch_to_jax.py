"""Reference PyTorch checkpoints -> flax-layout parameter trees, numpy only.

Ported from prismer_tpu/convert/torch_to_jax.py, which the port cannot
import. The name is kept: the output is the flax-layout numpy tree that
`convert.from_jax.load_jax_variables` places into the port (and that the
JAX package would load). Three sources:

  * CLIP vision towers (OpenAI format, with or without the 'visual.'
    prefix): CLS row dropped from the positional embedding, packed
    attention in_proj split into q/k/v, positional embedding
    re-interpolated to the configured resolution;
  * HF RobertaForMaskedLM: embeddings, LM head and layer i's self-attention
    and FFN (cross-attention, adaptors and the output layer keep their
    init, as the reference's strict=False load leaves them);
  * full Prismer checkpoints (the reference's 'pytorch_model.bin':
    expert_encoder.* and text_decoder.*), positional embedding
    re-interpolated when the resolution differs.

Layouts: torch Linear weight (out, in) -> Dense kernel (in, out); Conv2d
weight (O, I, H, W) -> Conv kernel (H, W, I, O); BatchNorm {weight, bias,
running_mean, running_var} -> params {scale, bias} + batch_stats {mean,
var}. `merge_params` lays a converted tree over an init tree (for the port,
`from_jax.to_jax_variables(model.state_dict())`), `uncovered_leaves`
reports what it left at init.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np

from prismer_tpu_torch.config import PrismerConfig
from prismer_tpu_torch.convert.experts import _np, batch_norm, conv, linear
from prismer_tpu_torch.models.layers import _bicubic_matrix


def layer_norm(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def packed_mha(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """torch nn.MultiheadAttention's packed in_proj -> q/k/v/out Dense."""
    w = _np(sd[f"{prefix}.in_proj_weight"])
    b = _np(sd[f"{prefix}.in_proj_bias"])
    wq, wk, wv = np.split(w, 3, axis=0)
    bq, bk, bv = np.split(b, 3, axis=0)
    return {
        "q_proj": {"kernel": wq.T, "bias": bq},
        "k_proj": {"kernel": wk.T, "bias": bk},
        "v_proj": {"kernel": wv.T, "bias": bv},
        "out_proj": linear(sd, f"{prefix}.out_proj"),
    }


def adaptor(sd: Dict[str, Any], proj_prefix: str,
            ln_prefix: str) -> Dict[str, Any]:
    return {
        "down_proj": linear(sd, f"{proj_prefix}.down_proj"),
        "up_proj": linear(sd, f"{proj_prefix}.up_proj"),
        "adaptor_ln": layer_norm(sd, ln_prefix),
    }


def interpolate_pos_embed_np(pe: np.ndarray, target_len: int) -> np.ndarray:
    """Resize a square (L, D) positional-embedding grid to target_len tokens
    on the host: the operator of models.layers.interpolate_pos_embed
    (bicubic, a = -0.75, align_corners=False), summed in float64."""
    orig = int(round(pe.shape[0] ** 0.5))
    new = int(round(target_len ** 0.5))
    if orig == new:
        return pe
    w = _bicubic_matrix(orig, new).astype(np.float64)
    grid = pe.reshape(orig, orig, -1).astype(np.float64)
    out = np.einsum("oi,ijd->ojd", w, grid)
    out = np.einsum("oj,sjd->sod", w, out)
    return out.reshape(new * new, -1).astype(pe.dtype)


# ---------------------------------------------------------------------------
# CLIP visual tower
# ---------------------------------------------------------------------------

def convert_clip_vision(sd: Dict[str, Any], cfg: PrismerConfig
                        ) -> Dict[str, Any]:
    """OpenAI-CLIP state dict -> partial expert_encoder params: rgb stem,
    positional embedding (CLS dropped, re-interpolated to
    cfg.vision.rgb_tokens), trunk attention / MLP / LN, ln_pre, ln_post.
    Label stems, adaptors and the resampler keep their init."""
    sd = {k[len("visual."):] if k.startswith("visual.") else k: v
          for k, v in sd.items()}
    out: Dict[str, Any] = {"conv1_rgb": conv(sd, "conv1")}

    pe = _np(sd["positional_embedding"])
    n = pe.shape[0]
    if int(round(n ** 0.5)) ** 2 != n:  # CLS row present: drop it
        pe = pe[1:]
    out["positional_embedding"] = interpolate_pos_embed_np(
        pe, cfg.vision.rgb_tokens)
    out["ln_pre"] = layer_norm(sd, "ln_pre")
    out["ln_post"] = layer_norm(sd, "ln_post")

    n_layers = len({m.group(1) for k in sd
                    if (m := re.match(r"transformer\.resblocks\.(\d+)\.", k))})
    for i in range(n_layers):
        p = f"transformer.resblocks.{i}"
        out[f"resblocks_{i}"] = {
            "attn": packed_mha(sd, f"{p}.attn"),
            "ln_1": layer_norm(sd, f"{p}.ln_1"),
            "ln_2": layer_norm(sd, f"{p}.ln_2"),
            "mlp": {"c_fc": linear(sd, f"{p}.mlp.c_fc"),
                    "c_proj": linear(sd, f"{p}.mlp.c_proj")},
        }
    return out


# ---------------------------------------------------------------------------
# HF RoBERTa (MaskedLM) -> decoder
# ---------------------------------------------------------------------------

def _decoder_layer_common(sd: Dict[str, Any], p: str) -> Dict[str, Any]:
    """Self-attention + FFN params shared by HF RobertaLayer and the
    decoder layer."""
    return {
        "self_attn": {
            "query": linear(sd, f"{p}.attention.self.query"),
            "key": linear(sd, f"{p}.attention.self.key"),
            "value": linear(sd, f"{p}.attention.self.value"),
        },
        "self_out": {
            "dense": linear(sd, f"{p}.attention.output.dense"),
            "ln": layer_norm(sd, f"{p}.attention.output.LayerNorm"),
        },
        "mlp": {
            "intermediate": linear(sd, f"{p}.intermediate.dense"),
            "out": {"dense": linear(sd, f"{p}.output.dense"),
                    "ln": layer_norm(sd, f"{p}.output.LayerNorm")},
        },
    }


def convert_hf_roberta_mlm(sd: Dict[str, Any], num_layers: int,
                           layer_prefix_fmt: str = "roberta.encoder.layer.{i}"
                           ) -> Dict[str, Any]:
    """HF RobertaForMaskedLM state dict -> partial text_decoder params:
    embeddings, LM head, and layer i's self-attention and FFN from HF layer
    i. Cross-attention, adaptors and the output layer keep their init (the
    reference's strict=False load)."""
    emb = "roberta.embeddings"
    out: Dict[str, Any] = {
        "embeddings": {
            "word_embeddings": _np(sd[f"{emb}.word_embeddings.weight"]),
            "position_embeddings": _np(
                sd[f"{emb}.position_embeddings.weight"]),
            "token_type_embeddings": _np(
                sd[f"{emb}.token_type_embeddings.weight"]),
            "ln": layer_norm(sd, f"{emb}.LayerNorm"),
        },
        "lm_head": {
            "dense": linear(sd, "lm_head.dense"),
            "ln": layer_norm(sd, "lm_head.layer_norm"),
            "bias": _np(sd["lm_head.bias"]),
        },
    }
    for i in range(num_layers):
        out[f"layers_{i}"] = _decoder_layer_common(
            sd, layer_prefix_fmt.format(i=i))
    return out


# ---------------------------------------------------------------------------
# Full Prismer checkpoint (the reference's training output)
# ---------------------------------------------------------------------------

# the label stem's nn.Sequential indices: conv 1, 4, 7, 10; BN 2, 5, 8, 11;
# the 1x1 projection 13
_STEM_CONV_IDX = (1, 4, 7, 10)
_STEM_BN_IDX = (2, 5, 8, 11)


def _convert_label_stem(sd: Dict[str, Any], prefix: str
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for j, (ci, bi) in enumerate(zip(_STEM_CONV_IDX, _STEM_BN_IDX)):
        params[f"Conv_{j}"] = conv(sd, f"{prefix}.{ci}")
        params[f"bn_{j}"], stats[f"bn_{j}"] = batch_norm(sd, f"{prefix}.{bi}")
    params["proj"] = conv(sd, f"{prefix}.13")
    return params, stats


def convert_prismer_checkpoint(sd: Dict[str, Any], cfg: PrismerConfig
                               ) -> Dict[str, Any]:
    """Reference 'pytorch_model.bin' -> {'params', 'batch_stats'} tree.

    Keys: expert_encoder.* (the restructured CLIP ViT) and text_decoder.*
    (the restructured RoBERTa: layer i's self-attention and FFN under
    '.0', its cross-attention under '.1', its adaptor under '.2'). The
    positional embedding is re-interpolated to the configured
    resolution."""
    enc: Dict[str, Any] = {}
    enc_stats: Dict[str, Any] = {}

    pe = _np(sd["expert_encoder.positional_embedding"])
    enc["positional_embedding"] = interpolate_pos_embed_np(
        pe, cfg.vision.rgb_tokens)
    if "expert_encoder.instance_embedding" in sd:
        enc["instance_embedding"] = _np(
            sd["expert_encoder.instance_embedding"])
    enc["ln_pre"] = layer_norm(sd, "expert_encoder.ln_pre")
    enc["ln_post"] = layer_norm(sd, "expert_encoder.ln_post")

    for exp, _ in cfg.vision.experts:
        pfx = f"expert_encoder.conv1.{exp}"
        if exp == "rgb":
            enc["conv1_rgb"] = conv(sd, pfx)
        else:
            name = "conv1_seg" if exp == "seg" else f"conv1_{exp}"
            enc[name], enc_stats[name] = _convert_label_stem(sd, pfx)

    for i in range(cfg.vision.layers):
        p = f"expert_encoder.transformer.resblocks.{i}"
        enc[f"resblocks_{i}"] = {
            "attn": packed_mha(sd, f"{p}.0.attn"),
            "ln_1": layer_norm(sd, f"{p}.0.ln_1"),
            "ln_2": layer_norm(sd, f"{p}.0.ln_2"),
            "mlp": {"c_fc": linear(sd, f"{p}.0.mlp.c_fc"),
                    "c_proj": linear(sd, f"{p}.0.mlp.c_proj")},
            "adaptor": adaptor(sd, f"{p}.1.adaptor", f"{p}.1.adaptor_ln"),
        }

    if cfg.vision.has_experts:
        res: Dict[str, Any] = {
            "latents": _np(sd["expert_encoder.resampler.latents"])}
        for i in range(cfg.vision.resampler_layers):
            p = f"expert_encoder.resampler.perceiver_blocks.{i}"
            res[f"blocks_{i}"] = {
                "attn": packed_mha(sd, f"{p}.attn"),
                "ln_1": layer_norm(sd, f"{p}.ln_1"),
                "ln_2": layer_norm(sd, f"{p}.ln_2"),
                "ln_ff": layer_norm(sd, f"{p}.ln_ff"),
                "mlp": {"c_fc": linear(sd, f"{p}.mlp.c_fc"),
                        "c_proj": linear(sd, f"{p}.mlp.c_proj")},
            }
        enc["resampler"] = res

    # -- decoder ----------------------------------------------------------
    dsd = {k[len("text_decoder."):]: v for k, v in sd.items()
           if k.startswith("text_decoder.")}
    dec = convert_hf_roberta_mlm(
        dsd, cfg.decoder.num_hidden_layers,
        layer_prefix_fmt="roberta.encoder.layer.{i}.0")
    for i in range(cfg.decoder.num_hidden_layers):
        p = f"roberta.encoder.layer.{i}"
        dec[f"layers_{i}"]["cross_attn"] = {
            "query": linear(dsd, f"{p}.1.self.query"),
            "key": linear(dsd, f"{p}.1.self.key"),
            "value": linear(dsd, f"{p}.1.self.value"),
        }
        dec[f"layers_{i}"]["cross_out"] = {
            "dense": linear(dsd, f"{p}.1.output.dense"),
            "ln": layer_norm(dsd, f"{p}.1.output.LayerNorm"),
        }
        dec[f"layers_{i}"]["adaptor"] = adaptor(
            dsd, f"{p}.2.adaptor", f"{p}.2.adaptor_ln")
    dec["output_layer"] = _decoder_layer_common(
        dsd, "roberta.encoder.output_layer")

    return {
        "params": {"expert_encoder": enc, "text_decoder": dec},
        "batch_stats": {"expert_encoder": enc_stats} if enc_stats else {},
    }


def uncovered_leaves(init_tree: Dict[str, Any], loaded: Dict[str, Any],
                     path: str = "") -> Tuple[int, list]:
    """(leaf count of init_tree, paths of its leaves that `loaded` does not
    cover). `merge_params` keeps such leaves at init (strict=False, as the
    reference loads the core model); this report is how a caller notices a
    checkpoint whose key layout drifted."""
    total, missing = 0, []
    for k, v in init_tree.items():
        sub = loaded.get(k) if isinstance(loaded, dict) else None
        if isinstance(v, dict):
            t, m = uncovered_leaves(v, sub if isinstance(sub, dict) else {},
                                    f"{path}/{k}")
            total += t
            missing += m
        else:
            total += 1
            if sub is None:
                missing.append(f"{path}/{k}")
    return total, missing


def merge_params(init_tree: Dict[str, Any], loaded: Dict[str, Any],
                 path: str = "") -> Dict[str, Any]:
    """`loaded` laid over `init_tree` (strict=False): loaded leaves replace
    init leaves as fp32, the rest keep their init. Raises on a loaded key
    the init tree lacks and on a shape that differs."""
    out = dict(init_tree)
    for k, v in loaded.items():
        if k not in out:
            raise KeyError(f"converted key not in model: {path}/{k}")
        if isinstance(v, dict) and isinstance(out[k], dict):
            out[k] = merge_params(out[k], v, f"{path}/{k}")
        else:
            want = np.shape(out[k])
            got = np.shape(v)
            if want != got:
                raise ValueError(f"shape mismatch at {path}/{k}: "
                                 f"model {want} vs checkpoint {got}")
            out[k] = np.asarray(v, dtype=np.float32)
    return out
