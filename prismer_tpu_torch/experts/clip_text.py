"""CLIP text encoder (inference) for the OCR expert's word embeddings: port
of prismer_tpu/experts/clip_text.py.

The reference embeds every recognised word with OpenAI CLIP's text tower
(clip.tokenize + encode_text), then projects 768 -> 64 with its PCA.
CLIP ViT-L/14's text tower: token embedding (vocabulary 49,408, width
768), learned positional embedding (77), 12 causal blocks (heads 12,
QuickGELU, additive -1e9 above the diagonal, scores in fp32), final
LayerNorm, features at the <|endoftext|> token (the row's largest id),
`text_projection` to 768.

`load_clip_text` reads the converted weights (`clip_text_vit_l14.npz`,
from `convert.cli --kind clip_text`) and the BPE vocabulary
(`bpe_simple_vocab_16e6.txt[.gz]`) under PRISMER_EXPERT_WEIGHTS, and returns
None when either is missing: the OCR generator then writes the background
vector with a warning, as the JAX package does.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from prismer_tpu_torch.convert.from_jax import load_jax_variables
from prismer_tpu_torch.experts.layers import normal_init
from prismer_tpu_torch.experts.segmentation.swin import (merge_heads,
                                                        split_heads)
from prismer_tpu_torch.models.layers import Dense, LayerNorm, quick_gelu

FP32 = torch.float32
CLIP_TEXT_WEIGHTS = "clip_text_vit_l14.npz"
CLIP_BPE_VOCAB = ("bpe_simple_vocab_16e6.txt.gz", "bpe_simple_vocab_16e6.txt")
CAUSAL_BLOCKED = -1e9


class CLIPTextBlock(nn.Module):
    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(dim, 1e-5, device)
        self.attn_in = Dense(dim, 3 * dim, FP32, device)
        self.attn_out = Dense(dim, dim, FP32, device)
        self.ln_2 = LayerNorm(dim, 1e-5, device)
        self.c_fc = Dense(dim, 4 * dim, FP32, device)
        self.c_proj = Dense(4 * dim, dim, FP32, device)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(t, self.heads)
                   for t in self.attn_in(self.ln_1(x)).chunk(3, dim=-1))
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        o = torch.matmul(torch.softmax(s + causal, dim=-1), v)
        x = x + self.attn_out(merge_heads(o))
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class CLIPTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 49408, width: int = 768,
                 layers: int = 12, heads: int = 12, context: int = 77,
                 device=None):
        super().__init__()
        self.layers = layers
        self.token_embedding = nn.Parameter(torch.zeros(
            vocab_size, width, device=device))
        self.positional_embedding = nn.Parameter(torch.zeros(
            context, width, device=device))
        for i in range(layers):
            setattr(self, f"block_{i}", CLIPTextBlock(width, heads, device))
        self.ln_final = LayerNorm(width, 1e-5, device)
        self.text_projection = nn.Parameter(torch.zeros(width, width,
                                                        device=device))

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids (B, context) int (EOT = the row's largest id) ->
        (B, width) projected features."""
        ctx = self.positional_embedding.shape[0]
        x = self.token_embedding[token_ids] + self.positional_embedding[None]
        causal = torch.triu(torch.full((ctx, ctx), CAUSAL_BLOCKED, dtype=FP32,
                                       device=x.device), diagonal=1)
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x, causal)
        x = self.ln_final(x)
        eot = torch.argmax(token_ids, dim=-1)
        feats = x[torch.arange(x.shape[0], device=x.device), eot]
        return feats.float() @ self.text_projection


# flax initialisers of the raw parameters
RAW_INIT = {"token_embedding": normal_init(0.02),
            "positional_embedding": normal_init(0.01),
            "text_projection": normal_init(0.02)}


def text_encoder_shape(params: Dict[str, Any]) -> Dict[str, int]:
    """CLIPTextEncoder's arguments for a converted tree's `params`."""
    vocab, width = np.shape(params["token_embedding"])
    return dict(vocab_size=vocab, width=width,
                layers=sum(1 for k in params if k.startswith("block_")),
                heads=max(width // 64, 1),
                context=np.shape(params["positional_embedding"])[0])


def load_clip_text(weights_dir: Optional[str] = None,
                   device: torch.device | str = "cuda"
                   ) -> Optional[Tuple[CLIPTextEncoder, Any]]:
    """(encoder on `device`, CLIPTokenizer) when both the converted CLIP
    text weights and the BPE vocabulary are under the expert-weights
    directory, else None."""
    from prismer_tpu_torch.tokenizer import CLIPTokenizer
    from prismer_tpu_torch.train.checkpoint import load_params_npz

    weights_dir = weights_dir or os.environ.get("PRISMER_EXPERT_WEIGHTS",
                                                "experts/expert_weights")
    wpath = os.path.join(weights_dir, CLIP_TEXT_WEIGHTS)
    vpath = next((os.path.join(weights_dir, v) for v in CLIP_BPE_VOCAB
                  if os.path.exists(os.path.join(weights_dir, v))), None)
    if not os.path.exists(wpath) or vpath is None:
        return None
    tree = load_params_npz(wpath)
    params = tree.get("params", tree)
    model = CLIPTextEncoder(device="meta", **text_encoder_shape(params))
    model = model.to_empty(device=device)
    load_jax_variables(model, {"params": params})
    tok = CLIPTokenizer.from_file(vpath)
    return model.eval().requires_grad_(False), tok


@torch.no_grad()
def embed_words(words: Sequence[str], clip_ctx, tables) -> np.ndarray:
    """words -> (N, 64) PCA'd CLIP text features (clip.tokenize ->
    encode_text -> the PCA transform)."""
    model, tok = clip_ctx
    ids = tok([w.lower() for w in words])
    device = model.token_embedding.device
    emb = model(torch.from_numpy(ids).to(device=device, dtype=torch.int64))
    return tables.pca_project(emb.cpu().numpy().astype(np.float32))


def convert_clip_text(sd: Dict[str, Any]) -> Dict[str, Any]:
    """OpenAI CLIP state dict -> CLIPTextEncoder params (flax layout)."""
    from prismer_tpu_torch.convert.experts import _np, linear
    from prismer_tpu_torch.convert.torch_to_jax import layer_norm
    P: Dict[str, Any] = {
        "token_embedding": _np(sd["token_embedding.weight"]),
        "positional_embedding": _np(sd["positional_embedding"]),
        "text_projection": _np(sd["text_projection"]),
        "ln_final": layer_norm(sd, "ln_final"),
    }
    i = 0
    while f"transformer.resblocks.{i}.attn.in_proj_weight" in sd:
        p = f"transformer.resblocks.{i}"
        P[f"block_{i}"] = {
            "ln_1": layer_norm(sd, f"{p}.ln_1"),
            "ln_2": layer_norm(sd, f"{p}.ln_2"),
            "attn_in": {"kernel": _np(sd[f"{p}.attn.in_proj_weight"]).T,
                        "bias": _np(sd[f"{p}.attn.in_proj_bias"])},
            "attn_out": linear(sd, f"{p}.attn.out_proj"),
            "c_fc": linear(sd, f"{p}.mlp.c_fc"),
            "c_proj": linear(sd, f"{p}.mlp.c_proj"),
        }
        i += 1
    return {"params": P}
