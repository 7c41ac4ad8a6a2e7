"""Typed configuration, mirrored from prismer_tpu/config.py.

Same dataclasses, field for field, so a configuration built here equals the
JAX package's. The model registry is read from prismer_tpu/configs/
prismer.json by file path with `json`. Task configurations come in as dicts
(the keys of the reference's YAML task configs); this module reads no YAML.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

REGISTRY_PATH = (Path(__file__).resolve().parents[1] / "prismer_tpu"
                 / "configs" / "prismer.json")

# CLIP vision tower geometry per published model name
VIT_GEOMETRY: Dict[str, Dict[str, int]] = {
    "ViT-B/32": dict(patch_size=32, width=768, layers=12, heads=12),
    "ViT-B/16": dict(patch_size=16, width=768, layers=12, heads=12),
    "ViT-L/14": dict(patch_size=14, width=1024, layers=24, heads=16),
    "ViT-L/14@336px": dict(patch_size=14, width=1024, layers=24, heads=16),
    "ViT-H/14": dict(patch_size=14, width=1280, layers=32, heads=16),
    "ViT-Tiny-Test": dict(patch_size=16, width=64, layers=2, heads=4),
}

# expert name -> input channel count
EXPERT_CHANNELS: Dict[str, int] = {
    "rgb": 3,
    "depth": 1,
    "edge": 1,
    "normal": 3,
    "seg": 64,
    "obj_detection": 64,
    "ocr_detection": 64,
}


def canonical_expert(name: str) -> str:
    """'seg_coco' / 'seg_ade' share the 'seg' stem."""
    return "seg" if "seg" in name else name


def expert_channel_map(experts: Any) -> Dict[str, int]:
    """The modality -> channels dict, always led by rgb; 'none' = rgb only."""
    out = {"rgb": 3}
    if experts in (None, "none", []):
        return out
    for exp in experts:
        out[canonical_expert(exp)] = EXPERT_CHANNELS[canonical_expert(exp)]
    return out


@dataclasses.dataclass(frozen=True)
class TextDecoderConfig:
    """RoBERTa-style decoder hyper-parameters."""

    model_name: str = "roberta-base"
    vocab_size: int = 50265
    hidden_size: int = 768
    vision_hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    is_decoder: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class VisionEncoderConfig:
    """Multi-modal ViT encoder hyper-parameters; `experts` maps canonical
    modality name -> input channels, rgb first."""

    name: str = "ViT-B/16"
    image_resolution: int = 224
    label_resolution: int = 224  # expert label maps are 224x224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    experts: Tuple[Tuple[str, int], ...] = (("rgb", 3),)
    resampler_layers: int = 4
    resampler_heads: int = 8
    resampler_latents: int = 64
    num_instance_slots: int = 128
    max_instances: int = 256

    @property
    def experts_dict(self) -> Dict[str, int]:
        return dict(self.experts)

    @property
    def rgb_tokens(self) -> int:
        return (self.image_resolution // self.patch_size) ** 2

    @property
    def has_experts(self) -> bool:
        return len(self.experts) > 1

    @property
    def num_output_tokens(self) -> int:
        """Encoder output length: rgb patch tokens (+ latents with experts)."""
        n = self.rgb_tokens
        if self.has_experts:
            n += self.resampler_latents
        return n


@dataclasses.dataclass(frozen=True)
class PrismerConfig:
    """Vision encoder + text decoder + task knobs."""

    vision: VisionEncoderConfig
    decoder: TextDecoderConfig
    prismer_model: str = "prismer_base"
    freeze: str = "freeze_vision"
    dtype: str = "bfloat16"  # compute dtype; LayerNorm/softmax stay fp32

    @property
    def experts(self) -> Dict[str, int]:
        return self.vision.experts_dict


def load_registry() -> Dict[str, Any]:
    with open(REGISTRY_PATH) as f:
        return json.load(f)


def build_prismer_config(task_config: Dict[str, Any]) -> PrismerConfig:
    """A PrismerConfig from a task-config dict (keys: experts,
    image_resolution, prismer_model, freeze, dtype)."""
    entry = load_registry()[task_config.get("prismer_model", "prismer_base")]
    fields = {f.name for f in dataclasses.fields(TextDecoderConfig)}
    decoder = TextDecoderConfig(**{k: v for k, v in
                                   entry["roberta_model"].items()
                                   if k in fields})
    vit_name = entry["vit_model"]
    experts = expert_channel_map(task_config.get("experts", "none"))
    vision = VisionEncoderConfig(
        name=vit_name,
        image_resolution=int(task_config.get("image_resolution", 224)),
        experts=tuple(experts.items()),
        **VIT_GEOMETRY[vit_name],
    )
    return PrismerConfig(
        vision=vision,
        decoder=decoder,
        prismer_model=task_config.get("prismer_model", "prismer_base"),
        freeze=task_config.get("freeze", "none"),
        dtype=task_config.get("dtype", "bfloat16"),
    )


def tiny_test_config(experts: Optional[List[str]] = None,
                     image_resolution: int = 64) -> Dict[str, Any]:
    """A tiny task config for unit tests (prismer_tiny)."""
    return {
        "dataset": "demo",
        "experts": experts if experts is not None else "none",
        "image_resolution": image_resolution,
        "prismer_model": "prismer_tiny",
        "freeze": "freeze_vision",
        "prefix": "A picture of",
        "batch_size_train": 2,
        "batch_size_test": 2,
        "init_lr": 1e-4,
        "weight_decay": 0.05,
        "min_lr": 0.0,
        "max_epoch": 1,
    }


# the captioning slice's configuration (configs/caption.yaml 'coco' entry)
CAPTION_EXPERTS = ["depth", "normal", "seg_coco", "edge", "obj_detection",
                   "ocr_detection"]
