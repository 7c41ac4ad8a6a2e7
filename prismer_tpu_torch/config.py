"""Typed configuration, mirrored from prismer_tpu/config.py.

Same dataclasses, field for field, so a configuration built here equals the
JAX package's. The model registry is read from prismer_tpu/configs/
prismer.json by file path with `json`, and the task configurations from
prismer_tpu/configs/*.yaml by file path with `load_task_config`, whose
reader (`parse_yaml`) takes the subset of YAML those files use and
resolves it as PyYAML's `safe_load` does. Nothing here imports `yaml`.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

CONFIG_DIR = Path(__file__).resolve().parents[1] / "prismer_tpu" / "configs"
REGISTRY_PATH = CONFIG_DIR / "prismer.json"

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


# ---------------------------------------------------------------------------
# task configurations: the YAML subset of prismer_tpu/configs/*.yaml
# ---------------------------------------------------------------------------

def default_config_path(task: str) -> str:
    """prismer_tpu/configs/<task>.yaml."""
    return str(CONFIG_DIR / f"{task}.yaml")


def load_task_config(path: str, target: Optional[str] = None
                     ) -> Dict[str, Any]:
    """A task YAML as a dict; `target` selects the dataset key of a keyed
    file (caption.yaml: coco / nocaps / demo)."""
    with open(path, encoding="utf-8") as f:
        cfg = parse_yaml(f.read(), str(path))
    if target is not None:
        cfg = cfg[target]
    return cfg


# The plain scalars the configs use, resolved as PyYAML's YAML 1.1
# implicit resolvers (yaml/resolver.py) resolve them: null, bool, decimal
# and 0x ints (with '_' separators) and floats with a dot. A float needs
# its dot and a signed exponent, so `1e-4` stays a string there.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = ("yes", "true", "on")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_HEX = re.compile(r"^[-+]?0x[0-9a-fA-F_]+$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9][0-9_]*)"
                    r"(?:[eE][-+][0-9]+)?$")
# the other plain scalars PyYAML resolves to something else than a string
# (binary, octal and base-60 ints, base-60 floats, .inf / .nan, dates and
# timestamps, the merge and value keys): refused, not reproduced; so is a
# string that begins like a date
_UNSUPPORTED = re.compile(r"""^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+
                          |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                          |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)
                          |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$""", re.X)
_ESCAPES = {'"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t"}
# characters that may not start a plain scalar (anchors, aliases, tags,
# block scalars, flow mappings, directives and reserved indicators among
# them); '-', '?' and ':' only when a space or the end follows
_NOT_PLAIN = set("[]{},#&*!|>'\"%@`")


class _YamlError(ValueError):
    pass


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar as PyYAML's safe_load resolves it, for the
    forms the configs use; ValueError on any other that PyYAML would not
    read as a string."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _HEX.match(text):
        sign = -1 if text[0] == "-" else 1
        return sign * int(text.lstrip("+-").replace("_", "")[2:], 16)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _UNSUPPORTED.match(text):
        raise _YamlError(f"the scalar {text!r} (a binary, octal or base-60 "
                         "number, .inf, .nan, a timestamp, a merge or value "
                         "key) is not supported")
    return text


class _Line:
    """One line of the document, scanned left to right."""

    def __init__(self, text: str, number: int):
        self.text = text
        self.number = number
        self.pos = 0

    def peek(self, k: int = 0) -> str:
        i = self.pos + k
        return self.text[i] if i < len(self.text) else ""

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.pos += 1

    def at_end(self) -> bool:
        """Only spaces or a comment left."""
        self.skip_spaces()
        return self.peek() in ("", "#")

    def quoted(self) -> str:
        quote = self.peek()
        self.pos += 1
        out = []
        while True:
            ch = self.peek()
            if ch == "":
                raise _YamlError("a quoted scalar must close on its line")
            self.pos += 1
            if quote == "'" and ch == "'":
                if self.peek() == "'":
                    out.append("'")
                    self.pos += 1
                    continue
                return "".join(out)
            if quote == '"' and ch == '"':
                return "".join(out)
            if quote == '"' and ch == "\\":
                code = self.peek()
                self.pos += 1
                if code not in _ESCAPES:
                    raise _YamlError(f"unsupported escape \\{code}")
                out.append(_ESCAPES[code])
                continue
            out.append(ch)

    def plain(self, flow: bool) -> str:
        """A plain scalar up to ' #', the end of the line, or (in a flow
        list) ',' / ']'; a ': ' inside it would open a mapping."""
        ch, nxt = self.peek(), self.peek(1)
        if ch in _NOT_PLAIN or (ch in "-?:" and nxt in ("", " ")):
            raise _YamlError(f"unsupported construct starting with {ch!r} "
                             "(anchors, aliases, tags, block scalars, flow "
                             "mappings and block sequences are refused)")
        start = self.pos
        while True:
            ch = self.peek()
            if ch == "":
                break
            if ch == "#" and self.text[self.pos - 1] == " ":
                break
            if ch == ":" and self.peek(1) in ("", " ", ",", "]"):
                raise _YamlError("a mapping inside a value is not supported")
            if flow and ch in ",]":
                break
            if flow and ch in "[{}":
                raise _YamlError(f"{ch!r} inside a flow scalar")
            self.pos += 1
        return self.text[start:self.pos].rstrip(" ")

    def flow_list(self) -> List[Any]:
        self.pos += 1       # '['
        items: List[Any] = []
        while True:
            self.skip_spaces()
            ch = self.peek()
            if ch == "]":
                self.pos += 1
                return items
            if ch == "" or ch == "#":
                raise _YamlError("a flow list must close on its line")
            items.append(self.value(flow=True))
            self.skip_spaces()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
            elif ch != "]":
                raise _YamlError(f"expected ',' or ']' in a flow list, got "
                                 f"{ch!r}")

    def value(self, flow: bool = False) -> Any:
        ch = self.peek()
        if ch in ("'", '"'):
            return self.quoted()
        if ch == "[":
            return self.flow_list()
        return resolve_plain(self.plain(flow))

    def key(self) -> Any:
        if self.peek() in ("'", '"'):
            key = self.quoted()
            self.skip_spaces()
        else:
            ch, nxt = self.peek(), self.peek(1)
            if ch in _NOT_PLAIN or (ch in "-?:" and nxt in ("", " ")):
                raise _YamlError(f"unsupported construct starting with "
                                 f"{ch!r} (block sequences, complex keys, "
                                 "anchors, tags and flow collections are "
                                 "refused)")
            start = self.pos
            while not (self.peek() == ":" and self.peek(1) in ("", " ")):
                if self.peek() == "" or (self.peek() == "#"
                                         and self.text[self.pos - 1] == " "):
                    raise _YamlError("expected 'key: value'")
                self.pos += 1
            key = resolve_plain(self.text[start:self.pos].rstrip(" "))
        if self.peek() != ":" or self.peek(1) not in ("", " "):
            raise _YamlError("expected ':' after the key")
        self.pos += 1
        return key


def parse_yaml(text: str, source: str = "<string>") -> Any:
    """The YAML subset the task configs use, as `yaml.safe_load` gives it:
    block mappings nested by indentation, flow lists `[...]`, '#' comments,
    single- and double-quoted strings and plain scalars resolved by YAML
    1.1's rules (PyYAML's). Anything else raises ValueError with the file
    and line: anchors and aliases, tags, block scalars, flow mappings,
    block sequences, multi-line scalars, several documents, tabs as
    indentation."""
    entries = []        # (indent, key, value or _NESTED, line number)
    for number, raw in enumerate(text.splitlines(), 1):
        line = _Line(raw, number)
        try:
            body = raw.lstrip(" ")
            if body.startswith("\t") or (body == "" and "\t" in raw):
                raise _YamlError("tabs may not indent")
            if raw.startswith(("---", "...", "%")):
                raise _YamlError("document markers and directives are not "
                                 "supported (one document per file)")
            if line.at_end():
                continue
            indent = line.pos
            key = line.key()
            if line.at_end():
                value = _NESTED
            else:
                value = line.value()
                if not line.at_end():
                    raise _YamlError("unexpected text after the value")
        except _YamlError as e:
            raise ValueError(f"{source}:{number}: {e}: {raw!r}") from None
        entries.append((indent, key, value, number))
    if not entries:
        return None
    out, i = _block(entries, 0, entries[0][0], source)
    if i < len(entries):
        raise ValueError(f"{source}:{entries[i][3]}: bad indentation")
    return out


_NESTED = object()


def _block(entries, i: int, indent: int, source: str):
    out: Dict[Any, Any] = {}
    while i < len(entries) and entries[i][0] == indent:
        _, key, value, number = entries[i]
        i += 1
        if value is _NESTED:
            if i < len(entries) and entries[i][0] > indent:
                value, i = _block(entries, i, entries[i][0], source)
            else:
                value = None
        elif i < len(entries) and entries[i][0] > indent:
            raise ValueError(f"{source}:{entries[i][3]}: a value continued "
                             "on the next line is not supported")
        out[key] = value
        if i < len(entries) and indent < entries[i][0]:
            raise ValueError(f"{source}:{entries[i][3]}: bad indentation")
    return out, i
