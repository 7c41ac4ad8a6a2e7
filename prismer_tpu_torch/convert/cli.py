"""Weight conversion CLI, ported from prismer_tpu/convert/cli.py: a
reference checkpoint file in, a flat .npz of its flax-layout tree out (the
JAX package's key format), which the port loads with `load_npz_into`.

  python -m prismer_tpu_torch.convert.cli --kind prismer \\
      --src logging/pretrain_x/pytorch_model.bin --dst pretrain_x.npz \\
      --prismer_model prismer_base --experts full --image_resolution 224

  python -m prismer_tpu_torch.convert.cli --kind clip_vision --src ViT-B-16.pt ...
  python -m prismer_tpu_torch.convert.cli --kind roberta --src roberta-base.bin ...
  python -m prismer_tpu_torch.convert.cli --kind mask2former \\
      --src model_final_f07440.pkl --dst seg_coco.npz
  python -m prismer_tpu_torch.convert.cli --kind {dpt,nnet,dexined,charnet,
                                                  unidet} --src F --dst X.npz
  python -m prismer_tpu_torch.convert.cli --kind clip_text \\
      --src ViT-L-14.pt --dst clip_text_vit_l14.npz

The expert kinds write the tree the label expert loads (the generator
itself reads the reference's checkpoint files and converts them in
memory); `clip_text` writes the OCR generator's CLIP text weights, read
from PRISMER_EXPERT_WEIGHTS as `clip_text_vit_l14.npz`.

Torch files are read with `weights_only=True` (or as a TorchScript archive,
as OpenAI's CLIP files are), detectron2 .pkl files by an unpickler that
takes arrays and plain containers only: reading a file runs none of its
code.
"""

from __future__ import annotations

import argparse
import zipfile
from typing import Any, Dict, List, Tuple

import torch

from prismer_tpu_torch.convert import torch_to_jax as cv
from prismer_tpu_torch.convert.from_jax import (load_jax_variables,
                                                to_jax_variables)
from prismer_tpu_torch.train.checkpoint import load_params_npz, save_tree_npz

FULL_EXPERTS = ["depth", "normal", "seg_coco", "edge", "obj_detection",
                "ocr_detection"]
CORE_KINDS = ("prismer", "clip_vision", "roberta")
EXPERT_KINDS = ("dpt", "nnet", "dexined", "charnet", "mask2former", "unidet",
                "clip_text")
KINDS = CORE_KINDS + EXPERT_KINDS


def _is_torchscript(path: str) -> bool:
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/constants.pkl") for n in z.namelist())


def _load_sd(path: str) -> Dict[str, Any]:
    if path.endswith(".pkl"):
        from prismer_tpu_torch.experts.model_bank import _ArrayUnpickler
        with open(path, "rb") as f:
            obj = _ArrayUnpickler(f, encoding="latin1").load()
    elif _is_torchscript(path):
        obj = torch.jit.load(path, map_location="cpu")
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"],
                                                               dict):
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def _save(tree: Dict[str, Any], dst: str) -> None:
    if not ("params" in tree and isinstance(tree["params"], dict)):
        tree = {"params": tree}
    save_tree_npz(dst, tree)
    print(f"wrote {dst}")


def convert(kind: str, sd: Dict[str, Any], prismer_model: str = "prismer_base",
            experts: Any = "full", image_resolution: int = 224
            ) -> Dict[str, Any]:
    """The tree `--kind` writes for state dict `sd`."""
    if kind == "clip_text":
        from prismer_tpu_torch.experts.clip_text import convert_clip_text
        return convert_clip_text(sd)
    if kind in EXPERT_KINDS:
        from prismer_tpu_torch.convert import experts as cve
        return getattr(cve, f"convert_{kind}")(sd)
    if kind not in CORE_KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    from prismer_tpu_torch.config import build_prismer_config
    if experts == "full":
        experts = FULL_EXPERTS
    elif isinstance(experts, str) and experts != "none":
        experts = experts.split(",")
    cfg = build_prismer_config({
        "experts": experts, "image_resolution": image_resolution,
        "prismer_model": prismer_model, "freeze": "none"})
    if kind == "prismer":
        return cv.convert_prismer_checkpoint(sd, cfg)
    if kind == "clip_vision":
        return {"expert_encoder": cv.convert_clip_vision(sd, cfg)}
    return {"text_decoder": cv.convert_hf_roberta_mlm(
        sd, cfg.decoder.num_hidden_layers)}


def load_npz_into(model: torch.nn.Module, path: str
                  ) -> Tuple[int, List[str]]:
    """Load a converted .npz into `model`, strict=False: the file's leaves
    replace the model's values, the rest keep them (`merge_params`).
    Returns `uncovered_leaves` of the model's tree: (leaf count, paths the
    file did not cover)."""
    tree = load_params_npz(path)
    init = to_jax_variables(model.state_dict())
    merged = {coll: cv.merge_params(sub, tree.get(coll, {}), f"/{coll}")
              for coll, sub in init.items()}
    extra = set(tree) - set(init)
    if extra:
        raise KeyError(f"{path}: collections {sorted(extra)} not in model")
    load_jax_variables(model, merged)
    return cv.uncovered_leaves(init, tree)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", required=True, choices=KINDS)
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--prismer_model", default="prismer_base")
    ap.add_argument("--experts", default="full",
                    help="'full', 'none', or comma-separated list")
    ap.add_argument("--image_resolution", type=int, default=224)
    args = ap.parse_args(argv)
    sd = _load_sd(args.src)
    _save(convert(args.kind, sd, args.prismer_model, args.experts,
                  args.image_resolution), args.dst)


if __name__ == "__main__":
    main()
