"""Published expert checkpoints -> flax-layout parameter trees, numpy only.

Copied from prismer_tpu/convert/experts.py (every converter there:
`convert_swin`, `convert_mask2former`, `convert_dpt`, `convert_nnet`,
`convert_dexined`, `convert_charnet`, `convert_unidet` and their helpers)
and prismer_tpu/convert/torch_to_jax.py (`_np`, `linear`, `conv`), which
the port cannot import. The tree they return is what the JAX package would load;
`convert.from_jax.load_jax_variables` places it into the port.

Layout rules: torch Linear weight (out, in) -> Dense kernel (in, out);
torch Conv2d weight (O, I, H, W) -> Conv kernel (H, W, I, O); torch
ConvTranspose2d weight (in, out, kh, kw) -> the JAX package's (kh, kw,
out, in) kernel; BatchNorm -> params {scale, bias} + batch_stats {mean,
var}.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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


def batch_norm(sd: Dict[str, Any], prefix: str
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    params = {"scale": _np(sd[f"{prefix}.weight"]),
              "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


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


def conv_transpose(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _bn_pair(sd, prefix):
    return batch_norm(sd, prefix)


def _double_conv(sd, p):
    params, stats = {}, {}
    params["conv1"] = conv(sd, f"{p}.conv1")
    params["bn1"], stats["bn1"] = _bn_pair(sd, f"{p}.bn1")
    params["conv2"] = conv(sd, f"{p}.conv2")
    params["bn2"], stats["bn2"] = _bn_pair(sd, f"{p}.bn2")
    return params, stats


def _single_conv(sd, p, use_bn=True):
    params, stats = {"conv": conv(sd, f"{p}.conv")}, {}
    if use_bn:
        params["bn"], stats["bn"] = _bn_pair(sd, f"{p}.bn")
    return params, stats


def _dense_block(sd, p, num_layers):
    params, stats = {}, {}
    for i in range(num_layers):
        lp, ls = {}, {}
        q = f"{p}.denselayer{i + 1}"
        lp["conv1"] = conv(sd, f"{q}.conv1")
        lp["bn1"], ls["bn1"] = _bn_pair(sd, f"{q}.norm1")
        lp["conv2"] = conv(sd, f"{q}.conv2")
        lp["bn2"], ls["bn2"] = _bn_pair(sd, f"{q}.norm2")
        params[f"denselayer_{i}"] = lp
        stats[f"denselayer_{i}"] = ls
    return params, stats


def _up_block(sd, p, up_scale):
    params = {}
    for i in range(up_scale):
        params[f"conv_{i}"] = conv(sd, f"{p}.features.{3 * i}")
        params[f"deconv_{i}"] = conv_transpose(sd, f"{p}.features.{3 * i + 2}")
    return params


def _conv1d_as_dense(sd, prefix):
    """torch Conv1d(k=1) weight (out, in, 1) -> Dense kernel (in, out)."""
    out = {"kernel": _np(sd[f"{prefix}.weight"])[:, :, 0].T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def convert_nnet(sd: Dict[str, Any]) -> Dict[str, Any]:
    """NNET scannet.pt checkpoint -> params for experts.normal.NNET.

    gen-efficientnet encoder naming (encoder.original_model.*) + decoder
    naming (decoder.conv2, decoder.up{1-4}._net.{0,1,3,4},
    decoder.out_conv_res8, decoder.out_conv_res{4,2,1}.{0,2,4,6})."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    enc = "encoder.original_model"
    P: Dict[str, Any] = {}
    S: Dict[str, Any] = {}

    E: Dict[str, Any] = {"conv_stem": conv(sd, f"{enc}.conv_stem")}
    ES: Dict[str, Any] = {}
    E["bn1"], ES["bn1"] = batch_norm(sd, f"{enc}.bn1")

    from prismer_tpu_torch.experts.normal.model import B5_STAGES
    for s, (reps, k, stride, e, out_ch) in enumerate(B5_STAGES):
        for r in range(reps):
            q = f"{enc}.blocks.{s}.{r}"
            name = f"blocks_{s}_{r}"
            blk: Dict[str, Any] = {}
            st: Dict[str, Any] = {}
            blk["conv_dw"] = {"conv": conv(sd, f"{q}.conv_dw")}
            blk["se"] = {"conv_reduce": conv(sd, f"{q}.se.conv_reduce"),
                         "conv_expand": conv(sd, f"{q}.se.conv_expand")}
            if e == 1:
                blk["conv_pw"] = conv(sd, f"{q}.conv_pw")
                blk["bn1"], st["bn1"] = batch_norm(sd, f"{q}.bn1")
                blk["bn2"], st["bn2"] = batch_norm(sd, f"{q}.bn2")
            else:
                blk["conv_pw"] = conv(sd, f"{q}.conv_pw")
                blk["conv_pwl"] = conv(sd, f"{q}.conv_pwl")
                blk["bn1"], st["bn1"] = batch_norm(sd, f"{q}.bn1")
                blk["bn2"], st["bn2"] = batch_norm(sd, f"{q}.bn2")
                blk["bn3"], st["bn3"] = batch_norm(sd, f"{q}.bn3")
            E[name] = blk
            ES[name] = st
    E["conv_head"] = conv(sd, f"{enc}.conv_head")
    P["encoder"] = E
    S["encoder"] = ES

    P["conv2"] = conv(sd, "decoder.conv2")
    for i in range(1, 5):
        q = f"decoder.up{i}._net"
        up: Dict[str, Any] = {"conv1": conv(sd, f"{q}.0"),
                              "conv2": conv(sd, f"{q}.3")}
        st = {}
        up["bn1"], st["bn1"] = batch_norm(sd, f"{q}.1")
        up["bn2"], st["bn2"] = batch_norm(sd, f"{q}.4")
        P[f"up{i}"] = up
        S[f"up{i}"] = st
    P["out_conv_res8"] = conv(sd, "decoder.out_conv_res8")
    for res in (4, 2, 1):
        q = f"decoder.out_conv_res{res}"
        P[f"out_conv_res{res}"] = {
            "fc0": _conv1d_as_dense(sd, f"{q}.0"),
            "fc1": _conv1d_as_dense(sd, f"{q}.2"),
            "fc2": _conv1d_as_dense(sd, f"{q}.4"),
            "fc3": _conv1d_as_dense(sd, f"{q}.6"),
        }
    return {"params": P, "batch_stats": S}


def group_norm(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _rcu(sd, p):
    return {"conv1": conv(sd, f"{p}.conv1"), "conv2": conv(sd, f"{p}.conv2")}


def convert_dpt(sd: Dict[str, Any]) -> Dict[str, Any]:
    """MiDaS DPT-hybrid checkpoint (dpt_hybrid-midas-501f0c75.pt) -> params
    for experts.depth.DPTDepthModel. Key namespace: pretrained.model.* (timm
    vit_base_resnet50_384) + pretrained.act_postprocess{3,4} + scratch.*."""
    P: Dict[str, Any] = {}
    pm = "pretrained.model"

    # hybrid ResNetV2 backbone
    bb: Dict[str, Any] = {
        "stem_conv": conv(sd, f"{pm}.patch_embed.backbone.stem.conv"),
        "stem_norm": {"GroupNorm_0": group_norm(
            sd, f"{pm}.patch_embed.backbone.stem.norm")},
    }
    for s, n_blocks in enumerate((3, 4, 9)):
        stage: Dict[str, Any] = {}
        for b in range(n_blocks):
            q = f"{pm}.patch_embed.backbone.stages.{s}.blocks.{b}"
            blk = {
                "norm1": {"GroupNorm_0": group_norm(sd, f"{q}.norm1")},
                "norm2": {"GroupNorm_0": group_norm(sd, f"{q}.norm2")},
                "norm3": {"GroupNorm_0": group_norm(sd, f"{q}.norm3")},
                "conv1": conv(sd, f"{q}.conv1"),
                "conv2": conv(sd, f"{q}.conv2"),
                "conv3": conv(sd, f"{q}.conv3"),
            }
            if f"{q}.downsample.conv.weight" in sd:
                blk["downsample_conv"] = conv(sd, f"{q}.downsample.conv")
            stage[f"block_{b}"] = blk
        bb[f"stage_{s}"] = stage
    P["backbone"] = bb

    P["patch_proj"] = conv(sd, f"{pm}.patch_embed.proj")
    P["cls_token"] = _np(sd[f"{pm}.cls_token"])
    P["pos_embed"] = _np(sd[f"{pm}.pos_embed"])[0]

    for i in range(12):
        q = f"{pm}.blocks.{i}"
        P[f"vit_block_{i}"] = {
            "norm1": {"scale": _np(sd[f"{q}.norm1.weight"]),
                      "bias": _np(sd[f"{q}.norm1.bias"])},
            "norm2": {"scale": _np(sd[f"{q}.norm2.weight"]),
                      "bias": _np(sd[f"{q}.norm2.bias"])},
            "qkv": linear(sd, f"{q}.attn.qkv"),
            "proj": linear(sd, f"{q}.attn.proj"),
            "fc1": linear(sd, f"{q}.mlp.fc1"),
            "fc2": linear(sd, f"{q}.mlp.fc2"),
        }

    # reassemble heads (project readout + conv)
    P["post3_readout"] = linear(sd, "pretrained.act_postprocess3.0.project.0")
    P["post3_proj"] = conv(sd, "pretrained.act_postprocess3.3")
    P["post4_readout"] = linear(sd, "pretrained.act_postprocess4.0.project.0")
    P["post4_proj"] = conv(sd, "pretrained.act_postprocess4.3")
    P["post4_down"] = conv(sd, "pretrained.act_postprocess4.4")

    for i in range(1, 5):
        P[f"layer{i}_rn"] = conv(sd, f"scratch.layer{i}_rn")
    for i in range(1, 5):
        q = f"scratch.refinenet{i}"
        blk = {"rcu2": _rcu(sd, f"{q}.resConfUnit2"),
               "out_conv": conv(sd, f"{q}.out_conv")}
        if i != 4:  # refinenet4 takes no skip; its rcu1 weights are unused
            blk["rcu1"] = _rcu(sd, f"{q}.resConfUnit1")
        P[f"refinenet{i}"] = blk

    P["head_conv1"] = conv(sd, "scratch.output_conv.0")
    P["head_conv2"] = conv(sd, "scratch.output_conv.2")
    P["head_conv3"] = conv(sd, "scratch.output_conv.4")
    return {"params": P}


# ---------------------------------------------------------------------------
# CharNet (icdar2015_hourglass88.pth)
# ---------------------------------------------------------------------------

def _charnet_residual(sd, p):
    params = {"conv1": conv(sd, f"{p}.conv_1.0"),
              "conv2": conv(sd, f"{p}.conv_2.0")}
    stats = {}
    params["bn1"], stats["bn1"] = batch_norm(sd, f"{p}.conv_1.1")
    params["bn2"], stats["bn2"] = batch_norm(sd, f"{p}.conv_2.1")
    if f"{p}.skip.0.weight" in sd:
        params["skip_conv"] = conv(sd, f"{p}.skip.0")
        params["skip_bn"], stats["skip_bn"] = batch_norm(sd, f"{p}.skip.1")
    return params, stats


def _charnet_reslayer(sd, p, num_blocks):
    params, stats = {}, {}
    for i in range(num_blocks):
        params[f"res_{i}"], stats[f"res_{i}"] = _charnet_residual(
            sd, f"{p}.{i}")
    return params, stats


def _charnet_hourglass(sd, p, n, blocks=(2, 2, 2, 2)):
    params, stats = {}, {}
    for name, nb in (("up_1", blocks[0]), ("low_1", blocks[0]),
                     ("low_3", blocks[0])):
        params[name], stats[name] = _charnet_reslayer(sd, f"{p}.{name}", nb)
    if n <= 1:
        params["low_2"], stats["low_2"] = _charnet_reslayer(
            sd, f"{p}.low_2", blocks[1])
    else:
        params["low_2"], stats["low_2"] = _charnet_hourglass(
            sd, f"{p}.low_2", n - 1, blocks[1:] + blocks[-1:])
    return params, stats


def _charnet_cbr(sd, p):
    """_conv3x3_bn_relu OrderedDict naming (model.py:21-29)."""
    params = {"conv": conv(sd, f"{p}.conv")}
    stats = {}
    params["bn"], stats["bn"] = batch_norm(sd, f"{p}.bn")
    return params, stats


def convert_charnet(sd: Dict[str, Any]) -> Dict[str, Any]:
    """CharNet checkpoint -> params for experts.ocr_detection.CharNet."""
    P: Dict[str, Any] = {}
    S: Dict[str, Any] = {}

    bb: Dict[str, Any] = {"pre_conv": conv(sd, "backbone.pre.0")}
    bbs: Dict[str, Any] = {}
    bb["pre_bn"], bbs["pre_bn"] = batch_norm(sd, "backbone.pre.1")
    bb["pre_res"], bbs["pre_res"] = _charnet_residual(sd, "backbone.pre.3")
    for i in range(2):
        bb[f"hg_{i}"], bbs[f"hg_{i}"] = _charnet_hourglass(
            sd, f"backbone.hourglass_blocks.{i}", 3)
    P["backbone"] = bb
    S["backbone"] = bbs

    for ours, theirs, final in (
            ("word_detector", "word_detector", "word_det_conv_final"),
            ("char_detector", "char_detector", "character_det_conv_final")):
        head: Dict[str, Any] = {}
        hs: Dict[str, Any] = {}
        head["det_conv_final"], hs["det_conv_final"] = _charnet_cbr(
            sd, f"{theirs}.{final}")
        prefix = "word" if "word" in theirs else "char"
        head["fg_feat"], hs["fg_feat"] = _charnet_cbr(
            sd, f"{theirs}.{prefix}_fg_feat")
        head["reg_feat"], hs["reg_feat"] = _charnet_cbr(
            sd, f"{theirs}.{prefix}_regression_feat")
        head["fg_pred"] = conv(sd, f"{theirs}.{prefix}_fg_pred")
        head["tblr_pred"] = conv(sd, f"{theirs}.{prefix}_tblr_pred")
        if prefix == "word":
            head["orient_pred"] = conv(sd, f"{theirs}.orient_pred")
        P[ours] = head
        S[ours] = hs

    for i in range(3):
        P[f"recog_{i}"], S[f"recog_{i}"] = _charnet_cbr(
            sd, f"char_recognizer.body.{i}")
    P["recog_cls"] = conv(sd, "char_recognizer.classifier")
    return {"params": P, "batch_stats": S}


# ---------------------------------------------------------------------------
# UniDet (detectron2 GeneralizedRCNN; ResNeSt-200 + FPN P3-P7 + cascade)
# ---------------------------------------------------------------------------

def _d2_conv(sd, p):
    """detectron2 Conv2d with attached .norm (SyncBN) -> conv + bn pair."""
    params = {"kernel": _np(sd[f"{p}.weight"]).transpose(2, 3, 1, 0)}
    if f"{p}.bias" in sd:
        params["bias"] = _np(sd[f"{p}.bias"])
    stats = None
    if f"{p}.norm.weight" in sd:
        bn = {"scale": _np(sd[f"{p}.norm.weight"]),
              "bias": _np(sd[f"{p}.norm.bias"])}
        stats = {"mean": _np(sd[f"{p}.norm.running_mean"]),
                 "var": _np(sd[f"{p}.norm.running_var"])}
        return params, bn, stats
    return params, None, None


def convert_unidet(sd: Dict[str, Any], blocks=None) -> Dict[str, Any]:
    """UniDet checkpoint -> params for experts.obj_detection.UniDet.

    Key namespace from the reference source (unidet/modeling/backbone/
    resnest.py attribute names under detectron2's module registry):
    backbone.bottom_up.stem.conv1_{1,2,3}, backbone.bottom_up.res{2-5}.{b}
    .{conv1,conv2(.conv/.bn0/.fc1/.bn1/.fc2),conv3,shortcut},
    backbone.fpn_lateral{3-5}/fpn_output{3-5}/top_block.{p6,p7},
    proposal_generator.rpn_head.{conv,objectness_logits,anchor_deltas},
    roi_heads.box_head.{s}.conv{1-4}/fc1 + roi_heads.box_predictor.{s}
    .{cls_score,bbox_pred}."""
    from prismer_tpu_torch.experts.obj_detection.resnest import \
        RESNEST200_BLOCKS
    if blocks is None:
        blocks = RESNEST200_BLOCKS

    P: Dict[str, Any] = {}
    S: Dict[str, Any] = {}
    bb: Dict[str, Any] = {}
    bbs: Dict[str, Any] = {}
    bu = "backbone.bottom_up"
    for i in (1, 2, 3):
        cp, bn, st = _d2_conv(sd, f"{bu}.stem.conv1_{i}")
        bb[f"stem_conv{i}"] = cp
        bb[f"stem_bn{i}"] = bn
        bbs[f"stem_bn{i}"] = st
    for s, n in enumerate(blocks):
        for b in range(n):
            q = f"{bu}.res{s + 2}.{b}"
            blk: Dict[str, Any] = {}
            bst: Dict[str, Any] = {}
            cp, bn, st = _d2_conv(sd, f"{q}.conv1")
            blk["conv1"], blk["bn1"], bst["bn1"] = cp, bn, st
            splat: Dict[str, Any] = {"conv": conv(sd, f"{q}.conv2.conv"),
                                     "fc1": conv(sd, f"{q}.conv2.fc1"),
                                     "fc2": conv(sd, f"{q}.conv2.fc2")}
            sst: Dict[str, Any] = {}
            splat["bn0"], sst["bn0"] = batch_norm(sd, f"{q}.conv2.bn0")
            splat["bn1"], sst["bn1"] = batch_norm(sd, f"{q}.conv2.bn1")
            blk["conv2"] = splat
            bst["conv2"] = sst
            cp, bn, st = _d2_conv(sd, f"{q}.conv3")
            blk["conv3"], blk["bn3"], bst["bn3"] = cp, bn, st
            if f"{q}.shortcut.weight" in sd:
                cp, bn, st = _d2_conv(sd, f"{q}.shortcut")
                blk["shortcut_conv"] = cp
                blk["shortcut_bn"] = bn
                bst["shortcut_bn"] = st
            bb[f"res{s + 2}_block{b}"] = blk
            bbs[f"res{s + 2}_block{b}"] = bst
    P["backbone"] = bb
    S["backbone"] = bbs

    fpn: Dict[str, Any] = {}
    fst: Dict[str, Any] = {}
    for lvl, f in ((3, "res3"), (4, "res4"), (5, "res5")):
        cp, bn, st = _d2_conv(sd, f"backbone.fpn_lateral{lvl}")
        fpn[f"lateral_{f}"], fpn[f"lateral_bn_{f}"] = cp, bn
        fst[f"lateral_bn_{f}"] = st
        cp, bn, st = _d2_conv(sd, f"backbone.fpn_output{lvl}")
        fpn[f"output_p{lvl}"], fpn[f"output_bn_p{lvl}"] = cp, bn
        fst[f"output_bn_p{lvl}"] = st
    fpn["p6"], _, _ = _d2_conv(sd, "backbone.top_block.p6")
    fpn["p7"], _, _ = _d2_conv(sd, "backbone.top_block.p7")
    P["fpn"] = fpn
    S["fpn"] = fst

    rpn = "proposal_generator.rpn_head"
    P["rpn"] = {"conv": _d2_conv(sd, f"{rpn}.conv")[0],
                "objectness": _d2_conv(sd, f"{rpn}.objectness_logits")[0],
                "anchor_deltas": _d2_conv(sd, f"{rpn}.anchor_deltas")[0]}

    for stage in range(3):
        head: Dict[str, Any] = {}
        hst: Dict[str, Any] = {}
        for i in range(4):
            cp, bn, st = _d2_conv(sd,
                                  f"roi_heads.box_head.{stage}.conv{i + 1}")
            head[f"conv{i}"] = cp
            head[f"conv_bn{i}"] = bn
            hst[f"conv_bn{i}"] = st
        head["fc1"] = linear(sd, f"roi_heads.box_head.{stage}.fc1")
        head["cls_score"] = linear(
            sd, f"roi_heads.box_predictor.{stage}.cls_score")
        head["bbox_pred"] = linear(
            sd, f"roi_heads.box_predictor.{stage}.bbox_pred")
        P[f"box_head_{stage}"] = head
        S[f"box_head_{stage}"] = hst
    return {"params": P, "batch_stats": S}


def convert_dexined(sd: Dict[str, Any]) -> Dict[str, Any]:
    """DexiNed checkpoint -> {'params', 'batch_stats'} for experts.edge."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name in ("block_1", "block_2"):
        params[name], stats[name] = _double_conv(sd, name)
    for name, n in (("dblock_3", 2), ("dblock_4", 3), ("dblock_5", 3),
                    ("dblock_6", 3)):
        params[name], stats[name] = _dense_block(sd, name, n)
    for name in ("side_1", "side_2", "side_3", "side_4",
                 "pre_dense_2", "pre_dense_3", "pre_dense_4",
                 "pre_dense_5", "pre_dense_6"):
        params[name], stats[name] = _single_conv(sd, name)
    for name, s in (("up_block_1", 1), ("up_block_2", 1), ("up_block_3", 2),
                    ("up_block_4", 3), ("up_block_5", 4), ("up_block_6", 4)):
        params[name] = _up_block(sd, name, s)
    params["block_cat"], _ = _single_conv(sd, "block_cat", use_bn=False)
    return {"params": params, "batch_stats": stats}
