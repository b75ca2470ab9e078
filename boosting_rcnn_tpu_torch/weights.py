"""Weight bridge from the JAX package's parameters to the port's.

``from_jax_params`` takes the flax variables of the JAX flagship
(``{"params": ..., "batch_stats": ...}`` or the ``params`` tree alone) as
nested dicts of numpy arrays, named as flax names them, and returns a
``state_dict`` for ``TwoStageNet``.  The port's modules carry the JAX
module names, so the mapping is by rule:

  * ``Conv_0`` / ``WSConv_0`` and ``GroupNorm_0`` / ``FrozenBatchNorm_0`` /
    ``LayerNorm_0`` inside a ConvModule -> ``conv`` and ``norm``; the
    ``BatchNorm_0`` inside a ``LiveBatchNorm`` is dropped (its ``scale``,
    ``bias``, ``mean`` and ``var`` are the port's module's own);
    a cascade's stage heads ``bbox_heads_N`` -> ``bbox_heads.N``, HTC's
    and Cascade Mask R-CNN's ``mask_heads_N`` -> ``mask_heads.N`` (the
    semantic head keeps its name, ``semantic_head``);
  * conv ``kernel`` (HWIO) -> ``weight`` (OIHW); dense ``kernel`` (in, out)
    -> ``weight`` (out, in); the mask head's transposed conv ``upsample``
    (flax ``nn.ConvTranspose``, HWIO) -> ``weight`` (in, out, H, W) with
    both spatial axes flipped: flax's transposed convolution (no
    ``transpose_kernel``) is the fractionally strided convolution with the
    kernel as it is, PyTorch's ``conv_transpose2d`` the gradient of a
    convolution, which applies the kernel mirrored.  The first FC after the pool keeps its rows:
    both packages flatten the pooled (7, 7, C) features in HWC order;
  * norm ``scale`` -> ``weight``; a scalar ``scale`` (the per-level RPN
    ``Scale``) stays ``scale``; ``mean`` / ``var`` -> ``running_mean`` /
    ``running_var``; Dynamic R-CNN's state in the box head's
    ``batch_stats`` (``dyn_iou_thr``, ``dyn_beta``, ``dyn_iou_hist``,
    ``dyn_beta_hist``, and ``dyn_count``, which stays an integer) keeps
    its names, as the head's buffers.

The same rules carry the rest of the Boosting R-CNN family: ResNeXt's
grouped 3x3 kernels (HWIO with I = Cin / groups, to OIHW), Res2Net's
``stem_conv{i}`` / ``stem_bn{i}`` and per-split ``conv2_{i}`` / ``bn2_{i}``,
a deformable 3x3's ``conv_offset`` (a conv with a bias) and its ``kernel``
(to the ``DeformConv``'s OIHW ``weight``), and the FPN's extra convs
``fpn_conv_{i}``; and the norms and plugins: a
``WSConv``'s ``kernel``, GroupNorm's and LayerNorm's ``scale`` / ``bias``,
the ContextBlock's convs and LayerNorms, the GeneralizedAttention's convs,
its position Denses (``appr_geom_fc_x`` / ``_y``, kernels transposed) and
its ``appr_bias`` / ``geom_bias`` / ``gamma``, which keep their names.

Every rule is linear (a transpose or a rename), so the same mapping
carries a flax *gradient* tree (the ``params`` tree of ``jax.grad``) onto
the ``state_dict`` names of the port's parameters, where their ``.grad``
can be held against it.

Nothing here imports JAX: callers turn the flax tree into numpy first.

``from_torchvision_resnet`` and ``from_mmdet_state_dict`` read PyTorch
state dicts straight into the port's names (the port's own copies of the
mappings of ``tools/convert_torch_weights.py``): ResNet and ResNeXt of
any depth, a DCN's ``conv2.conv_offset`` and ``conv2.weight`` included,
the FPN's extra convs by their index (``on_input``'s first over C5's
channels); an mmdet Res2Net raises.  Convolutions keep their
OIHW weights and linear layers their ``(out, in)`` ones; the one reorder
is the first FC after the RoI pool, whose input mmdet flattens from
``(C, 7, 7)`` and the port from ``(7, 7, C)``; the mask head's transposed
conv is PyTorch's on both sides and stays as it is.  ``load_pretrained``
applies a backbone ``init_cfg=dict(type="Pretrained", checkpoint=...)``
from a local file; nothing is fetched.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

__all__ = ["from_jax_params", "from_torchvision_resnet", "from_mmdet_state_dict",
           "read_state_dict", "load_pretrained"]

_MODULE_NAMES = {"Conv_0": "conv", "WSConv_0": "conv", "GroupNorm_0": "norm",
                 "FrozenBatchNorm_0": "norm", "LayerNorm_0": "norm"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _module_name(m: str) -> str:
    """A flax module name as the port names it: ``Conv_0`` -> ``conv``, a
    cascade's stage head ``bbox_heads_N`` or ``mask_heads_N`` (flax's name
    for a tuple's submodule) -> ``bbox_heads.N`` / ``mask_heads.N`` (an
    ``nn.ModuleList``)."""
    stage = re.fullmatch(r"(bbox_heads|mask_heads)_(\d+)", m)
    return f"{stage[1]}.{stage[2]}" if stage else _MODULE_NAMES.get(m, m)


def _convert(path: Tuple[str, ...], value: np.ndarray):
    *mods, leaf = path
    mods = [_module_name(m) for m in mods if m != "BatchNorm_0"]
    if leaf == "kernel":
        if value.ndim == 4 and mods[-1:] == ["upsample"]:
            value = value[::-1, ::-1].transpose(2, 3, 0, 1)
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        else:
            raise ValueError(f"kernel {'/'.join(path)} has shape {value.shape}")
        leaf = "weight"
    elif leaf == "scale" and value.ndim > 0:
        leaf = "weight"
    else:
        leaf = _STAT_NAMES.get(leaf, leaf)
    return ".".join(mods + [leaf]), torch.from_numpy(np.ascontiguousarray(value))


def from_jax_params(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``state_dict`` of ``TwoStageNet`` from JAX flax variables as numpy
    (or, by the same rules, the port's gradients from a flax gradient
    tree)."""
    collections = (variables if "params" in variables else {"params": variables})
    state = {}
    for coll in ("params", "batch_stats"):
        for path, value in _leaves(collections.get(coll, {})):
            integer = np.issubdtype(value.dtype, np.integer)
            key, tensor = _convert(path, value.astype(value.dtype if integer else np.float32))
            state[key] = tensor
    return state


_SKIP = re.compile(r"(^fc\.|num_batches_tracked$)")


def _port_tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v.detach().cpu() if torch.is_tensor(v) else v),
                           dtype=torch.float32).contiguous()


def from_torchvision_resnet(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``backbone.*`` entries of the port's ``state_dict`` from a
    torchvision (or mmdet backbone) ResNet state dict: ``layer{s}.{b}`` ->
    ``layer{s}_{b}``, ``downsample.0`` / ``.1`` -> ``downsample_conv`` /
    ``downsample_bn``; the classifier ``fc`` and BN counters are skipped,
    any other key raises."""
    res2net = [k for k in state_dict if re.match(r"(stem\.|layer\d+\.\d+\.(convs|bns)\.)", k)]
    if res2net:
        raise NotImplementedError(
            f"{res2net[0]!r} is a key of mmdet's Res2Net, whose shortcut pools first "
            "(avg_down) and whose stage-mode blocks pool at stride 1 too; the port's Res2Net is "
            "the JAX package's, which does neither, so mmdet's Res2Net weights do not load")
    out = {}
    for key, value in state_dict.items():
        if _SKIP.search(key):
            continue
        m = re.fullmatch(r"layer(\d+)\.(\d+)\.(.+)", key)
        if m:
            rest = m.group(3).replace("downsample.0.", "downsample_conv.").replace(
                "downsample.1.", "downsample_bn.")
            name = f"layer{m.group(1)}_{m.group(2)}.{rest}"
        elif re.fullmatch(r"(conv1\.weight|bn1\.(weight|bias|running_mean|running_var))", key):
            name = key
        else:
            raise ValueError(f"ResNet state dict key {key!r} has no counterpart in the port")
        out["backbone." + name] = _port_tensor(value)
    return out


_NECK = {"lateral_convs": "lateral_{}", "fpn_convs": "fpn_conv_{}",
         "downsample_convs": "downsample_{}", "pafpn_convs": "pafpn_conv_{}"}


def _fc_after_pool(w: torch.Tensor, roi_feat_size: int) -> torch.Tensor:
    """``(out, C*S*S)`` with the input flattened ``(C, S, S)`` -> flattened
    ``(S, S, C)``, as the port flattens its NHWC pool."""
    s = roi_feat_size
    out_dim, in_dim = w.shape
    c = in_dim // (s * s)
    if c * s * s != in_dim:
        raise ValueError(f"first FC has {in_dim} inputs, not C x {s} x {s}")
    return w.reshape(out_dim, c, s, s).permute(0, 2, 3, 1).reshape(out_dim, in_dim).contiguous()


def _mask_head(stage) -> str:
    return "mask_head" if stage is None else f"mask_heads.{stage}"


def from_mmdet_state_dict(state_dict: Dict[str, Any],
                          roi_feat_size: int = 7) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (``TwoStageNet``) from an mmdet two-stage
    state dict (the flagship Boosting R-CNN, Faster / Mask R-CNN R50-FPN,
    Cascade R-CNN, Cascade Mask R-CNN or HTC):

      backbone.*                              -> backbone.* (``from_torchvision_resnet``)
      neck.{lateral,fpn,downsample,pafpn}_convs.N.conv -> neck.{lateral_N,fpn_conv_N,...}.conv
      rpn_head.rpn_convs.N.{conv,gn}          -> rpn.rpn_conv_N.{conv,norm}
      rpn_head.rpn_conv (plain RPN)           -> rpn.rpn_conv
      rpn_head.rpn_conv.N.conv (stacked RPN)  -> rpn.rpn_conv (N = 0), rpn.rpn_conv_N
      rpn_head.{rpn_cls,rpn_reg,rpn_iou}      -> rpn.{rpn_cls,rpn_reg,rpn_iou}
      rpn_head.scales.N.scale                 -> rpn.scale_N.scale (a scalar)
      roi_head.bbox_head.shared_fcs.N         -> bbox_head.shared_fc_N (N = 0 reordered)
      roi_head.bbox_head.{fc_cls,fc_reg}      -> bbox_head.{fc_cls,fc_reg}
      roi_head.bbox_head.S.shared_fcs.N       -> bbox_heads.S.shared_fc_N (a cascade's stage S)
      roi_head.bbox_head.S.{fc_cls,fc_reg}    -> bbox_heads.S.{fc_cls,fc_reg}
      roi_head.mask_head.convs.N.conv         -> mask_head.conv_N
      roi_head.mask_head.{upsample,conv_logits} -> mask_head.{upsample,conv_logits}
      roi_head.mask_head.S.convs.N.conv       -> mask_heads.S.conv_N (Cascade Mask R-CNN's
                                                 and HTC's stage S)
      roi_head.mask_head.S.conv_res.conv      -> mask_heads.S.conv_res
      roi_head.mask_head.S.{upsample,conv_logits} -> mask_heads.S.{upsample,conv_logits}
      roi_head.semantic_head.lateral_convs.N.conv -> semantic_head.lateral_N
      roi_head.semantic_head.convs.N.conv     -> semantic_head.conv_N
      roi_head.semantic_head.conv_embedding.conv -> semantic_head.conv_embedding
      roi_head.semantic_head.conv_logits      -> semantic_head.conv_seg

    A key of any other module raises ``ValueError`` naming it (the port has
    no such module).  The JAX package's converter maps one ``mask_head``
    only and drops the per-stage and semantic keys."""
    backbone = {k[len("backbone."):]: v for k, v in state_dict.items()
                if k.startswith("backbone.")}
    out = from_torchvision_resnet(backbone)
    rules = [
        (r"neck\.(\w+_convs)\.(\d+)\.conv\.(weight|bias)",
         lambda m: f"neck.{_NECK[m[1]].format(m[2])}.conv.{m[3]}" if m[1] in _NECK else None),
        (r"rpn_head\.rpn_convs\.(\d+)\.(conv|gn)\.(weight|bias)",
         lambda m: f"rpn.rpn_conv_{m[1]}.{'conv' if m[2] == 'conv' else 'norm'}.{m[3]}"),
        (r"rpn_head\.(rpn_conv|rpn_cls|rpn_reg|rpn_iou)\.(weight|bias)",
         lambda m: f"rpn.{m[1]}.{m[2]}"),
        (r"rpn_head\.rpn_conv\.(\d+)\.conv\.(weight|bias)",
         lambda m: f"rpn.rpn_conv{'_' + m[1] if int(m[1]) else ''}.{m[2]}"),
        (r"rpn_head\.scales\.(\d+)\.scale", lambda m: f"rpn.scale_{m[1]}.scale"),
        (r"roi_head\.bbox_head\.shared_fcs\.(\d+)\.(weight|bias)",
         lambda m: f"bbox_head.shared_fc_{m[1]}.{m[2]}"),
        (r"roi_head\.bbox_head\.(fc_cls|fc_reg)\.(weight|bias)",
         lambda m: f"bbox_head.{m[1]}.{m[2]}"),
        (r"roi_head\.bbox_head\.(\d+)\.shared_fcs\.(\d+)\.(weight|bias)",
         lambda m: f"bbox_heads.{m[1]}.shared_fc_{m[2]}.{m[3]}"),
        (r"roi_head\.bbox_head\.(\d+)\.(fc_cls|fc_reg)\.(weight|bias)",
         lambda m: f"bbox_heads.{m[1]}.{m[2]}.{m[3]}"),
        # one mask head, or a cascade's stage S (group 1)
        (r"roi_head\.mask_head\.(?:(\d+)\.)?convs\.(\d+)\.conv\.(weight|bias)",
         lambda m: f"{_mask_head(m[1])}.conv_{m[2]}.{m[3]}"),
        (r"roi_head\.mask_head\.(?:(\d+)\.)?(upsample|conv_logits)\.(weight|bias)",
         lambda m: f"{_mask_head(m[1])}.{m[2]}.{m[3]}"),
        (r"roi_head\.mask_head\.(\d+)\.conv_res\.conv\.(weight|bias)",
         lambda m: f"mask_heads.{m[1]}.conv_res.{m[2]}"),
        (r"roi_head\.semantic_head\.lateral_convs\.(\d+)\.conv\.(weight|bias)",
         lambda m: f"semantic_head.lateral_{m[1]}.{m[2]}"),
        (r"roi_head\.semantic_head\.convs\.(\d+)\.conv\.(weight|bias)",
         lambda m: f"semantic_head.conv_{m[1]}.{m[2]}"),
        (r"roi_head\.semantic_head\.conv_embedding\.conv\.(weight|bias)",
         lambda m: f"semantic_head.conv_embedding.{m[1]}"),
        (r"roi_head\.semantic_head\.conv_logits\.(weight|bias)",
         lambda m: f"semantic_head.conv_seg.{m[1]}"),
    ]
    for key, value in state_dict.items():
        if key.startswith("backbone.") or _SKIP.search(key):
            continue
        name = None
        for pattern, rename in rules:
            m = re.fullmatch(pattern, key)
            if m:
                name = rename(m)
                break
        if name is None:
            raise ValueError(f"mmdet state dict key {key!r} has no counterpart in the port")
        tensor = _port_tensor(value)
        if name.endswith(".scale"):
            tensor = tensor.reshape(())
        elif re.fullmatch(r"bbox_head(s\.\d+)?\.shared_fc_0\.weight", name):
            tensor = _fc_after_pool(tensor, roi_feat_size)
        out[name] = tensor
    return out


def read_state_dict(path: str) -> Dict[str, Any]:
    """The ``state_dict`` of a PyTorch checkpoint file (mmdet and mmcv nest
    it under ``"state_dict"``), read on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


def load_pretrained(net: torch.nn.Module, init_cfg: Dict[str, Any]) -> str:
    """Load a backbone ``init_cfg=dict(type="Pretrained", checkpoint=path)``
    into ``net`` from a local torchvision or mmdet ResNet file (a backbone's
    plugins keep their weights); returns the path.  Model-zoo and web
    addresses raise: nothing is fetched."""
    path = init_cfg.get("checkpoint") or ""
    if "://" in path:
        raise ValueError(
            f"backbone init_cfg checkpoint {path!r} is an address; the port fetches nothing: "
            f"give a local .pth file, or set model.backbone.init_cfg=None for random weights")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"backbone init_cfg checkpoint {path!r}")
    sd = read_state_dict(path)
    if any(k.startswith("backbone.") for k in sd):
        sd = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
    weights = from_torchvision_resnet(sd)
    own = {k for k in net.state_dict() if k.startswith("backbone.")}
    # a plugin (GCNet's ContextBlock, GeneralizedAttention) is not in an
    # ImageNet ResNet: it keeps its seeded weights, as mmdet initialises it
    missing = sorted(k for k in own - set(weights) if "_plugin" not in k)
    if missing:
        raise ValueError(f"{path} lacks backbone weights: {missing[:4]}")
    net.load_state_dict(weights, strict=False)
    return path
