"""Weight carrying between the JAX package's pytrees and the port.

``adalog_tpu`` holds parameters as a tree of dataclasses (``ViTParams``,
``BlockP``, ``AttentionP``, ``MlpP``; ``SwinParams``, ``SwinStageP``,
``SwinBlockP``, ``PatchMergingP``, ``WindowAttentionP``; ``LinearP``,
``ConvP``, ``LayerNormP``) and quantizer state as a dict of site dataclasses
(``LinearSite``, ``ConvSite``, ``MatMulSite``, ``QuantizerState``,
``WeightQuantizerState``). The functions here go by class NAME and field
names only, so they take either those dataclasses (with numpy leaves) or the
``Node`` records a v2 checkpoint decodes into, and need no ``jax`` import.

The JAX package keeps a Swin attention's relative-position bias gathered,
(1, heads, N, N); the port's module holds timm's table. ``ungather`` /
``gather`` carry one into the other exactly. ``affine_node`` /
``affine_from_node`` carry one Linear or Conv2d, the parameter payload of a
reconstruction resume record, both ways.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from adalog_tpu_torch.models.layers import LinearSite, ConvSite, MatMulSite
from adalog_tpu_torch.models.load import load_swin, load_vit
from adalog_tpu_torch.models.swin import (
    SwinTransformer, gather_rel_pos_bias, ungather_rel_pos_bias,
)
from adalog_tpu_torch.quantizers.state import (
    QuantizerState, WeightQuantizerState,
)

# qstate classes: the same names and fields in both packages
QSTATE_CLASSES = {c.__name__: c for c in (
    LinearSite, ConvSite, MatMulSite, QuantizerState, WeightQuantizerState)}


class Node:
    """A named dataclass node of a checkpoint schema: ``dc`` is the class
    name, fields are attributes."""

    def __init__(self, dc: str, fields: dict):
        self.dc = dc
        self.fields = dict(fields)

    def __getattr__(self, key):
        fields = self.__dict__.get("fields", {})
        if key in fields:
            return fields[key]
        raise AttributeError(key)


def node_name(obj) -> str:
    return obj.dc if isinstance(obj, Node) else type(obj).__name__


def node_fields(obj) -> dict:
    if isinstance(obj, Node):
        return obj.fields
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    raise TypeError(f"not a dataclass node: {type(obj)!r}")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _np(a):
    return np.asarray(a, dtype=np.float32)


def _put_affine(sd, prefix, node, w="w", b="b"):
    f = node_fields(node)
    sd[f"{prefix}.weight"] = _np(f[w])
    if f[b] is not None:
        sd[f"{prefix}.bias"] = _np(f[b])


def vit_state_dict(params) -> dict:
    """A ``ViTParams`` tree -> {timm key: float32 array}."""
    f = node_fields(params)
    sd = {}
    _put_affine(sd, "patch_embed.proj", f["patch_proj"])
    sd["cls_token"] = _np(f["cls_token"])
    sd["pos_embed"] = _np(f["pos_embed"])
    for i, bp in enumerate(f["blocks"]):
        b = node_fields(bp)
        attn, mlp = node_fields(b["attn"]), node_fields(b["mlp"])
        p = f"blocks.{i}"
        _put_affine(sd, f"{p}.norm1", b["norm1"], "g")
        _put_affine(sd, f"{p}.attn.qkv", attn["qkv"])
        _put_affine(sd, f"{p}.attn.proj", attn["proj"])
        for nm in ("q_norm", "k_norm"):
            if attn.get(nm) is not None:
                _put_affine(sd, f"{p}.attn.{nm}", attn[nm], "g")
        _put_affine(sd, f"{p}.norm2", b["norm2"], "g")
        _put_affine(sd, f"{p}.mlp.fc1", mlp["fc1"])
        _put_affine(sd, f"{p}.mlp.fc2", mlp["fc2"])
    _put_affine(sd, "norm", f["norm"], "g")
    _put_affine(sd, "head", f["head"])
    return sd


def swin_state_dict(params) -> dict:
    """A ``SwinParams`` tree -> {timm key: float32 array}; each gathered
    rel-pos bias goes back to its table."""
    f = node_fields(params)
    sd = {}
    _put_affine(sd, "patch_embed.proj", f["patch_proj"])
    _put_affine(sd, "patch_embed.norm", f["patch_norm"], "g")
    for i, sp in enumerate(f["stages"]):
        st = node_fields(sp)
        if st["downsample"] is not None:
            pm = node_fields(st["downsample"])
            _put_affine(sd, f"layers.{i}.downsample.norm", pm["norm"], "g")
            _put_affine(sd, f"layers.{i}.downsample.reduction",
                        pm["reduction"])
        for j, bp in enumerate(st["blocks"]):
            b = node_fields(bp)
            attn = node_fields(b["attn"])
            p = f"layers.{i}.blocks.{j}"
            _put_affine(sd, f"{p}.norm1", b["norm1"], "g")
            _put_affine(sd, f"{p}.attn.qkv", attn["qkv"])
            _put_affine(sd, f"{p}.attn.proj", attn["proj"])
            bias = _np(attn["rel_pos_bias"])
            ws = int(round(bias.shape[-1] ** 0.5))
            sd[f"{p}.attn.relative_position_bias_table"] = \
                ungather_rel_pos_bias(bias, ws)
            _put_affine(sd, f"{p}.norm2", b["norm2"], "g")
            _put_affine(sd, f"{p}.mlp.fc1", b["fc1"])
            _put_affine(sd, f"{p}.mlp.fc2", b["fc2"])
    _put_affine(sd, "norm", f["norm"], "g")
    _put_affine(sd, "head.fc", f["head"])
    return sd


def _host(t):
    return None if t is None else t.detach().to("cpu", torch.float32).numpy()


def _linear_node(m):
    return Node("LinearP", {"w": _host(m.weight), "b": _host(m.bias)})


def _ln_node(m):
    return Node("LayerNormP", {"g": _host(m.weight), "b": _host(m.bias),
                               "eps": float(m.eps)})


def _conv_node(conv):
    return Node("ConvP", {
        "w": _host(conv.weight), "b": _host(conv.bias),
        "stride": tuple(conv.stride), "padding": tuple(conv.padding)})


def affine_node(module) -> Node:
    """A ``nn.Linear`` or ``nn.Conv2d`` -> the JAX package's ``LinearP`` or
    ``ConvP`` node with numpy leaves: the parameter payload of a
    reconstruction resume record (``recon.brecq``)."""
    if isinstance(module, torch.nn.Conv2d):
        return _conv_node(module)
    return _linear_node(module)


def affine_from_node(module, node):
    """A copy of the ``nn.Linear`` or ``nn.Conv2d`` ``module`` holding the
    weight and bias of a ``LinearP`` / ``ConvP`` node (a decoded resume
    record, or the JAX package's dataclass), on the module's device; a bias
    of None leaves the copy without one. ``module`` is left as it was."""
    f = node_fields(node)
    old = module.weight
    new = copy.deepcopy(module)

    def param(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32)).to(old.device)
        return torch.nn.Parameter(t, requires_grad=old.requires_grad)

    new.weight = param(f["w"])
    if tuple(new.weight.shape) != tuple(old.shape):
        raise ValueError(f"weight of shape {tuple(new.weight.shape)} for a "
                         f"module of shape {tuple(old.shape)}")
    new.bias = None if f["b"] is None else param(f["b"])
    return new


def _swin_to_tree(model) -> Node:
    def block(bp):
        table = _host(bp.attn.relative_position_bias_table)
        return Node("SwinBlockP", {
            "norm1": _ln_node(bp.norm1),
            "attn": Node("WindowAttentionP", {
                "qkv": _linear_node(bp.attn.qkv),
                "proj": _linear_node(bp.attn.proj),
                "rel_pos_bias": np.ascontiguousarray(
                    gather_rel_pos_bias(table, bp.attn.ws))}),
            "norm2": _ln_node(bp.norm2),
            "fc1": _linear_node(bp.mlp.fc1),
            "fc2": _linear_node(bp.mlp.fc2)})

    stages = tuple(
        Node("SwinStageP", {
            "downsample": None if sp.downsample is None
            else Node("PatchMergingP", {
                "norm": _ln_node(sp.downsample.norm),
                "reduction": _linear_node(sp.downsample.reduction)}),
            "blocks": tuple(block(bp) for bp in sp.blocks),
        }) for sp in model.layers)
    return Node("SwinParams", {
        "patch_proj": _conv_node(model.patch_embed.proj),
        "patch_norm": _ln_node(model.patch_embed.norm),
        "stages": stages,
        "norm": _ln_node(model.norm),
        "head": _linear_node(model.head.fc),
    })


def params_to_tree(model) -> Node:
    """A port ``VisionTransformer`` or ``SwinTransformer`` -> the
    ``ViTParams`` or ``SwinParams`` tree of the JAX package, as Nodes with
    numpy leaves (what a v2 checkpoint stores)."""
    if isinstance(model, SwinTransformer):
        return _swin_to_tree(model)
    blocks = tuple(
        Node("BlockP", {
            "norm1": _ln_node(bp.norm1),
            "attn": Node("AttentionP", {
                "qkv": _linear_node(bp.attn.qkv),
                "proj": _linear_node(bp.attn.proj),
                "q_norm": None if bp.attn.q_norm is None
                else _ln_node(bp.attn.q_norm),
                "k_norm": None if bp.attn.k_norm is None
                else _ln_node(bp.attn.k_norm)}),
            "norm2": _ln_node(bp.norm2),
            "mlp": Node("MlpP", {"fc1": _linear_node(bp.mlp.fc1),
                                 "fc2": _linear_node(bp.mlp.fc2)}),
        }) for bp in model.blocks)
    return Node("ViTParams", {
        "patch_proj": _conv_node(model.patch_embed.proj),
        "cls_token": _host(model.cls_token),
        "pos_embed": _host(model.pos_embed),
        "blocks": blocks,
        "norm": _ln_node(model.norm),
        "head": _linear_node(model.head),
    })


# ---------------------------------------------------------------------------
# qstate
# ---------------------------------------------------------------------------

def _qleaf(v):
    if v is None or isinstance(v, (bool, int, float, str, torch.Tensor)):
        return v
    if isinstance(v, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(v))
    name = node_name(v)
    cls = QSTATE_CLASSES.get(name)
    if cls is None:
        raise TypeError(f"unexpected node {name!r} in a qstate")
    return cls(**{k: _qleaf(x) for k, x in node_fields(v).items()})


def qstate_from_tree(qstate) -> dict:
    """{site: JAX-package site dataclass or Node} -> the port's dataclasses
    of CPU tensors."""
    return {name: _qleaf(site) for name, site in qstate.items()}


def model_from_tree(cfg, params):
    """A ``ViTParams`` or ``SwinParams`` tree -> the port's module for the
    model config ``cfg``."""
    name = node_name(params)
    if name == "ViTParams":
        return load_vit(cfg, vit_state_dict(params))
    if name == "SwinParams":
        return load_swin(cfg, swin_state_dict(params))
    raise TypeError(f"not a parameter tree of the JAX package: {name!r}")


def from_jax(cfg, params, qstate=None):
    """The JAX package's (params, qstate) with numpy leaves -> the port's
    (VisionTransformer or SwinTransformer, qstate dict or None)."""
    return (model_from_tree(cfg, params),
            None if qstate is None else qstate_from_tree(qstate))
