"""Weight carrying between the JAX package's pytrees and the port.

``adalog_tpu`` holds ViT parameters as a tree of dataclasses (``ViTParams``,
``BlockP``, ``AttentionP``, ``MlpP``, ``LinearP``, ``ConvP``,
``LayerNormP``) and quantizer state as a dict of site dataclasses
(``LinearSite``, ``ConvSite``, ``MatMulSite``, ``QuantizerState``,
``WeightQuantizerState``). The functions here go by class NAME and field
names only, so they take either those dataclasses (with numpy leaves) or the
``Node`` records a v2 checkpoint decodes into, and need no ``jax`` import.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from adalog_tpu_torch.models.layers import LinearSite, ConvSite, MatMulSite
from adalog_tpu_torch.models.load import load_vit
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
    if node_name(params) != "ViTParams":
        raise NotImplementedError(
            f"{node_name(params)} parameters are not ported to PyTorch yet")
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


def _host(t):
    return None if t is None else t.detach().to("cpu", torch.float32).numpy()


def _linear_node(m):
    return Node("LinearP", {"w": _host(m.weight), "b": _host(m.bias)})


def _ln_node(m):
    return Node("LayerNormP", {"g": _host(m.weight), "b": _host(m.bias),
                               "eps": float(m.eps)})


def params_to_tree(model) -> Node:
    """A port ``VisionTransformer`` -> the ``ViTParams`` tree of the JAX
    package, as Nodes with numpy leaves (what a v2 checkpoint stores)."""
    conv = model.patch_embed.proj
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
        "patch_proj": Node("ConvP", {
            "w": _host(conv.weight), "b": _host(conv.bias),
            "stride": tuple(conv.stride), "padding": tuple(conv.padding)}),
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


def from_jax(cfg, params, qstate=None):
    """The JAX package's (params, qstate) with numpy leaves -> the port's
    (VisionTransformer, qstate dict or None)."""
    model = load_vit(cfg, vit_state_dict(params))
    return model, (None if qstate is None else qstate_from_tree(qstate))
