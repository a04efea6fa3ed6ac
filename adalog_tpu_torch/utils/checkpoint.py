"""Checkpoints in the JAX package's v2 format.

A .ckpt is an .npz archive: raw arrays plus one JSON schema string that
describes the params and qstate trees. Dataclass nodes are encoded by class
NAME against a whitelist, so loading runs no pickled code. The port writes
its ``VisionTransformer`` as the JAX package's ``ViTParams`` tree and its
qstate dataclasses under their shared names, so a file written by either
package loads in the other. The round-1 pickle format is not read here.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import zipfile

import numpy as np
import torch

from adalog_tpu_torch.utils.interop import (
    Node, QSTATE_CLASSES, load_vit, params_to_tree, qstate_from_tree,
    vit_state_dict,
)

FORMAT_VERSION = 2

# whitelisted dataclass names: the parameter classes of the JAX package
# (read into Nodes) and the qstate classes both packages share
PARAM_CLASSES = frozenset({
    "LinearP", "ConvP", "LayerNormP", "ViTParams", "BlockP", "AttentionP",
    "MlpP", "SwinParams", "SwinStageP", "SwinBlockP", "PatchMergingP",
    "WindowAttentionP",
})
REGISTRY = PARAM_CLASSES | frozenset(QSTATE_CLASSES)


def _encode(obj, arrays: list):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return {"__arr__": len(arrays) - 1}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, dict):
        return {"__dict__": [[_encode(k, arrays), _encode(v, arrays)]
                             for k, v in obj.items()]}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode(v, arrays) for v in obj]}
    if isinstance(obj, list):
        return {"__list__": [_encode(v, arrays) for v in obj]}
    if isinstance(obj, Node) or dataclasses.is_dataclass(obj):
        if isinstance(obj, Node):
            name, fields = obj.dc, obj.fields
        else:
            name = type(obj).__name__
            fields = {f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(obj)}
        if name not in REGISTRY:
            raise TypeError(f"unregistered dataclass in checkpoint: {name}")
        return {"__dc__": name,
                "fields": {k: _encode(v, arrays) for k, v in fields.items()}}
    raise TypeError(f"cannot checkpoint object of type {type(obj)!r}")


def _decode(node, arrays):
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if not isinstance(node, dict):
        raise ValueError(f"malformed checkpoint node: {node!r}")
    if "__arr__" in node:
        return arrays[node["__arr__"]]
    if "__dict__" in node:
        return {_decode(k, arrays): _decode(v, arrays)
                for k, v in node["__dict__"]}
    if "__tuple__" in node:
        return tuple(_decode(v, arrays) for v in node["__tuple__"])
    if "__list__" in node:
        return [_decode(v, arrays) for v in node["__list__"]]
    if "__dc__" in node:
        if node["__dc__"] not in REGISTRY:
            raise ValueError(f"checkpoint names unknown dataclass "
                             f"{node['__dc__']!r}; refusing to load")
        return Node(node["__dc__"], {k: _decode(v, arrays)
                                     for k, v in node["fields"].items()})
    raise ValueError(f"malformed checkpoint node: {list(node)!r}")


def save_checkpoint(path: str, params, qstate, meta: dict | None = None):
    """Write a port ``VisionTransformer`` and qstate dict as a v2 .ckpt."""
    arrays: list = []
    schema = {
        "version": FORMAT_VERSION,
        "params": _encode(params_to_tree(params), arrays),
        "qstate": _encode(qstate, arrays),
        "meta": meta or {},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"a{i}": a for i, a in enumerate(arrays)}
    payload["__schema__"] = np.frombuffer(
        json.dumps(schema).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_checkpoint(path: str, cfg):
    """Returns (VisionTransformer, qstate, meta) on the CPU; ``cfg`` is the
    model's ViTConfig."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path}: not a v2 (npz) checkpoint; round-1 pickle "
                         f"checkpoints are read only by adalog_tpu")
    with np.load(path, allow_pickle=False) as z:
        schema = json.loads(bytes(z["__schema__"]).decode())
        n = sum(1 for k in z.files if k.startswith("a"))
        arrays = [z[f"a{i}"] for i in range(n)]
    if schema.get("version") != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint version {schema.get('version')}")
    model = load_vit(cfg, vit_state_dict(_decode(schema["params"], arrays)))
    return (model, qstate_from_tree(_decode(schema["qstate"], arrays)),
            schema.get("meta", {}))
