"""Checkpoints in the JAX package's v2 format.

A .ckpt is an .npz archive: raw arrays plus one JSON schema string that
describes the params and qstate trees. Dataclass nodes are encoded by class
NAME against a whitelist, so loading runs no pickled code. The port writes
its ``VisionTransformer`` or ``SwinTransformer`` as the JAX package's
``ViTParams`` or ``SwinParams`` tree and its qstate dataclasses under their shared names, so a file written by either
package loads in the other. File naming mirrors the reference:
  {model}_w{w}_a{a}_s{s}_{calibsize|optimsize}_{n}.ckpt  (test_quant.py:97-102)

Round-1 checkpoints of the JAX package were raw pickles of its pytrees;
``load_checkpoint`` reads them through a restricted unpickler that resolves
only numpy's array reconstruction, the ``builtins`` containers and the JAX
package's dataclass names, each mapped BY STRING onto the port's classes, so
loading one imports nothing of ``adalog_tpu``; any other global raises.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
import zipfile

import numpy as np
import torch

from adalog_tpu_torch.utils.interop import (
    Node, QSTATE_CLASSES, model_from_tree, params_to_tree, qstate_from_tree,
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


def checkpoint_name(model: str, cfg, mode: str) -> str:
    assert mode in ("calibrate", "optimize")
    size = cfg.calib_size if mode == "calibrate" else cfg.optim_size
    tag = "calibsize" if mode == "calibrate" else "optimsize"
    return f"{model}_w{cfg.w_bit}_a{cfg.a_bit}_s{cfg.s_bit}_{tag}_{size}.ckpt"


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
    """Write a port model (ViT or Swin) and qstate dict as a v2 .ckpt."""
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


def encode_bytes(obj) -> bytes:
    """One tree (tensors, numpy arrays, dataclasses, Nodes, dicts, tuples)
    as a self-contained npz blob, the JAX package's ``encode_bytes`` format:
    one record of the framed calibration resume log (utils/resume.py)."""
    arrays: list = []
    schema = {"version": FORMAT_VERSION, "obj": _encode(obj, arrays)}
    payload = {f"a{i}": a for i, a in enumerate(arrays)}
    payload["__schema__"] = np.frombuffer(
        json.dumps(schema).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


def decode_bytes(data: bytes):
    """Inverse of encode_bytes, loaded with allow_pickle=False: numpy
    arrays, with every dataclass as a ``Node``."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        schema = json.loads(bytes(z["__schema__"]).decode())
        n = sum(1 for k in z.files if k.startswith("a"))
        arrays = [z[f"a{i}"] for i in range(n)]
    return _decode(schema["obj"], arrays)


# ---------------------------------------------------------------------------
# round-1 pickle reader, restricted
# ---------------------------------------------------------------------------

# (module, name) of each dataclass the JAX package's round-1 pickles name
_JAX_CLASSES = {
    "adalog_tpu.models.layers": ("LinearP", "ConvP", "LayerNormP",
                                 "LinearSite", "ConvSite", "MatMulSite"),
    "adalog_tpu.quantizers.state": ("QuantizerState", "WeightQuantizerState"),
    "adalog_tpu.models.vit": ("ViTParams", "BlockP", "AttentionP", "MlpP"),
    "adalog_tpu.models.swin": ("SwinParams", "SwinStageP", "SwinBlockP",
                               "PatchMergingP", "WindowAttentionP"),
}


def _pickled_node(dc: str):
    """A ``Node`` class for the parameter dataclass ``dc``: pickle's NEWOBJ
    creates it empty and BUILD hands it the dataclass's field dict."""

    class PickledNode(Node):
        def __new__(cls, *args, **kwargs):
            obj = object.__new__(cls)
            obj.dc, obj.fields = dc, {}
            return obj

        def __init__(self, *args, **kwargs):
            pass

        def __setstate__(self, state):
            self.fields = dict(state)

    PickledNode.__name__ = PickledNode.__qualname__ = dc
    return PickledNode


class _RestrictedUnpickler(pickle.Unpickler):
    """Resolves only numpy reconstruction helpers, the builtins containers
    and the JAX package's whitelisted dataclasses, by exact (module, name)
    pair and without importing that package: a parameter class becomes a
    ``Node``, a qstate class the port's dataclass of the same name. Any
    other global (the arbitrary-code-execution vector in stock pickle,
    including the JAX package's own callables) raises."""

    _NUMPY_OK = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy.core.numeric", "_frombuffer"),
        ("numpy._core.numeric", "_frombuffer"),
    }
    _BUILTINS_OK = ("dict", "list", "tuple", "set", "frozenset")

    def find_class(self, module, name):
        if (module, name) in self._NUMPY_OK or \
                module.startswith("numpy.dtypes"):
            return super().find_class(module, name)
        if name in _JAX_CLASSES.get(module, ()):
            if name in QSTATE_CLASSES:
                return QSTATE_CLASSES[name]
            return _pickled_node(name)
        if module == "builtins" and name in self._BUILTINS_OK:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint pickle references forbidden global "
            f"{module}.{name}; refusing to load")


def load_checkpoint(path: str, cfg):
    """Returns (model, qstate, meta) on the CPU; ``cfg`` is the model's
    ViTConfig or SwinConfig.

    Dispatches on content: a v2 .npz (zip magic) or a round-1 pickle of the
    JAX package (read through the restricted unpickler)."""
    if not zipfile.is_zipfile(path):
        with open(path, "rb") as f:
            payload = _RestrictedUnpickler(f).load()
        return (model_from_tree(cfg, payload["params"]),
                qstate_from_tree(payload["qstate"]), payload.get("meta", {}))
    with np.load(path, allow_pickle=False) as z:
        schema = json.loads(bytes(z["__schema__"]).decode())
        n = sum(1 for k in z.files if k.startswith("a"))
        arrays = [z[f"a{i}"] for i in range(n)]
    if schema.get("version") != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint version {schema.get('version')}")
    model = model_from_tree(cfg, _decode(schema["params"], arrays))
    return (model, qstate_from_tree(_decode(schema["qstate"], arrays)),
            schema.get("meta", {}))
