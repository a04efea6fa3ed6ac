"""Interop with checkpoints of the upstream PyTorch implementation, the
counterpart of ``adalog_tpu.utils.ref_checkpoint``.

The reference saves ``torch.save(model.state_dict())`` of the wrapped model
(test_quant.py:95-106): per quant site it carries the (possibly reparamed)
weights plus every quantizer's searched parameters —
  {site}.weight / {site}.bias
  {site}.w_quantizer.scale / .zero_point                  (per row-group)
  {site}.a_quantizer.scale / .zero_point [.shift .q .table1 .table2
                                          .bias_reparamed]
  {site}.A_quantizer.* / {site}.B_quantizer.*             (matmul sites)
A user switching from the reference loads such a checkpoint here and gets the
same quantized model (the reference's --load-calibrate-checkpoint /
--load-optimize-checkpoint semantics, test_quant.py:109-127); a file written
by either package's exporter loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from adalog_tpu_torch.calib.layout import quant_layout, tree_get, tree_set
from adalog_tpu_torch.models.layers import ConvSite, LinearSite, MatMulSite
from adalog_tpu_torch.models.load import load_state_dict, read_state_dict
from adalog_tpu_torch.quantizers.logarithm import make_adalog_tables
from adalog_tpu_torch.quantizers.state import (
    QuantizerState, WeightQuantizerState,
)
from adalog_tpu_torch.utils.interop import Node, affine_from_node

_LOG_KINDS = {"adalog", "log2", "logsqrt2"}


def _arr(sd, key, default=None):
    if key in sd:
        return torch.from_numpy(np.array(sd[key], dtype=np.float32))
    return default


def _act_state(sd, prefix: str, kind: str, bits: int) -> QuantizerState:
    scale = _arr(sd, f"{prefix}.scale", torch.ones((1,), dtype=torch.float32))
    shift = _arr(sd, f"{prefix}.shift")
    reparamed = None
    if f"{prefix}.bias_reparamed" in sd:
        reparamed = torch.tensor(bool(np.asarray(sd[f"{prefix}.bias_reparamed"])))
    if kind == "twin":
        return QuantizerState(scale=scale.reshape(2, 1), kind="twin", bits=bits)
    if kind in _LOG_KINDS:
        q = _arr(sd, f"{prefix}.q")
        return QuantizerState(
            scale=scale.reshape(-1) if scale.ndim <= 1 else scale,
            shift=shift, log_q=q.reshape(()) if q is not None else None,
            bias_reparamed=reparamed if shift is not None else None,
            kind=kind, bits=bits, shifted=shift is not None)
    return QuantizerState(
        scale=scale, zero_point=_arr(sd, f"{prefix}.zero_point"),
        shift=shift, bias_reparamed=reparamed if shift is not None else None,
        kind="uniform", bits=bits, shifted=shift is not None)


def _np(t):
    return t.detach().to("cpu", torch.float32).numpy()


def _put_log(sd, prefix, qs):
    """An AdaLog base with the reference's lookup tables."""
    q = int(qs.log_q)
    sd[f"{prefix}.q"] = np.asarray([q])
    t1, t2 = make_adalog_tables(q, qs.bits)
    sd[f"{prefix}.table1"] = t1.numpy()
    sd[f"{prefix}.table2"] = t2.numpy()


def export_reference_state_dict(spec, cfg, params, qstate) -> dict:
    """Inverse interop: a reference-format flat state dict (numpy) from the
    port's (model, qstate), for ViT/DeiT and Swin. The model's own
    ``state_dict`` keys are timm's (Swin keeps its rel-pos tables)."""
    sd = {k: _np(v) for k, v in params.state_dict().items()}
    for name, site in qstate.items():
        if isinstance(site, MatMulSite):
            for tag, qs in (("A_quantizer", site.Aq), ("B_quantizer", site.Bq)):
                sd[f"{name}.{tag}.scale"] = _np(qs.scale)
                if qs.zero_point is not None:
                    sd[f"{name}.{tag}.zero_point"] = _np(qs.zero_point)
                if qs.log_q is not None:
                    _put_log(sd, f"{name}.{tag}", qs)
            continue
        sd[f"{name}.w_quantizer.scale"] = _np(site.wq.scale)
        if site.wq.zero_point is not None:
            sd[f"{name}.w_quantizer.zero_point"] = _np(site.wq.zero_point)
        aq = site.aq
        sd[f"{name}.a_quantizer.scale"] = _np(aq.scale)
        if aq.zero_point is not None:
            sd[f"{name}.a_quantizer.zero_point"] = _np(aq.zero_point)
        if aq.shift is not None:
            sd[f"{name}.a_quantizer.shift"] = _np(aq.shift)
            sd[f"{name}.a_quantizer.bias_reparamed"] = np.asarray(
                bool(aq.bias_reparamed))
        if aq.log_q is not None:
            _put_log(sd, f"{name}.a_quantizer", aq)
    return sd


def load_reference_checkpoint(spec, cfg, path: str, params=None):
    """Returns (model, qstate) on the CPU from a reference-format state dict
    (.pth/.pt/.bin through torch, or .npz).

    ``params``: the model to overlay when the dict carries no backbone
    (default: a fresh build). A dict with the backbone builds the model from
    it; otherwise each site's weights (possibly reparamed) in the dict
    replace the base's. Quantizer tensors become the qstate."""
    return _load_reference_sd(spec, cfg, read_state_dict(path), params)


def _load_reference_sd(spec, cfg, sd: dict, params=None):
    have_backbone = "patch_embed.proj.weight" in sd
    if have_backbone:
        params = load_state_dict(spec, sd)
    elif params is None:
        from adalog_tpu_torch.models.zoo import build_model
        _, params = build_model(spec.name)

    layout = quant_layout(spec, cfg, reparam=False)
    qstate = {}
    for name, ss in layout.items():
        if ss.kind in ("matmul", "matmul_post"):
            a_kind = cfg.post_softmax_quantizer if ss.kind == "matmul_post" \
                else "uniform"
            Aq = _act_state(sd, f"{name}.A_quantizer", a_kind, ss.s_bits)
            Bq = _act_state(sd, f"{name}.B_quantizer", "uniform", ss.a_bits)
            H = ss.heads if cfg.matmul_head_channel_wise else 1
            Aq = dataclasses.replace(Aq, scale=Aq.scale.reshape(1, -1, 1, 1))
            if Aq.zero_point is not None:
                Aq = dataclasses.replace(
                    Aq, zero_point=Aq.zero_point.reshape(1, -1, 1, 1))
            Bq = dataclasses.replace(
                Bq, scale=Bq.scale.reshape(1, H, 1, 1),
                zero_point=Bq.zero_point.reshape(1, H, 1, 1))
            qstate[name] = MatMulSite(Aq=Aq, Bq=Bq)
            continue

        w_scale = _arr(sd, f"{name}.w_quantizer.scale")
        w_zp = _arr(sd, f"{name}.w_quantizer.zero_point")
        if w_scale is None:
            continue
        wq = WeightQuantizerState(scale=w_scale, zero_point=w_zp,
                                  bits=ss.w_bits, symmetric=w_zp is None)
        if ss.kind == "conv":
            aq = QuantizerState(scale=torch.ones((1, 1, 1, 1)),
                                kind="uniform", bits=ss.a_bits, symmetric=True)
            qstate[name] = ConvSite(wq=wq, aq=aq)
        else:
            a_kind = "uniform"
            if ss.kind == "postgelu":
                a_kind = ss.post_quantizer
            elif ss.kind == "postgelu_twin":
                a_kind = "twin"
            aq = _act_state(sd, f"{name}.a_quantizer", a_kind, ss.a_bits)
            qstate[name] = LinearSite(wq=wq, aq=aq, n_V=ss.n_V)

        # without a backbone in the dict, the site's (possibly reparamed)
        # weights replace the base's; with one, the model already holds them
        if not have_backbone and f"{name}.weight" in sd and ss.param_path:
            node = Node("LinearP", {"w": sd[f"{name}.weight"],
                                    "b": sd.get(f"{name}.bias")})
            params = tree_set(params, ss.param_path, affine_from_node(
                tree_get(params, ss.param_path), node))
    return params, qstate
