"""Reparameterization transforms, the counterpart of
``adalog_tpu.calib.reparam``.

1. LayerNorm channel reparam: fold the per-input-channel activation ranges
   of a qkv/fc1 Linear into the preceding LayerNorm's affine and the
   Linear's weight and bias, so that a per-tensor quantizer suffices
   afterwards. LayerNorm followed by the Linear computes the same function;
   a cached calibration input is rewritten the same way (x' = x / r - b).

2. Post-GeLU bias fold: fold the constant GeLU shift through the quantized
   fc2 weight into the layer's bias. The caller then sets the site's
   ``aq.bias_reparamed``, and inference quantizes x + shift directly, with
   no subtract-back: the form the fused GEMM kernel (ops/fq_gemm.py) takes.

Each function returns new modules or tensors and leaves its arguments as
they were.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from adalog_tpu_torch.models.layers import quant_linear_weight


def _with(module: nn.Module, **tensors) -> nn.Module:
    """A copy of ``module`` with the named parameters replaced."""
    new = copy.deepcopy(module)
    for name, t in tensors.items():
        old = getattr(module, name)
        setattr(new, name, nn.Parameter(
            t.detach().clone(),
            requires_grad=old is not None and old.requires_grad))
    return new


def layernorm_channel_reparam(norm: nn.LayerNorm, lin: nn.Linear, a_scale,
                              a_zp):
    """Returns (norm', lin', r, b, target_scale, target_zp).

    a_scale, a_zp: per-input-channel (I,) from the channel-wise search. r
    rescales the channels to a common range, b shifts their minima to a
    common zero point. norm: weight / r, bias / r - b; lin: weight * r per
    column, bias + weight'·b (a bias is created where the Linear has none).
    """
    with torch.no_grad():
        channel_min = -a_zp * a_scale
        target_scale = torch.mean(a_scale).reshape(1)
        target_zp = torch.round(torch.mean(a_zp)).reshape(1)
        target_min = -target_zp * target_scale
        r = a_scale / target_scale
        b = channel_min / r - target_min

        new_norm = _with(norm, weight=norm.weight / r,
                         bias=norm.bias / r - b)
        new_w = lin.weight * r[None, :]
        add = new_w @ b
        new_bias = add if lin.bias is None else lin.bias + add
        return (new_norm, _with(lin, weight=new_w, bias=new_bias), r, b,
                target_scale, target_zp)


def rewrite_cached_input(x, r, b):
    """Apply the channel reparam to a cached calibration input."""
    return x / r - b


def fold_gelu_shift_into_bias(lin: nn.Linear, site, *, shift) -> nn.Linear:
    """bias' = bias + (-shift·1) @ W_qᵀ with W_q the fake-quantized weight
    of ``site``. The caller sets ``site.aq.bias_reparamed``."""
    with torch.no_grad():
        w_q = quant_linear_weight(lin, site)
        add = w_q @ torch.full((lin.weight.shape[1],), -shift,
                               dtype=lin.weight.dtype,
                               device=lin.weight.device)
        bias = add if lin.bias is None else lin.bias + add
        return _with(lin, bias=bias)
