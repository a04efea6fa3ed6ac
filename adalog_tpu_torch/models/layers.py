"""Layer forwards with quantization sites, as plain functions on tensors.

Parameters live in ``nn.Linear`` / ``nn.Conv2d`` / ``nn.LayerNorm`` modules;
each function reads the module's tensors, an optional quant-site state and a
mode:

    mode: 'raw'     -> FP forward
          'quant'   -> fake-quant weights + activations
          'w_only'  -> quantize weights only
          'a_only'  -> quantize activations only

Captured taps are returned through a ``taps`` dict the caller threads through
the forward, so one raw pass captures every site's inputs and output.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from adalog_tpu_torch.quantizers.state import QuantizerState, WeightQuantizerState
from adalog_tpu_torch.quantizers.apply import apply_quantizer, apply_weight_quantizer
from adalog_tpu_torch.ops import weight_prep


# ---------------------------------------------------------------------------
# Quant-site state
# ---------------------------------------------------------------------------

@dataclass
class LinearSite:
    """Quant state for a Linear site. n_V row groups split the output dim;
    n_V=3 separates the fused q/k/v rows."""
    wq: WeightQuantizerState
    aq: QuantizerState
    n_V: int = 1


@dataclass
class ConvSite:
    wq: WeightQuantizerState          # scale shape (oc, 1) over (oc, ic*kh*kw)
    aq: QuantizerState


@dataclass
class MatMulSite:
    """Quant state for a bare A@B site (the two attention matmuls)."""
    Aq: QuantizerState                # per-head scale (1, H, 1, 1) when head-wise
    Bq: QuantizerState


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------

def linear_view(w: torch.Tensor, n_V: int) -> torch.Tensor:
    """(out, in) -> (n_V, out/n_V, in) row-group view."""
    out, inf = w.shape
    return w.reshape(n_V, out // n_V, inf)


def quant_linear_weight(p: torch.nn.Linear, site: LinearSite) -> torch.Tensor:
    wv = linear_view(p.weight, site.n_V)
    return apply_weight_quantizer(site.wq, wv).reshape(p.weight.shape)


def qlinear(p: torch.nn.Linear, site, x, *, mode: str = "raw", name=None):
    """y = x @ W^T + b with optional fake quantization of W and/or x.

    In quant/w_only mode the weight comes from the load-time table of
    ``ops.weight_prep`` when one is active, else it is quantized here."""
    w = p.weight
    if site is not None and mode in ("quant", "w_only"):
        w = weight_prep.lookup(name, w.shape)
        if w is None:
            w = quant_linear_weight(p, site)
    if site is not None and mode in ("quant", "a_only"):
        x = apply_quantizer(site.aq, x)
    return F.linear(x, w, p.bias)


def conv_view(w: torch.Tensor) -> torch.Tensor:
    """(oc, ic, kh, kw) -> (oc, ic*kh*kw) flat view."""
    return w.reshape(w.shape[0], -1)


def quant_conv_weight(p: torch.nn.Conv2d, site: ConvSite) -> torch.Tensor:
    wv = conv_view(p.weight)
    return apply_weight_quantizer(site.wq, wv).reshape(p.weight.shape)


def qconv2d(p: torch.nn.Conv2d, site, x, *, mode: str = "raw"):
    """Conv on NHWC images with optional fake quantization; returns NHWC.

    Activations pass through unquantized when a-bits >= 8; the shipped
    configs set qconv_a_bit=8, so the patch-embed conv is weight-only."""
    w = p.weight
    if site is not None and mode in ("quant", "w_only"):
        w = quant_conv_weight(p, site)
    if site is not None and mode in ("quant", "a_only") and site.aq.bits < 8:
        x = apply_quantizer(site.aq, x)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, p.bias, stride=p.stride,
                 padding=p.padding)
    return y.permute(0, 2, 3, 1)


def qmatmul(site, A, B, *, mode: str = "raw"):
    """A @ B with optional fake quantization of both operands."""
    if site is not None and mode == "quant":
        A = apply_quantizer(site.Aq, A)
        B = apply_quantizer(site.Bq, B)
    return torch.matmul(A, B)


def layer_norm(p: torch.nn.LayerNorm, x):
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + p.eps) * p.weight + p.bias


def gelu(x):
    """Exact (erf) GeLU."""
    return F.gelu(x, approximate="none")
