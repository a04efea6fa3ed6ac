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

``training=True`` (block reconstruction) rounds with straight-through
estimators so gradients reach the quantizers' scales, and dispatches no
kernel: no weight-prep table, no fused GEMM, no fused attention matmul.
``soft=True`` takes the soft AdaRound target of a weight quantizer that
carries an ``alpha``, and reads no weight-prep table either.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from adalog_tpu_torch.quantizers.state import QuantizerState, WeightQuantizerState
from adalog_tpu_torch.quantizers.apply import apply_quantizer, apply_weight_quantizer
from adalog_tpu_torch.ops import fq_attn, fq_gemm, weight_prep


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


def quant_linear_weight(p: torch.nn.Linear, site: LinearSite, *,
                        soft: bool = False,
                        training: bool = False) -> torch.Tensor:
    wv = linear_view(p.weight, site.n_V)
    return apply_weight_quantizer(site.wq, wv, soft=soft,
                                  training=training).reshape(p.weight.shape)


def qlinear(p: torch.nn.Linear, site, x, *, mode: str = "raw",
            training: bool = False, soft: bool = False, name=None):
    """y = x @ W^T + b with optional fake quantization of W and/or x.

    In quant/w_only mode the weight comes from the load-time table of
    ``ops.weight_prep`` when one is active (never in training or soft
    mode), else it is quantized here. In quant mode, outside training, a
    site of the active ``ops.fq_gemm`` table runs through the fused kernel:
    the activation quantizer inside the GEMM, the bias added after the
    product in the compute dtype."""
    w = p.weight
    if site is not None and mode in ("quant", "w_only"):
        w = None
        if not training and not soft:
            w = weight_prep.lookup(name, p.weight.shape)
        if w is None:
            w = quant_linear_weight(p, site, soft=soft, training=training)
    if site is not None and mode in ("quant", "a_only"):
        hit = fq_gemm.lookup(name) if mode == "quant" and not training \
            else None
        if hit is not None:
            y = fq_gemm.run(hit, x.reshape(-1, x.shape[-1]), w, p.bias)
            return y.reshape(*x.shape[:-1], w.shape[0])
        x = apply_quantizer(site.aq, x, training=training)
    return F.linear(x, w, p.bias)


def conv_view(w: torch.Tensor) -> torch.Tensor:
    """(oc, ic, kh, kw) -> (oc, ic*kh*kw) flat view."""
    return w.reshape(w.shape[0], -1)


def quant_conv_weight(p: torch.nn.Conv2d, site: ConvSite, *,
                      soft: bool = False,
                      training: bool = False) -> torch.Tensor:
    wv = conv_view(p.weight)
    return apply_weight_quantizer(site.wq, wv, soft=soft,
                                  training=training).reshape(p.weight.shape)


@contextmanager
def _cudnn_full_fp32():
    """cuDNN convolutions in full fp32 inside the block (its default for
    fp32 inputs is TF32, about three decimal digits); the process's setting
    is restored on exit."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


def qconv2d(p: torch.nn.Conv2d, site, x, *, mode: str = "raw",
            training: bool = False, soft: bool = False):
    """Conv on NHWC images with optional fake quantization; returns NHWC.

    Activations pass through unquantized when a-bits >= 8; the shipped
    configs set qconv_a_bit=8, so the patch-embed conv is weight-only. An
    fp32 convolution on a CUDA device runs in full fp32, as the JAX layer
    pins Precision.HIGHEST, whatever the process has set for cuDNN. The
    pin covers the forward only: a caller that differentiates through the
    convolution pins cuDNN for its backward too (``recon.brecq`` does)."""
    w = p.weight
    if site is not None and mode in ("quant", "w_only"):
        w = quant_conv_weight(p, site, soft=soft, training=training)
    if site is not None and mode in ("quant", "a_only") and site.aq.bits < 8:
        x = apply_quantizer(site.aq, x, training=training)
    xc = x.permute(0, 3, 1, 2)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        with _cudnn_full_fp32():
            y = F.conv2d(xc, w, p.bias, stride=p.stride, padding=p.padding)
    else:
        y = F.conv2d(xc, w, p.bias, stride=p.stride, padding=p.padding)
    return y.permute(0, 2, 3, 1)


def qmatmul(site, A, B, *, mode: str = "raw", training: bool = False):
    """A @ B with optional fake quantization of both operands.

    With the attention kernels on, a supported quant-mode site with 4-D
    operands runs through the fused kernel of ``ops.fq_attn`` (K3), outside
    training: both quantizers inside the batched product."""
    if site is not None and mode == "quant":
        if not training and A.dim() == 4 and fq_attn.supports(site, mode):
            return fq_attn.run(site, A, B)
        A = apply_quantizer(site.Aq, A, training=training)
        B = apply_quantizer(site.Bq, B, training=training)
    return torch.matmul(A, B)


def layer_norm(p: torch.nn.LayerNorm, x):
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + p.eps) * p.weight + p.bias


def gelu(x):
    """Exact (erf) GeLU."""
    return F.gelu(x, approximate="none")
