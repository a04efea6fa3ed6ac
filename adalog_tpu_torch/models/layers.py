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
kernel: no int8 GEMM, no weight-prep table, no fused GEMM, no fused
attention matmul.
``soft=True`` takes the soft AdaRound target of a weight quantizer that
carries an ``alpha``, and reads no weight-prep or activation-quant table
either.

Under tensor parallelism (parallel/tp.py) the row-parallel Linear sites
named by ``tp_row_context`` hold an input-feature slice of their weight:
``qlinear`` sums their partial products over the tp group and adds the bias
once, on the sum.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from adalog_tpu_torch.quantizers.state import QuantizerState, WeightQuantizerState
from adalog_tpu_torch.quantizers.apply import apply_quantizer, apply_weight_quantizer
from adalog_tpu_torch.ops import (
    fq_act, fq_attn, fq_gemm, int8_linear, weight_prep,
)
from adalog_tpu_torch.utils.profiling import span

# the span of each activation quantizer kind (utils/profiling.py)
_ACT_SPAN = {k: "fq.act." + k
             for k in ("uniform", "twin", "log2", "logsqrt2", "adalog")}


def _act_quant(qs, x, training, name=None):
    """``apply_quantizer`` inside its span; outside training, the Linear
    site ``name`` of the active ``ops.fq_act`` table runs through K6's
    wrapper instead, in the same span."""
    with span(_ACT_SPAN.get(qs.kind, "fq.act")):
        hit = None if training else fq_act.lookup(name, qs)
        if hit is not None:
            return fq_act.fq_act_quant(hit, x)
        return apply_quantizer(qs, x, training=training)


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
# Tensor-parallel context
# ---------------------------------------------------------------------------

# (tp process group, frozenset of row-parallel site names) while a rank's
# forward runs over a tp mesh (parallel/tp.py), else None
_TP_ROW: contextvars.ContextVar = contextvars.ContextVar(
    "adalog_tp_row", default=None)


def tp_row_group(name):
    """The tp process group when site ``name`` is row-parallel in the active
    context, else None."""
    ctx = _TP_ROW.get()
    if ctx is not None and name is not None and name in ctx[1]:
        return ctx[0]
    return None


@contextmanager
def tp_row_context(group, names):
    """Mark the Linear sites ``names`` row-parallel over the process group
    ``group`` inside the block."""
    tok = _TP_ROW.set((group, frozenset(names)))
    try:
        yield
    finally:
        _TP_ROW.reset(tok)


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

    In quant mode, outside training, while an ``ops.int8_linear`` table is
    active, a site that ``int8_linear.supports`` runs as an integer product,
    before anything else is looked up (as in the JAX package). In
    quant/w_only mode the weight comes from the load-time table of
    ``ops.weight_prep`` when one is active (never in training or soft
    mode), else it is quantized here. In quant mode, outside training, a
    site of the active ``ops.fq_gemm`` table runs through the fused kernel:
    the activation quantizer inside the GEMM, the bias added after the
    product in the compute dtype. Otherwise, outside training and soft
    mode, a site of the active ``ops.fq_act`` table fake-quantizes its
    input in one pass (K6).

    A row-parallel site of the active ``tp_row_context`` takes neither the
    int8 nor the fused GEMM (as in the JAX package): its partial product is
    summed over the tp group, then the bias is added once."""
    row = tp_row_group(name)
    if row is None and site is not None and mode == "quant" \
            and not training and int8_linear.enabled() \
            and int8_linear.supports(site, mode):
        with span("linear.int8"):
            return int8_linear.int8_qlinear(p, site, x, name=name)
    w = p.weight
    if site is not None and mode in ("quant", "w_only"):
        w = None
        if not training and not soft:
            w = weight_prep.lookup(name, p.weight.shape)
        if w is None:
            with span("fq.weight"):
                w = quant_linear_weight(p, site, soft=soft,
                                        training=training)
    if site is not None and mode in ("quant", "a_only"):
        hit = fq_gemm.lookup(name) \
            if mode == "quant" and not training and row is None else None
        if hit is not None:
            with span("linear.fq_gemm"):
                y = fq_gemm.run(hit, x.reshape(-1, x.shape[-1]), w, p.bias)
            return y.reshape(*x.shape[:-1], w.shape[0])
        x = _act_quant(site.aq, x, training, None if soft else name)
    with span("linear"):
        if row is None:
            return F.linear(x, w, p.bias)
        y = F.linear(x, w)
        dist.all_reduce(y, group=row)
        return y if p.bias is None else y + p.bias


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
        with span("fq.weight"):
            w = quant_conv_weight(p, site, soft=soft, training=training)
    if site is not None and mode in ("quant", "a_only") and site.aq.bits < 8:
        x = _act_quant(site.aq, x, training)
    xc = x.permute(0, 3, 1, 2)
    with span("conv"):
        if x.device.type == "cuda" and x.dtype == torch.float32:
            with _cudnn_full_fp32():
                y = F.conv2d(xc, w, p.bias, stride=p.stride,
                             padding=p.padding)
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
        A = _act_quant(site.Aq, A, training)
        B = _act_quant(site.Bq, B, training)
    return torch.matmul(A, B)


def layer_norm(p: torch.nn.LayerNorm, x):
    with span("norm"):
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mu).mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + p.eps) * p.weight + p.bias


def gelu(x):
    """Exact (erf) GeLU."""
    with span("gelu"):
        return F.gelu(x, approximate="none")
