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

Under a predictor's plan (ops/routes.py) each quantized site runs as its
route says: ``qlinear`` by the one route of its Linear site,
``quant_attention`` and ``qmatmul`` through the attention kernels where the
plan turns them on, ``layer_norm`` through K7 where the plan routes its
module. ``training=True`` (block reconstruction) rounds with
straight-through estimators so gradients reach the quantizers' scales, and
reads no plan: no kernel, no prepared weight. ``soft=True`` takes the soft
AdaRound target of a weight quantizer that carries an ``alpha``, and reads
no plan either.

Under tensor parallelism (parallel/tp.py) the row-parallel Linear sites
hold an input-feature slice of their weight: ``qlinear`` sums their
partial products over the tp group of their route and adds the bias once,
on the sum.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from adalog_tpu_torch.quantizers.state import QuantizerState, WeightQuantizerState
from adalog_tpu_torch.quantizers.apply import apply_quantizer, apply_weight_quantizer
from adalog_tpu_torch.ops import fq_act, fq_attn, fq_gemm, int8_linear, routes
from adalog_tpu_torch.ops.layer_norm import layer_norm_plain, layer_norm_rows
from adalog_tpu_torch.utils.profiling import span

# the span of each activation quantizer kind (utils/profiling.py)
_ACT_SPAN = {k: "fq.act." + k
             for k in ("uniform", "twin", "log2", "logsqrt2", "adalog")}


def _act_quant(qs, x, training, act=None):
    """``apply_quantizer`` inside its span; a Linear site whose route holds
    an ``fq_act.ActSite`` ``act`` runs through K6's wrapper instead, in the
    same span."""
    with span(_ACT_SPAN.get(qs.kind, "fq.act")):
        if act is not None:
            return fq_act.fq_act_quant(act, x)
        return apply_quantizer(qs, x, training=training)


def _tap(taps, name, *tensors):
    if taps is not None:
        taps[name] = tensors


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


# a site outside a plan: weight and input quantized at the call
_PER_CALL = routes.Route("eager", site=None, shape=None)


def qlinear(p: torch.nn.Linear, site, x, *, mode: str = "raw",
            training: bool = False, soft: bool = False, name=None):
    """y = x @ W^T + b with optional fake quantization of W and/or x.

    Under a predictor's plan, outside training and soft rounding, a
    quantized site reads its one route (``ops.routes``): in quant mode an
    "int8" route runs as an integer product, an "fq_gemm" route through the
    fused GEMM kernel (the activation quantizer inside the product, the bias
    added after it in the compute dtype), and the others fake-quantize the
    input, in one pass (K6) on an "fq_act" route; in quant and w_only mode
    the weight is the route's prepared one. Otherwise the weight and the
    input are quantized here, per call.

    A row-parallel route (a tp rank's) takes neither the int8 nor the fused
    GEMM (as in the JAX package): its partial product is summed over the tp
    group, then the bias is added once."""
    route = _PER_CALL
    if site is not None and not training and not soft:
        plan = routes.current()
        if plan is not None:
            route = plan.route(name, site, p.weight)
    if route.kind == "int8" and mode == "quant":
        with span("linear.int8"):
            return int8_linear.int8_qlinear(p, site, x, route.int8)
    w = p.weight
    if site is not None and mode in ("quant", "w_only"):
        w = route.weight
        if w is None:
            with span("fq.weight"):
                w = quant_linear_weight(p, site, soft=soft,
                                        training=training)
    if site is not None and mode in ("quant", "a_only"):
        if route.kind == "fq_gemm" and mode == "quant":
            with span("linear.fq_gemm"):
                y = fq_gemm.run(route.gemm, x.reshape(-1, x.shape[-1]), w,
                                p.bias)
            return y.reshape(*x.shape[:-1], w.shape[0])
        x = _act_quant(site.aq, x, training, route.act)
    with span("linear"):
        if route.row is None:
            return F.linear(x, w, p.bias)
        y = F.linear(x, w)
        dist.all_reduce(y, group=route.row)
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


def qmatmul(site, A, B, *, mode: str = "raw", training: bool = False,
            name=None):
    """A @ B with optional fake quantization of both operands.

    Where the predictor's plan turns the attention kernels on, a supported
    quant-mode site with 4-D operands runs through K3 (``fq_attn.run``),
    outside training: both quantizers inside the batched product."""
    if site is not None and mode == "quant":
        plan = None if training else routes.current()
        if plan is not None and plan.attn and A.dim() == 4 \
                and fq_attn.supports(site, mode):
            return fq_attn.run(site, A, B, name=name)
        A = _act_quant(site.Aq, A, training)
        B = _act_quant(site.Bq, B, training)
    return torch.matmul(A, B)


def quant_attention(q, kT, v, m1_site, m2_site, m1_mode, m2_mode, taps,
                    names, *, training, logit_scale, run_flash, bias=None,
                    add_bias=None):
    """softmax(q @ kT * logit_scale (+ bias)) @ v through the quantized
    attention matmul sites ``names`` = (matmul1, matmul2), in three tiers:
    K1 (``run_flash``) where the predictor's plan turns the attention
    kernels on and K1 takes the call; else K3 for matmul1 (``qmatmul``), the
    scale and ``add_bias`` on the logits, then K2 (``fq_attn.run_softmax``)
    for the rest where the plan turns the kernels on; else the plain ops
    (always in training and while ``taps`` are captured).

    q, v: (N, H, S, D), kT: (N, H, D, S); returns (N, H, S, D).
    ``run_flash`` is the family module's ``fq_attn.run_flash``, read at the
    call (the benchmark's recorder wraps it); ``bias`` a callable giving
    K1's (P, S, S) additive logit bias, called only where K1 runs;
    ``add_bias`` the unfused path's: logits -> logits with the bias."""
    nm1, nm2 = names
    plan = None if taps is not None or training else routes.current()
    fused = plan is not None and plan.attn
    if fused and fq_attn.supports_flash(
            m1_site, m2_site, m1_mode, m2_mode, shape=q.shape[-2:],
            dtype=q.dtype, exact_ints=plan.exact_ints):
        # the whole quantized attention, uq(q) @ uq(kT) -> scale (+ bias)
        # -> softmax -> AdaLog -> @ uq(v), in one kernel: the (N, H, S, S)
        # logits never reach device memory
        return run_flash(m1_site, m2_site, q, kT, v, logit_scale=logit_scale,
                         bias=None if bias is None else bias(), names=names)
    attn = qmatmul(m1_site, q, kT, mode=m1_mode, training=training, name=nm1)
    _tap(taps, nm1, q, kT, attn)
    if logit_scale != 1.0:
        attn = attn * logit_scale
    if add_bias is not None:
        attn = add_bias(attn)
    if fused and m2_site is not None \
            and fq_attn.supports_softmax(m2_site, m2_mode):
        # softmax, AdaLog and the product with uq(v) fused; the logits are
        # still a device-memory operand
        return fq_attn.run_softmax(m2_site, attn, v, name=nm2)
    attn = torch.softmax(attn, dim=-1)
    out = qmatmul(m2_site, attn, v, mode=m2_mode, training=training, name=nm2)
    _tap(taps, nm2, attn, v, out)
    return out


def layer_norm(p: torch.nn.LayerNorm, x, *, training: bool = False):
    """LayerNorm over the last dimension: through K7 (``ops.layer_norm``)
    where a predictor's plan routes module ``p``, outside training; else
    the plain version."""
    with span("norm"):
        plan = None if training else routes.current()
        if plan is not None and p in plan.norms:
            return layer_norm_rows(p, x)
        return layer_norm_plain(x, p.weight, p.bias, p.eps)


def gelu(x):
    """Exact (erf) GeLU."""
    with span("gelu"):
        return F.gelu(x, approximate="none")
