"""Single dispatch point: QuantizerState -> fake-quantized tensor."""

import torch

from adalog_tpu_torch.quantizers.state import QuantizerState, WeightQuantizerState
from adalog_tpu_torch.quantizers.uniform import uniform_quant, twin_uniform_quant
from adalog_tpu_torch.quantizers.logarithm import (
    log2_quant, logsqrt2_quant, adalog_quant,
)
from adalog_tpu_torch.quantizers.adaround import adaround_quant


def apply_quantizer(qs: QuantizerState, x, *, training: bool = False):
    if qs.bits == 32:
        return x
    # quantizer math always runs in fp32 (scales and grids are fp32-exact);
    # the result is cast back so a bfloat16 eval stays bfloat16
    in_dtype = x.dtype
    if in_dtype != torch.float32:
        x = x.float()
    if qs.shifted:
        x = x + qs.shift

    if qs.kind == "uniform":
        out = uniform_quant(x, qs.scale, qs.zero_point, bits=qs.bits,
                            symmetric=qs.symmetric, training=training)
    elif qs.kind == "twin":
        out = twin_uniform_quant(x, qs.scale[0], qs.scale[1], bits=qs.bits,
                                 training=training)
    elif qs.kind == "log2":
        out = log2_quant(x, qs.scale, bits=qs.bits, training=training)
    elif qs.kind == "logsqrt2":
        out = logsqrt2_quant(x, qs.scale, bits=qs.bits, training=training)
    elif qs.kind == "adalog":
        out = adalog_quant(x, qs.scale, qs.log_q, bits=qs.bits, training=training)
    else:
        raise NotImplementedError(f"quantizer kind {qs.kind!r}")

    if qs.shifted:
        # subtract the shift back until it has been folded into the
        # consumer's bias
        out = out - qs.shift * (1.0 - qs.bias_reparamed.to(out.dtype))
    return out.to(in_dtype)


def apply_weight_quantizer(wq: WeightQuantizerState, w_viewed, *,
                           soft: bool = False, training: bool = False):
    """Fake-quantize a weight tensor already reshaped to the row-group view.
    With an AdaRound ``alpha``, ``soft`` takes the soft rounding target
    (reconstruction training) instead of the hard decision."""
    if wq.bits == 32:
        return w_viewed
    in_dtype = w_viewed.dtype
    if in_dtype != torch.float32:
        w_viewed = w_viewed.float()
    if wq.alpha is not None:
        out = adaround_quant(w_viewed, wq.scale, wq.zero_point, wq.alpha,
                             bits=wq.bits, symmetric=wq.symmetric, soft=soft)
    else:
        out = uniform_quant(w_viewed, wq.scale, wq.zero_point, bits=wq.bits,
                            symmetric=wq.symmetric, training=training)
    return out.to(in_dtype)
