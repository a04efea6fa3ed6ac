"""Linear weights as integers, for the fused GEMM kernel.

A served Linear site's fake-quantized weight ``w_q = dequant(quant(w))`` is
computed once per loaded model where its route is built (ops/routes.py),
so the forward never recomputes it. ``weight_codes`` gives the same weight
as integers with their row scales, for the fused GEMM kernel's integer
operands (ops/fq_gemm.py, variant "mma" with fp32 inputs).
"""

from __future__ import annotations

import torch

# integers |c_w - z_w| <= 256 of at most 8 bits are exact in bf16
_CODE_BITS = 8
_CODE_MAX = 256


def site_weight_codes(weight, site):
    """(c_w - z_w (O, K) float32, s_w (O,) float32) of a Linear site, by the
    arithmetic of ``apply_weight_quantizer`` (uniform or hard AdaRound, the
    scale per output row of each of the n_V row groups), so that codes *
    s_w[:, None] equals ``quant_linear_weight`` of a float32 module bit for
    bit."""
    from adalog_tpu_torch.models.layers import linear_view

    wq = site.wq
    N = 2 ** (wq.bits - 1)
    w = linear_view(weight.float(), site.n_V)
    if wq.alpha is not None:        # AdaRound does not round its zero point
        x_int = torch.floor(w / wq.scale) + (wq.alpha >= 0).to(w.dtype)
        zp = wq.zero_point
    else:
        x_int = torch.round(w / wq.scale)
        zp = None if wq.symmetric else torch.round(wq.zero_point)
    if wq.symmetric:
        codes = torch.clamp(x_int, -N, N - 1)
    else:
        codes = torch.clamp(x_int + zp, 0, 2 * N - 1) - zp
    scale = wq.scale.float().expand(*w.shape[:2], 1)
    return codes.reshape(weight.shape), scale.reshape(weight.shape[0])


def weight_codes(weight, site):
    """The ``fq_gemm.WeightCodes`` of a quantized Linear site whose weight
    integers c_w - z_w are exact in bf16: at most 8 bits, whole numbers (a
    hard AdaRound site with a fractional zero point is not) and of magnitude
    at most 256; else None. Reads the codes on the host, so it belongs where
    a predictor is built."""
    from adalog_tpu_torch.ops.fq_gemm import WeightCodes

    if site.wq.bits > _CODE_BITS:
        return None
    codes, scale = site_weight_codes(weight, site)
    if not bool(((codes == torch.round(codes))
                 & (codes.abs() <= _CODE_MAX)).all()):
        return None
    return WeightCodes(codes.to(torch.bfloat16).contiguous(),
                       scale.contiguous())
