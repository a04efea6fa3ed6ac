"""Load-time fake quantization of Linear weights.

The quantized forward would otherwise recompute ``w_q = dequant(quant(w))``
over every O×I weight matrix on each call. ``prepare`` computes the table
once per loaded model; a predictor enters ``activate(table)`` around its
forward and ``qlinear`` takes each site's prepared weight from it. The
active table is a context variable, so two predictors never see each
other's weights. ``weight_codes`` gives the same weights as integers with
their row scales, for the fused GEMM kernel's integer operands
(ops/fq_gemm.py, variant "mma" with fp32 inputs).
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "adalog_weight_prep", default=None)


@contextmanager
def activate(table):
    tok = _ACTIVE.set(table)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def lookup(name, shape):
    """The prepared quantized weight for site ``name``, or None."""
    table = _ACTIVE.get()
    if name is None or table is None:
        return None
    hit = table.get(name)
    if hit is not None and hit.shape == shape:
        return hit
    return None


def prepare(spec, params, qstate, cfg, skip=()) -> dict:
    """{site_name: w_fakequant} for every quantized Linear site but those in
    ``skip`` (the int8 sites, which read no fake-quantized weight), computed
    from the same (already cast) module the predictor runs, so it equals
    what the per-call path would produce."""
    from adalog_tpu_torch.calib.layout import quant_layout, tree_get
    from adalog_tpu_torch.models.layers import LinearSite, quant_linear_weight

    table = {}
    with torch.no_grad():
        for nm, ss in quant_layout(spec, cfg).items():
            site = qstate.get(nm)
            if not isinstance(site, LinearSite) or site.wq.bits == 32 \
                    or nm in skip:
                continue
            table[nm] = quant_linear_weight(tree_get(params, ss.param_path),
                                            site)
    return table


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


def weight_codes(spec, params, qstate, cfg) -> dict:
    """{site_name: fq_gemm.WeightCodes} for every quantized Linear site
    whose weight integers c_w - z_w are exact in bf16: at most 8 bits, whole
    numbers (a hard AdaRound site with a fractional zero point is not) and
    of magnitude at most 256. Reads each site's codes on the host once, so
    it belongs where a predictor is built."""
    from adalog_tpu_torch.calib.layout import quant_layout, tree_get
    from adalog_tpu_torch.models.layers import LinearSite
    from adalog_tpu_torch.ops.fq_gemm import WeightCodes

    table = {}
    with torch.no_grad():
        for nm, ss in quant_layout(spec, cfg).items():
            site = qstate.get(nm)
            if not isinstance(site, LinearSite) \
                    or site.wq.bits > _CODE_BITS:
                continue
            codes, scale = site_weight_codes(
                tree_get(params, ss.param_path).weight, site)
            if bool(((codes == torch.round(codes))
                     & (codes.abs() <= _CODE_MAX)).all()):
                table[nm] = WeightCodes(codes.to(torch.bfloat16).contiguous(),
                                        scale.contiguous())
    return table
