"""Load-time fake quantization of Linear weights.

The quantized forward would otherwise recompute ``w_q = dequant(quant(w))``
over every O×I weight matrix on each call. ``prepare`` computes the table
once per loaded model; a predictor enters ``activate(table)`` around its
forward and ``qlinear`` takes each site's prepared weight from it. The
active table is a context variable, so two predictors never see each
other's weights.
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


def prepare(spec, params, qstate, cfg) -> dict:
    """{site_name: w_fakequant} for every quantized Linear site, computed
    from the same (already cast) module the predictor runs, so it equals
    what the per-call path would produce."""
    from adalog_tpu_torch.calib.layout import quant_layout, tree_get
    from adalog_tpu_torch.models.layers import LinearSite, quant_linear_weight

    table = {}
    with torch.no_grad():
        for nm, ss in quant_layout(spec, cfg).items():
            site = qstate.get(nm)
            if not isinstance(site, LinearSite) or site.wq.bits == 32:
                continue
            table[nm] = quant_linear_weight(tree_get(params, ss.param_path),
                                            site)
    return table
