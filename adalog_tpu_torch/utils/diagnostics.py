"""Per-site quantization error diagnostics.

The counterpart of ``adalog_tpu.utils.diagnostics``: for every calibrated
site, the layer-local output error of weight-only, activation-only and full
quantization against the raw capture, one report for the whole model from a
single capture pass (``calib.calibrator.capture_all_sites``). It locates
the layers that dominate the accuracy loss at low bit widths. It runs on
the model's device, through the plain layer forwards (no kernel context is
entered).

Run it BEFORE the post-GeLU bias fold for the cleanest fc2 numbers: after
the fold, a_only mixes raw weights with a bias compensated for quantized
weights (the reference's debug modes have the same artifact).
"""

from __future__ import annotations

import logging
from typing import Dict, List

import torch

from adalog_tpu_torch.calib.calibrator import capture_all_sites
from adalog_tpu_torch.calib.layout import tree_get
from adalog_tpu_torch.models.layers import (
    ConvSite, MatMulSite, qconv2d, qlinear, qmatmul,
)

log = logging.getLogger("adalog_tpu_torch")


def _rel(err, ref) -> float:
    denom = float(torch.linalg.norm(ref.float()))
    return float(torch.linalg.norm(err.float())) / max(denom, 1e-12)


def site_error_report(spec, params, qstate, layout, batches) -> List[Dict]:
    """One row per site with a tap: {"site", "kind", "w_only", "a_only",
    "quant"}, each the relative layer-output error of that mode on the
    calibration capture (matmul sites: "quant" only, the others None).
    ``batches`` are NHWC image batches (numpy or tensors)."""
    taps = capture_all_sites(spec, params, batches)
    rows = []
    with torch.no_grad():
        for name, site in qstate.items():
            tap = taps.get(name)
            if tap is None:
                continue
            row = {"site": name, "kind": layout[name].kind}
            if isinstance(site, MatMulSite):
                A, B, y = tap
                row["quant"] = _rel(qmatmul(site, A, B, mode="quant") - y, y)
                row["w_only"] = row["a_only"] = None
            else:
                x, y = tap[0], tap[1]
                p = tree_get(params, layout[name].param_path)
                fn = qconv2d if isinstance(site, ConvSite) else qlinear
                for mode in ("w_only", "a_only", "quant"):
                    row[mode] = _rel(fn(p, site, x, mode=mode) - y, y)
            rows.append(row)
            taps[name] = None
    return rows


def log_report(rows: List[Dict], top: int = 10):
    """Log the ``top`` rows by full-quantization error."""
    rows_sorted = sorted(rows, key=lambda r: -(r.get("quant") or 0.0))
    log.info("%-40s %-14s %8s %8s %8s", "site", "kind", "w_only", "a_only",
             "quant")
    for r in rows_sorted[:top]:
        log.info("%-40s %-14s %8s %8s %8s", r["site"], r["kind"],
                 *(f"{r[k]:.4f}" if r[k] is not None else "-"
                   for k in ("w_only", "a_only", "quant")))
