"""Build an uncalibrated-but-runnable qstate (min-max weight scales, unit
activation scales): the template a checkpoint fills, the pre-search state,
and enough for runs that need only the quantized compute graph.
"""

from __future__ import annotations

import torch

from adalog_tpu_torch.models.layers import (
    LinearSite, ConvSite, MatMulSite, linear_view, conv_view,
)
from adalog_tpu_torch.quantizers.state import (
    QuantizerState, WeightQuantizerState, GELU_MIN,
)
from adalog_tpu_torch.calib.layout import quant_layout, tree_get


def _minmax_wq(w_v, bits):
    N = 2 ** (bits - 1)
    hi = torch.amax(w_v, dim=-1, keepdim=True)
    lo = torch.amin(w_v, dim=-1, keepdim=True)
    scale = torch.clamp((hi - lo) / (2 * N - 1), min=1e-8)
    return WeightQuantizerState(scale=scale, zero_point=torch.round(-lo / scale),
                                bits=bits, symmetric=False)


def init_qstate(spec, cfg, params):
    """{site name: LinearSite | ConvSite | MatMulSite} on the params' device."""
    dev = params.head.weight.device
    layout = quant_layout(spec, cfg, reparam=False)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def log_q(kind):
        return (torch.tensor(37.0, device=dev) if kind == "adalog" else None)

    qstate = {}
    with torch.no_grad():
        for name, ss in layout.items():
            if ss.kind == "conv":
                p = tree_get(params, ss.param_path)
                qstate[name] = ConvSite(
                    wq=_minmax_wq(conv_view(p.weight.float()), ss.w_bits),
                    aq=QuantizerState(scale=ones(1, 1, 1, 1), kind="uniform",
                                      bits=ss.a_bits, symmetric=True))
            elif ss.kind in ("matmul", "matmul_post"):
                H = ss.heads if cfg.matmul_head_channel_wise else 1
                Bq = QuantizerState(scale=ones(1, H, 1, 1),
                                    zero_point=zeros(1, H, 1, 1),
                                    kind="uniform", bits=ss.a_bits,
                                    symmetric=False)
                if ss.kind == "matmul":
                    Aq = QuantizerState(scale=ones(1, H, 1, 1),
                                        zero_point=zeros(1, H, 1, 1),
                                        kind="uniform", bits=ss.s_bits,
                                        symmetric=False)
                else:
                    Aq = QuantizerState(scale=ones(1, 1, 1, 1),
                                        log_q=log_q(ss.post_quantizer),
                                        kind=ss.post_quantizer, bits=ss.s_bits)
                qstate[name] = MatMulSite(Aq=Aq, Bq=Bq)
            else:
                p = tree_get(params, ss.param_path)
                wq = _minmax_wq(linear_view(p.weight.float(), ss.n_V),
                                ss.w_bits)
                if ss.kind == "postgelu" and ss.post_quantizer != "ptq4vit":
                    aq = QuantizerState(
                        scale=ones(1),
                        shift=torch.full((1,), GELU_MIN, dtype=torch.float32,
                                         device=dev),
                        log_q=log_q(ss.post_quantizer),
                        bias_reparamed=torch.zeros((), dtype=torch.bool,
                                                   device=dev),
                        kind=ss.post_quantizer, bits=ss.a_bits, shifted=True)
                elif ss.kind == "postgelu_twin":
                    aq = QuantizerState(scale=ones(2, 1), kind="twin",
                                        bits=ss.a_bits)
                else:
                    aq = QuantizerState(scale=ones(1), zero_point=zeros(1),
                                        kind="uniform", bits=ss.a_bits,
                                        symmetric=False)
                qstate[name] = LinearSite(wq=wq, aq=aq, n_V=ss.n_V)
    return qstate
