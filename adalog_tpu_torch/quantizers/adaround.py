"""AdaRound learned-rounding weight quantization, hard (eval) form.

A checkpoint from block reconstruction carries the frozen rounding decision
either already folded into the weights or as the ``alpha`` logit of a
``WeightQuantizerState``; at eval the decision is ``alpha >= 0``. The soft
(rectified-sigmoid) training form and the weight freezing come with the
reconstruction port.
"""

import torch


def adaround_quant(w, scale, zero_point, alpha, *, bits: int, symmetric: bool):
    """Fake-quantize weights with the hard (alpha >= 0) rounding decision."""
    N = 2 ** (bits - 1)
    x_int = torch.floor(w / scale) + (alpha >= 0).to(w.dtype)
    if symmetric:
        return torch.clamp(x_int, -N, N - 1) * scale
    x_q = torch.clamp(x_int + zero_point, 0, 2 * N - 1)
    return (x_q - zero_point) * scale
