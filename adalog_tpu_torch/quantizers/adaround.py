"""AdaRound learned-rounding weight quantization (Nagel et al. 2020).

The rounding decision for each weight is a learnable logit ``alpha``.
During block reconstruction the forward uses a rectified-sigmoid "soft
target" in [0, 1]; afterwards the hard 0/1 decision (alpha >= 0) is frozen
into the weights (``adaround_hard_weight``). A checkpoint may also carry the
frozen decision as the ``alpha`` of a ``WeightQuantizerState``, which the
eval forward applies in its hard form.
"""

import torch

GAMMA, ZETA = -0.1, 1.1


def adaround_init_alpha(w, scale):
    """Inverse rectified sigmoid, so that soft_targets(alpha) ==
    frac(w/scale): rest = w/s - floor(w/s), alpha = -log((zeta - gamma) /
    (rest - gamma) - 1)."""
    rest = w / scale - torch.floor(w / scale)
    return -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0)


def adaround_soft_targets(alpha):
    """clamp(sigmoid(alpha) * (zeta - gamma) + gamma, 0, 1), the sigmoid
    written as 1 / (1 + exp(-alpha)) as the JAX package writes it (its value
    may differ from ``torch.sigmoid``'s in the last bit)."""
    return torch.clamp(torch.reciprocal(1.0 + torch.exp(-alpha))
                       * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def adaround_quant(w, scale, zero_point, alpha, *, bits: int, symmetric: bool,
                   soft: bool = False):
    """Fake-quantize weights with learned rounding: ``soft=True`` takes the
    differentiable soft target (reconstruction training), ``soft=False`` the
    hard (alpha >= 0) decision."""
    N = 2 ** (bits - 1)
    x_floor = torch.floor(w / scale)
    if soft:
        x_int = x_floor + adaround_soft_targets(alpha)
    else:
        x_int = x_floor + (alpha >= 0).to(w.dtype)
    if symmetric:
        return torch.clamp(x_int, -N, N - 1) * scale
    x_q = torch.clamp(x_int + zero_point, 0, 2 * N - 1)
    return (x_q - zero_point) * scale


def adaround_hard_weight(w, scale, alpha):
    """The hard-rounded weight values, without clamping, frozen into the
    model at the end of reconstruction."""
    return (torch.floor(w / scale) + (alpha >= 0).to(w.dtype)) * scale
