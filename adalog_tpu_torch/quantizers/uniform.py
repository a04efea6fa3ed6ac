"""Uniform (affine) fake quantization as plain functions on tensors.

  - symmetric:  q = clamp(round(x/s), -N, N-1);           dq = q*s
  - asymmetric: q = clamp(round(x/s) + round(zp), 0, 2N-1); dq = (q - round(zp))*s
  - twin (PTQ4ViT): separate positive/negative scales summed.
  - 32 bits => identity.
with N = 2**(bits-1). ``training=True`` rounds with the straight-through
estimator so gradients reach x and the scale.
"""

import torch

from adalog_tpu_torch.quantizers.ste import round_ste


def n_levels(bits: int) -> int:
    return 2 ** (bits - 1)


def uniform_quant(x, scale, zero_point=None, *, bits: int, symmetric: bool,
                  training: bool = False):
    """Fake-quantize ``x``; scale/zero_point broadcast against x."""
    if bits == 32:
        return x
    N = n_levels(bits)
    rnd = round_ste if training else torch.round
    x_int = rnd(x / scale)
    if symmetric:
        return torch.clamp(x_int, -N, N - 1) * scale
    zp = round_ste(zero_point)
    x_q = torch.clamp(x_int + zp, 0, 2 * N - 1)
    return (x_q - zp) * scale


def twin_uniform_quant(x, scale_pos, scale_neg, *, bits: int,
                       training: bool = False):
    """Twin-range quantizer for post-GeLU activations: the positive half on
    [0, N-1] steps of ``scale_pos``, the negative half on [-N, 0] steps of
    ``scale_neg``, summed."""
    if bits == 32:
        return x
    N = n_levels(bits)
    rnd = round_ste if training else torch.round
    x_pos = torch.clamp(rnd(x / scale_pos), 0, N - 1) * scale_pos
    x_neg = torch.clamp(rnd(x / scale_neg), -N, 0) * scale_neg
    return x_pos + x_neg
