"""Straight-through estimators for rounding, floor and ceil.

``x + (f(x) - x).detach()``: the forward value is f(x), the gradient the
identity. ``torch.round`` rounds half to even, as ``jnp.round`` does.
``torch.clamp`` already passes gradient 1 on the closed interval, which is
the convention ``adalog_tpu.quantizers.ste.tclip`` builds by hand, so the
port clamps with ``torch.clamp`` directly.
"""

import torch


def round_ste(x):
    """Round to nearest (ties to even), gradient = identity."""
    return x + (torch.round(x) - x).detach()


def floor_ste(x):
    """Floor, gradient = identity."""
    return x + (torch.floor(x) - x).detach()


def ceil_ste(x):
    """Ceil, gradient = identity."""
    return x + (torch.ceil(x) - x).detach()
