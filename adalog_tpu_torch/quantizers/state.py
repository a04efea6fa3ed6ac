"""Quantizer state: plain dataclasses of tensors.

Class and field names are those of ``adalog_tpu.quantizers.state``, so a v2
checkpoint's schema names them the same way in both packages. ``kind``,
``bits``, ``symmetric`` and ``shifted`` are plain Python values; every other
field is a tensor or None.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

# |min(GeLU)|: the shift applied to post-GeLU activations so the log
# quantizers see non-negative inputs
GELU_MIN = 0.16997124254703522


@dataclass
class QuantizerState:
    """One activation quantizer's parameters.

    kind:      'uniform' | 'twin' | 'log2' | 'logsqrt2' | 'adalog'
    bits:      bit width; 32 means identity
    symmetric: uniform only
    shifted:   quantize (x + shift) and subtract the shift back until it has
               been folded into the consumer's bias
    scale:     broadcastable against x; twin packs (pos, neg) along axis 0
    zero_point: asymmetric uniform only
    log_q:     AdaLog integer base numerator q (r is fixed at 37)
    bias_reparamed: 0/1 flag; when 1 the shift subtraction is skipped
    """

    scale: torch.Tensor
    zero_point: Optional[torch.Tensor] = None
    shift: Optional[torch.Tensor] = None
    log_q: Optional[torch.Tensor] = None
    bias_reparamed: Optional[torch.Tensor] = None
    kind: str = "uniform"
    bits: int = 8
    symmetric: bool = False
    shifted: bool = False


@dataclass
class WeightQuantizerState:
    """One weight quantizer's parameters, broadcast against the viewed weight:
    linear (n_V, rows, 1) against (n_V, rows, in); conv (oc, 1) against
    (oc, ic*kh*kw). ``alpha`` is the AdaRound rounding logit, or None."""

    scale: torch.Tensor
    zero_point: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None
    bits: int = 8
    symmetric: bool = False


def map_tensors(fn, tree):
    """Apply ``fn`` to every tensor in a tree of dataclasses, dicts, lists and
    tuples; other leaves are returned as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree

