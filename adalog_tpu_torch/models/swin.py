"""Swin Transformer (v1) configuration.

Only the configuration is ported so far, so the zoo can list every Swin
spec; ``zoo.build_model`` and the checkpoint loaders raise
``NotImplementedError`` for the Swin family until its forward is ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class SwinConfig:
    img_size: int = 224
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    in_chans: int = 3
