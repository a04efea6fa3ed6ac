"""Model registry: architecture config + eval-preprocessing config per model,
the same specs as ``adalog_tpu.models.zoo``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import torch

from adalog_tpu_torch.models.vit import ViTConfig, vit_init
from adalog_tpu_torch.models.swin import SwinConfig

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str                      # 'vit' | 'swin'
    cfg: Union[ViTConfig, SwinConfig]
    timm_id: str
    mean: Tuple[float, ...] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, ...] = IMAGENET_DEFAULT_STD
    crop_pct: float = 0.9
    interpolation: str = "bicubic"


def _vit(name, timm_id, dim, depth, heads, **kw):
    return ModelSpec(name=name, family="vit", timm_id=timm_id,
                     cfg=ViTConfig(dim=dim, depth=depth, heads=heads), **kw)


def _swin(name, timm_id, embed, depths, heads, **kw):
    img = kw.pop("img_size", 224)
    window = kw.pop("window", 7)
    return ModelSpec(name=name, family="swin", timm_id=timm_id,
                     cfg=SwinConfig(img_size=img, embed_dim=embed,
                                    depths=depths, heads=heads, window=window),
                     **kw)


_INCEPTION = dict(mean=IMAGENET_INCEPTION_MEAN, std=IMAGENET_INCEPTION_STD)

MODEL_ZOO = {
    "vit_tiny": _vit("vit_tiny", "vit_tiny_patch16_224", 192, 12, 3, **_INCEPTION),
    "vit_small": _vit("vit_small", "vit_small_patch16_224", 384, 12, 6, **_INCEPTION),
    "vit_base": _vit("vit_base", "vit_base_patch16_224", 768, 12, 12, **_INCEPTION),
    "vit_large": _vit("vit_large", "vit_large_patch16_224", 1024, 24, 16, **_INCEPTION),
    "deit_tiny": _vit("deit_tiny", "deit_tiny_patch16_224", 192, 12, 3, crop_pct=0.875),
    "deit_small": _vit("deit_small", "deit_small_patch16_224", 384, 12, 6, crop_pct=0.875),
    "deit_base": _vit("deit_base", "deit_base_patch16_224", 768, 12, 12, crop_pct=0.875),
    "swin_tiny": _swin("swin_tiny", "swin_tiny_patch4_window7_224",
                       96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "swin_small": _swin("swin_small", "swin_small_patch4_window7_224",
                        96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "swin_base": _swin("swin_base", "swin_base_patch4_window7_224",
                       128, (2, 2, 18, 2), (4, 8, 16, 32)),
    "swin_base_384": _swin("swin_base_384", "swin_base_patch4_window12_384",
                           128, (2, 2, 18, 2), (4, 8, 16, 32),
                           img_size=384, window=12, crop_pct=1.0),
    # tiny fixtures for tests (no timm counterpart)
    "test_tiny": ModelSpec(
        name="test_tiny", family="vit", timm_id="test_tiny",
        cfg=ViTConfig(img_size=32, patch_size=8, dim=32, depth=2, heads=2,
                      num_classes=10)),
    "test_tiny_swin": ModelSpec(
        name="test_tiny_swin", family="swin", timm_id="test_tiny_swin",
        cfg=SwinConfig(img_size=32, patch_size=4, embed_dim=16,
                       depths=(1, 2), heads=(2, 4), window=4,
                       num_classes=10)),
}


def model_spec(name: str) -> ModelSpec:
    if name not in MODEL_ZOO:
        raise KeyError(f"unknown model {name!r}; choices: {sorted(MODEL_ZOO)}")
    return MODEL_ZOO[name]


def _require_vit(spec: ModelSpec):
    if spec.family != "vit":
        raise NotImplementedError(
            f"{spec.name}: the Swin family is not ported to PyTorch yet")


def build_model(name: str, checkpoint_path: str = None, seed: int = 0,
                device=None):
    """Return (spec, model). Loads a timm-format state dict when a checkpoint
    path is given, otherwise initializes randomly from ``seed``."""
    spec = model_spec(name)
    _require_vit(spec)
    if checkpoint_path is not None:
        from adalog_tpu_torch.models.load import load_timm_state_dict
        model = load_timm_state_dict(spec, checkpoint_path).to(device)
    else:
        model = vit_init(spec.cfg, torch.Generator().manual_seed(seed),
                         device=device)
    return spec, model


def model_forward_fn(spec: ModelSpec):
    _require_vit(spec)
    from adalog_tpu_torch.models.vit import vit_forward
    return vit_forward
