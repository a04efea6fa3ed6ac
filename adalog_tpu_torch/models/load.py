"""Import timm-format pretrained weights into the port's modules.

Reads a torch state_dict (.bin/.pth) or an .npz with the same key names;
the modules' own state_dict keys are timm's, so loading is a key-checked
``load_state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch

from adalog_tpu_torch.models.eva import EvaConfig, EvaTransformer
from adalog_tpu_torch.models.swin import SwinConfig, SwinTransformer
from adalog_tpu_torch.models.vit import ViTConfig, VisionTransformer


def read_state_dict(path: str) -> dict:
    """Load {key: np.ndarray} from .pth/.bin (torch) or .npz (numpy)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]  # deit official checkpoints nest under 'model'
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def _fill(model, sd: dict):
    """Load the timm-keyed {key: array} dict into a module built on the meta
    device. A Linear without a ``.bias`` key loses its bias, one with a key
    gains it; extra keys are ignored, missing ones raise."""
    for name, mod in list(model.named_modules()):
        if not isinstance(mod, torch.nn.Linear):
            continue
        if f"{name}.bias" not in sd:
            mod.bias = None
        elif mod.bias is None:
            mod.bias = torch.nn.Parameter(
                torch.empty(mod.out_features, device="meta"))
    own = list(model.state_dict())
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"state dict lacks {missing[:4]} "
                       f"({len(missing)} keys missing)")
    model.load_state_dict(
        {k: torch.from_numpy(np.array(sd[k], dtype=np.float32)) for k in own},
        assign=True)
    return model


def load_vit(cfg: ViTConfig, sd: dict) -> VisionTransformer:
    """Build a VisionTransformer from a timm-keyed {key: array} dict. q_norm
    and k_norm LayerNorms are created only when the dict carries them; a
    Linear without a ``.bias`` key is built without bias."""
    qk_norm = "blocks.0.attn.q_norm.weight" in sd
    return _fill(VisionTransformer(cfg, qk_norm=qk_norm, device="meta"), sd)


def load_swin(cfg: SwinConfig, sd: dict) -> SwinTransformer:
    """Build a SwinTransformer from a timm-keyed {key: array} dict. Stage i
    starts with a PatchMerging where the dict has
    ``layers.{i}.downsample.*`` (timm 0.9.2: every stage but the first);
    the classifier is ``head.fc`` or, in older files, ``head``; a
    ``reduction`` has a bias only where the dict carries one (the LayerNorm
    reparam adds it)."""
    downsample = [f"layers.{i}.downsample.reduction.weight" in sd
                  for i in range(len(cfg.depths))]
    if "head.fc.weight" not in sd and "head.weight" in sd:
        sd = dict(sd)
        for leaf in ("weight", "bias"):
            if f"head.{leaf}" in sd:
                sd[f"head.fc.{leaf}"] = sd[f"head.{leaf}"]
    return _fill(SwinTransformer(cfg, downsample, device="meta"), sd)


def load_eva(cfg: EvaConfig, sd: dict) -> EvaTransformer:
    """Build an EvaTransformer from a {key: array} dict in timm's layout
    (``q_proj`` / ``k_proj`` / ``v_proj``, or the fused ``qkv`` with
    ``q_bias`` / ``v_bias``; ``fc1_g`` / ``fc1_x``) or the module's own. The
    model's ``load_state_dict`` maps timm's keys (``eva.from_timm_keys``);
    a key missing after that, or one left over, raises."""
    model = EvaTransformer(cfg, device="meta")
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in sd.items()}, assign=True)
    return model


def load_state_dict(spec, sd: dict):
    """The model of ``spec`` from a timm-keyed {key: array} dict."""
    if spec.family == "vit":
        return load_vit(spec.cfg, sd)
    if spec.family == "eva":
        return load_eva(spec.cfg, sd)
    return load_swin(spec.cfg, sd)


def load_timm_state_dict(spec, path: str):
    return load_state_dict(spec, read_state_dict(path))
