"""Import timm-format pretrained weights into the port's modules.

Reads a torch state_dict (.bin/.pth) or an .npz with the same key names;
the ViT modules' own state_dict keys are timm's, so loading is a key-checked
``load_state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch

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


def load_vit(cfg: ViTConfig, sd: dict) -> VisionTransformer:
    """Build a VisionTransformer from a timm-keyed {key: array} dict. q_norm
    and k_norm LayerNorms are created only when the dict carries them; a
    Linear without a ``.bias`` key is built without bias."""
    qk_norm = "blocks.0.attn.q_norm.weight" in sd
    model = VisionTransformer(cfg, qk_norm=qk_norm, device="meta")
    for name, mod in list(model.named_modules()):
        if isinstance(mod, torch.nn.Linear) and f"{name}.bias" not in sd:
            mod.bias = None
    own = list(model.state_dict())
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"state dict lacks {missing[:4]} "
                       f"({len(missing)} keys missing)")
    model.load_state_dict(
        {k: torch.from_numpy(np.array(sd[k], dtype=np.float32)) for k in own},
        assign=True)
    return model


def load_timm_state_dict(spec, path: str) -> VisionTransformer:
    if spec.family != "vit":
        raise NotImplementedError(
            f"{spec.name}: the Swin family is not ported to PyTorch yet")
    return load_vit(spec.cfg, read_state_dict(path))
