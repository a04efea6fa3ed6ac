"""Quantization layout: which sites exist, their quantizer kinds and bit
widths, and (for reparameterized sites) which LayerNorm they fold into.

The same rules as ``adalog_tpu.calib.layout``:
  - head Linears use qhead_a_bit
  - fused qkv uses n_V=3 row groups
  - qkv/fc1 get channel-wise + LayerNorm reparam when a_bit == w_bit and
    calibrating fresh
  - fc2 uses the post-GeLU quantizer from cfg
  - matmul2 uses the post-softmax quantizer at s_bit
  - the patch-embed conv uses qconv_a_bit
Only the ViT layout is ported; the Swin layout comes with the Swin forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from adalog_tpu_torch.utils.config import Config


@dataclass(frozen=True)
class SiteSpec:
    kind: str            # 'conv' | 'linear' | 'linear_reparam' | 'postgelu'
                         # | 'postgelu_twin' | 'matmul' | 'matmul_post'
    w_bits: int = 8
    a_bits: int = 8      # for matmul sites: the B-operand bits
    s_bits: int = 8      # matmul_post A-operand bits
    n_V: int = 1
    heads: int = 0
    param_path: Tuple = ()
    norm_path: Optional[Tuple] = None      # LayerNorm folded by reparam
    post_quantizer: str = "adalog"         # adalog | log2 | logsqrt2 | ptq4vit


def _linear_kind(name: str, cfg: Config, reparam: bool, a_bits: int) -> str:
    if any(t in name for t in ("qkv", "reduction", "fc1")) and \
            a_bits == cfg.w_bit and reparam:
        return "linear_reparam"
    if "fc2" in name and cfg.post_gelu_quantizer in (
            "adalog", "log2", "logsqrt2", "ptq4vit"):
        return "postgelu_twin" if cfg.post_gelu_quantizer == "ptq4vit" \
            else "postgelu"
    return "linear"


def vit_layout(spec, cfg: Config, reparam: bool = True):
    m = spec.cfg
    sites = {}
    sites["patch_embed.proj"] = SiteSpec(
        kind="conv", w_bits=cfg.w_bit, a_bits=cfg.qconv_a_bit,
        param_path=("patch_embed", "proj"))
    for i in range(m.depth):
        p = f"blocks.{i}"
        pp = ("blocks", i)
        sites[f"{p}.attn.qkv"] = SiteSpec(
            kind=_linear_kind("qkv", cfg, reparam, cfg.a_bit),
            w_bits=cfg.w_bit, a_bits=cfg.a_bit, n_V=3,
            param_path=pp + ("attn", "qkv"), norm_path=pp + ("norm1",))
        sites[f"{p}.attn.proj"] = SiteSpec(
            kind="linear", w_bits=cfg.w_bit, a_bits=cfg.a_bit,
            param_path=pp + ("attn", "proj"))
        sites[f"{p}.attn.matmul1"] = SiteSpec(
            kind="matmul", a_bits=cfg.a_bit, s_bits=cfg.a_bit, heads=m.heads,
            param_path=())
        sites[f"{p}.attn.matmul2"] = SiteSpec(
            kind="matmul_post", a_bits=cfg.a_bit, s_bits=cfg.s_bit,
            heads=m.heads, param_path=(),
            post_quantizer=cfg.post_softmax_quantizer)
        sites[f"{p}.mlp.fc1"] = SiteSpec(
            kind=_linear_kind("fc1", cfg, reparam, cfg.a_bit),
            w_bits=cfg.w_bit, a_bits=cfg.a_bit,
            param_path=pp + ("mlp", "fc1"), norm_path=pp + ("norm2",))
        sites[f"{p}.mlp.fc2"] = SiteSpec(
            kind=_linear_kind("fc2", cfg, reparam, cfg.a_bit),
            w_bits=cfg.w_bit, a_bits=cfg.a_bit,
            param_path=pp + ("mlp", "fc2"),
            post_quantizer=cfg.post_gelu_quantizer)
    sites["head"] = SiteSpec(
        kind="linear", w_bits=cfg.w_bit, a_bits=cfg.qhead_a_bit,
        param_path=("head",))
    return sites


def quant_layout(spec, cfg: Config, reparam: bool = True):
    if spec.family != "vit":
        raise NotImplementedError(
            "the Swin layout is not ported to PyTorch yet")
    return vit_layout(spec, cfg, reparam)


def tree_get(obj, path):
    """Follow ``path`` (attribute names and integer indices) into a module."""
    for p in path:
        obj = obj[p] if isinstance(p, int) else getattr(obj, p)
    return obj
