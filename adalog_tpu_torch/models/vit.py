"""ViT / DeiT: parameters in nn.Modules, the forward as plain functions.

The modules hold parameters only; their ``state_dict()`` keys are timm's
(``patch_embed.proj.weight``, ``blocks.{i}.attn.qkv.bias``, ...), which are
also the quant-site names:

    patch_embed.proj, blocks.{i}.attn.qkv, blocks.{i}.attn.matmul1,
    blocks.{i}.attn.matmul2, blocks.{i}.attn.proj, blocks.{i}.mlp.fc1,
    blocks.{i}.mlp.fc2, head

Attention: attn = (q @ kᵀ) * head_dim**-0.5, softmax in FP, then attn @ v;
the scale multiply comes after the first quantized matmul.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from adalog_tpu_torch.models.layers import (
    qlinear, qconv2d, qmatmul, layer_norm, gelu,
)
from adalog_tpu_torch.ops import fq_attn


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    dim: int = 384
    depth: int = 12
    heads: int = 6
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    in_chans: int = 3

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.dim, cfg.patch_size,
                              stride=cfg.patch_size, device=device)


class Attention(nn.Module):
    """qkv/proj Linears; q_norm/k_norm are LayerNorms when a checkpoint
    carries them, else None (identity, as in every zoo model)."""

    def __init__(self, cfg: ViTConfig, qk_norm: bool = False, device=None):
        super().__init__()
        D = cfg.dim
        self.qkv = nn.Linear(D, 3 * D, device=device)
        self.proj = nn.Linear(D, D, device=device)
        self.q_norm = nn.LayerNorm(cfg.head_dim, eps=1e-6, device=device) \
            if qk_norm else None
        self.k_norm = nn.LayerNorm(cfg.head_dim, eps=1e-6, device=device) \
            if qk_norm else None


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        hidden = int(cfg.dim * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, cfg.dim, device=device)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, qk_norm: bool = False, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.dim, eps=1e-6, device=device)
        self.attn = Attention(cfg, qk_norm, device=device)
        self.norm2 = nn.LayerNorm(cfg.dim, eps=1e-6, device=device)
        self.mlp = Mlp(cfg, device=device)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, qk_norm: bool = False, device=None):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg, device=device)
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, cfg.dim, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, cfg.dim, device=device))
        self.blocks = nn.ModuleList(
            Block(cfg, qk_norm, device=device) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6, device=device)
        self.head = nn.Linear(cfg.dim, cfg.num_classes, device=device)


def mode_of(modes, name: str) -> str:
    if modes is None:
        return "raw"
    return modes.get(name, modes.get("*", "raw"))


def site_of(qstate, name: str):
    return None if qstate is None else qstate.get(name)


def _tap(taps, name, *tensors):
    if taps is not None:
        taps[name] = tensors


def vit_attention(cfg: ViTConfig, ap: Attention, qstate, prefix: str, x,
                  modes, taps, *, training: bool = False, soft: bool = False):
    B, N, C = x.shape
    hd = cfg.head_dim

    nm = f"{prefix}.qkv"
    qkv = qlinear(ap.qkv, site_of(qstate, nm), x, mode=mode_of(modes, nm),
                  training=training, soft=soft, name=nm)
    _tap(taps, nm, x, qkv)
    H = qkv.shape[-1] // (3 * hd)
    qkv = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q if ap.q_norm is None else layer_norm(ap.q_norm, q)
    k = k if ap.k_norm is None else layer_norm(ap.k_norm, k)

    nm = f"{prefix}.matmul1"
    kT = k.transpose(-2, -1)
    m1_site, m1_mode = site_of(qstate, nm), mode_of(modes, nm)
    nm2 = f"{prefix}.matmul2"
    m2_site, m2_mode = site_of(qstate, nm2), mode_of(modes, nm2)

    out = attn = None
    # no kernel in training (block reconstruction differentiates the plain
    # ops)
    fused = taps is None and not training
    if fused and fq_attn.supports_flash(m1_site, m2_site, m1_mode, m2_mode):
        # the whole quantized attention, uq(q) @ uq(kT) -> scale -> softmax
        # -> AdaLog -> @ uq(v), in one kernel: the (B, H, N, N) logits never
        # reach device memory
        out = fq_attn.run_flash(m1_site, m2_site, q, kT, v,
                                logit_scale=hd ** -0.5)
    if out is None:
        attn = qmatmul(m1_site, q, kT, mode=m1_mode, training=training)
        _tap(taps, nm, q, kT, attn)
        attn = attn * (hd ** -0.5)
        if fused and m2_site is not None \
                and fq_attn.supports_softmax(m2_site, m2_mode):
            # partial fast path: softmax, AdaLog and the product with uq(v)
            # fused; the logits are still a device-memory operand
            out = fq_attn.run_softmax(m2_site, attn, v)
            attn = None
    if attn is not None:
        attn = torch.softmax(attn, dim=-1)
        out = qmatmul(m2_site, attn, v, mode=m2_mode, training=training)
        _tap(taps, nm2, attn, v, out)
    out = out.transpose(1, 2).reshape(B, N, H * hd)

    nm = f"{prefix}.proj"
    y = qlinear(ap.proj, site_of(qstate, nm), out, mode=mode_of(modes, nm),
                training=training, soft=soft, name=nm)
    _tap(taps, nm, out, y)
    return y


def vit_mlp(mp: Mlp, qstate, prefix: str, x, modes, taps, *,
            training: bool = False, soft: bool = False):
    nm = f"{prefix}.fc1"
    h = qlinear(mp.fc1, site_of(qstate, nm), x, mode=mode_of(modes, nm),
                training=training, soft=soft, name=nm)
    _tap(taps, nm, x, h)
    h = gelu(h)
    nm = f"{prefix}.fc2"
    y = qlinear(mp.fc2, site_of(qstate, nm), h, mode=mode_of(modes, nm),
                training=training, soft=soft, name=nm)
    _tap(taps, nm, h, y)
    return y


def vit_block(cfg: ViTConfig, bp: Block, qstate, prefix: str, x, modes, taps,
              *, training: bool = False, soft: bool = False):
    """Pre-norm transformer block; also a block-reconstruction unit."""
    x = x + vit_attention(cfg, bp.attn, qstate, f"{prefix}.attn",
                          layer_norm(bp.norm1, x), modes, taps,
                          training=training, soft=soft)
    x = x + vit_mlp(bp.mlp, qstate, f"{prefix}.mlp",
                    layer_norm(bp.norm2, x), modes, taps,
                    training=training, soft=soft)
    return x


def vit_patch_embed(cfg: ViTConfig, params: VisionTransformer, qstate, x,
                    modes, taps, *, training: bool = False,
                    soft: bool = False):
    """Image (B, H, W, 3) -> tokens (B, N, D). Reconstruction unit
    'patch_embed'."""
    nm = "patch_embed.proj"
    y = qconv2d(params.patch_embed.proj, site_of(qstate, nm), x,
                mode=mode_of(modes, nm), training=training, soft=soft)
    _tap(taps, nm, x, y)
    return y.reshape(y.shape[0], cfg.num_patches, cfg.dim)


def vit_head(cfg: ViTConfig, params: VisionTransformer, qstate, x, modes,
             taps, *, training: bool = False, soft: bool = False):
    """Pooled feature -> logits. Reconstruction unit 'head'."""
    nm = "head"
    y = qlinear(params.head, site_of(qstate, nm), x, mode=mode_of(modes, nm),
                training=training, soft=soft, name=nm)
    _tap(taps, nm, x, y)
    return y


def vit_forward(cfg: ViTConfig, params: VisionTransformer, x, qstate=None,
                modes=None, *, capture: bool = False,
                capture_blocks: bool = False, training: bool = False,
                soft: bool = False):
    """Full forward. x: (B, H, W, 3) NHWC.

    Returns logits, or (logits, taps) when capture/capture_blocks is set.
    taps[site] = (*inputs, output); taps['blocks.{i}'] = (block_in, block_out).
    """
    taps = {} if (capture or capture_blocks) else None
    site_taps = taps if capture else None

    tok = vit_patch_embed(cfg, params, qstate, x, modes, site_taps,
                          training=training, soft=soft)
    if capture_blocks:
        taps["patch_embed"] = (x, tok)
    B = tok.shape[0]
    cls = params.cls_token.expand(B, 1, cfg.dim)
    h = torch.cat([cls, tok], dim=1) + params.pos_embed

    for i, bp in enumerate(params.blocks):
        h_in = h
        h = vit_block(cfg, bp, qstate, f"blocks.{i}", h, modes, site_taps,
                      training=training, soft=soft)
        if capture_blocks:
            taps[f"blocks.{i}"] = (h_in, h)

    h = layer_norm(params.norm, h)
    pooled = h[:, 0]
    logits = vit_head(cfg, params, qstate, pooled, modes, site_taps,
                      training=training, soft=soft)
    if capture_blocks:
        taps["head"] = (pooled, logits)
    if taps is not None:
        return logits, taps
    return logits


def vit_init(cfg: ViTConfig, generator: torch.Generator,
             device=None) -> VisionTransformer:
    """Random init (normal * 0.02 weights, zero biases, unit LayerNorms) from
    an explicit generator; for tests and pipeline benchmarking when no
    pretrained checkpoint is available."""
    model = VisionTransformer(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".norm" in name or name.startswith("norm"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
    return model
