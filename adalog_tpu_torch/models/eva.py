"""EVA-02 (timm's eva.py, as ``eva02_large_patch14_448`` builds it):
parameters in nn.Modules, the forward as plain functions, as ``vit.py``.

A patch convolution, a class token and learned positions, then pre-norm
blocks of attention with 2D rotary position embedding (RoPE) on the patch
tokens' q and k, and a SwiGLU MLP with a LayerNorm on the gated product
before fc2 (timm's ``scale_mlp``, "sub-LN"); the patch tokens' mean
through ``fc_norm`` into the head (timm's ``norm`` is Identity then).

Two departures from a module-per-Linear wrapping, both where an input is
shared: timm's separate q, k and v projections are one Linear of 3 * dim
outputs (q, k, v in that order; k has no bias in timm, so its third of the
bias is 0), and the gate and value projections of the MLP (``fc1_g``,
``fc1_x``) one of 2 * hidden, gate first (timm's ``GluMlp(gate_last=
False)`` packing). Each is one quantization site with one activation
quantizer, as ViT's fused qkv is. The model's ``load_state_dict``, which
``models/load.py`` calls, takes timm's keys (either of its layouts) and
maps them onto these (``from_timm_keys``). The module's keys, and the site
names:

    patch_embed.proj, blocks.{i}.attn.qkv, blocks.{i}.attn.matmul1,
    blocks.{i}.attn.matmul2, blocks.{i}.attn.proj, blocks.{i}.mlp.fc1,
    blocks.{i}.mlp.norm, blocks.{i}.mlp.fc2, fc_norm, head

fc2's input is a LayerNorm output, not a GeLU output: it is a uniform
site, and the family has no post-GeLU site.

RoPE (timm's ``RotaryEmbeddingCat`` with ``ref_feat_shape``): head dim hd,
n = hd / 4 bands an axis, f_m = 10000^(-m / n); patch p at row r, column c
of the g x g grid turns the pair (2j, 2j+1) of its q and k by a_j = r *
ref / g * f_j for j < n and c * ref / g * f_(j-n) for j >= n:

    out[2j]   = x[2j] cos a_j - x[2j+1] sin a_j
    out[2j+1] = x[2j+1] cos a_j + x[2j] sin a_j

The class token is not turned.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from adalog_tpu_torch.models.layers import (
    _tap, layer_norm, qconv2d, qlinear, quant_attention,
)
from adalog_tpu_torch.models.vit import mode_of, site_of
from adalog_tpu_torch.ops import fq_attn
from adalog_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class EvaConfig:
    img_size: int = 448
    patch_size: int = 14
    dim: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_hidden: int = 2730          # int(dim * 8 / 3)
    rope_grid: int = 16             # timm's ref_feat_shape, square
    num_classes: int = 1000
    in_chans: int = 3

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


class PatchEmbed(nn.Module):
    def __init__(self, cfg: EvaConfig, device=None):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.dim, cfg.patch_size,
                              stride=cfg.patch_size, device=device)


class Attention(nn.Module):
    def __init__(self, cfg: EvaConfig, device=None):
        super().__init__()
        self.qkv = nn.Linear(cfg.dim, 3 * cfg.dim, device=device)
        self.proj = nn.Linear(cfg.dim, cfg.dim, device=device)


class SwiGLU(nn.Module):
    def __init__(self, cfg: EvaConfig, device=None):
        super().__init__()
        hid = cfg.mlp_hidden
        self.fc1 = nn.Linear(cfg.dim, 2 * hid, device=device)
        self.norm = nn.LayerNorm(hid, eps=1e-6, device=device)
        self.fc2 = nn.Linear(hid, cfg.dim, device=device)


class Block(nn.Module):
    def __init__(self, cfg: EvaConfig, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.dim, eps=1e-6, device=device)
        self.attn = Attention(cfg, device=device)
        self.norm2 = nn.LayerNorm(cfg.dim, eps=1e-6, device=device)
        self.mlp = SwiGLU(cfg, device=device)


class EvaTransformer(nn.Module):
    def __init__(self, cfg: EvaConfig, device=None):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg, device=device)
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, cfg.dim, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, cfg.dim, device=device))
        self.blocks = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.depth))
        self.fc_norm = nn.LayerNorm(cfg.dim, eps=1e-6, device=device)
        self.head = nn.Linear(cfg.dim, cfg.num_classes, device=device)
        # a plain function, not bound to the module: deep copies keep it
        self._register_load_state_dict_pre_hook(_timm_keys_hook)


def _timm_keys_hook(state_dict, prefix, *_):
    """``load_state_dict`` of a whole model takes timm's keys too."""
    if prefix == "":
        mapped = from_timm_keys(state_dict)
        state_dict.clear()
        state_dict.update(mapped)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(cfg: EvaConfig, device=None) -> torch.Tensor:
    """(num_patches, head_dim / 2) float64: a_j of each patch (row-major)
    and pair j."""
    n = cfg.head_dim // 4
    f = 10000.0 ** (-torch.arange(n, dtype=torch.float64, device=device) / n)
    pos = torch.arange(cfg.grid, dtype=torch.float64, device=device) \
        * (cfg.rope_grid / cfg.grid)
    r = pos.repeat_interleave(cfg.grid)           # row of patch p
    c = pos.repeat(cfg.grid)                      # its column
    return torch.cat([r[:, None] * f, c[:, None] * f], dim=1)


_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def rope_tables(cfg: EvaConfig, device=None, dtype=torch.float32):
    """What ``apply_rope`` takes for inputs of ``dtype``, from float64
    angles: for float32 and float64 the turns e^(i a_j) as complex numbers
    (num_patches, head_dim / 2); for other dtypes (cos, sin), each
    (num_patches, head_dim), pair j's at columns 2j and 2j+1."""
    a = rope_angles(cfg, device)
    if dtype in _COMPLEX:
        return torch.polar(torch.ones_like(a), a).to(_COMPLEX[dtype])
    return (torch.cos(a).repeat_interleave(2, dim=1).to(dtype),
            torch.sin(a).repeat_interleave(2, dim=1).to(dtype))


def apply_rope(x, rope):
    """Turn the patch tokens of x (..., 1 + num_patches, hd) pair by pair
    by ``rope_tables``; the class token (token 0) is left as it is. Returns
    a new contiguous tensor. In float32 and float64 each pair is one
    complex number, (x[2j] + i x[2j+1]) e^(i a_j): one pass over x,
    written in place of the result where no gradient is taken (an ``out=``
    product is not differentiable)."""
    t = x[..., 1:, :]
    if torch.is_tensor(rope):
        def pairs(a):
            return torch.view_as_complex(a.unflatten(-1, (-1, 2)))
        if torch.is_grad_enabled() and x.requires_grad:
            turned = torch.view_as_real(pairs(t) * rope).flatten(-2)
            return torch.cat([x[..., :1, :], turned], dim=-2)
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        out[..., :1, :] = x[..., :1, :]
        torch.mul(pairs(t), rope, out=pairs(out[..., 1:, :]))
        return out
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out[..., :1, :] = x[..., :1, :]
    cos, sin = rope
    p = t.unflatten(-1, (-1, 2))
    turned = torch.stack([-p[..., 1], p[..., 0]], dim=-1).flatten(-2)
    out[..., 1:, :] = t * cos + turned * sin
    return out


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------

def eva_attention(cfg: EvaConfig, ap: Attention, qstate, prefix: str, x,
                  rope, modes, taps, *, training: bool = False,
                  soft: bool = False):
    B, N, C = x.shape
    hd = cfg.head_dim

    nm = f"{prefix}.qkv"
    qkv = qlinear(ap.qkv, site_of(qstate, nm), x, mode=mode_of(modes, nm),
                  training=training, soft=soft, name=nm)
    _tap(taps, nm, x, qkv)
    with span("attn"):
        H = qkv.shape[-1] // (3 * hd)
        qkv = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        with span("eva.rope"):
            q = apply_rope(q, rope)
            k = apply_rope(k, rope)

        # K1 takes a row past 256 tokens in two passes (its long row)
        nm, nm2 = f"{prefix}.matmul1", f"{prefix}.matmul2"
        out = quant_attention(
            q, k.transpose(-2, -1), v, site_of(qstate, nm),
            site_of(qstate, nm2), mode_of(modes, nm), mode_of(modes, nm2),
            taps, (nm, nm2), training=training, logit_scale=hd ** -0.5,
            run_flash=fq_attn.run_flash)
        out = out.transpose(1, 2).reshape(B, N, H * hd)

    nm = f"{prefix}.proj"
    y = qlinear(ap.proj, site_of(qstate, nm), out, mode=mode_of(modes, nm),
                training=training, soft=soft, name=nm)
    _tap(taps, nm, out, y)
    return y


def eva_mlp(mp: SwiGLU, qstate, prefix: str, x, modes, taps, *,
            training: bool = False, soft: bool = False):
    nm = f"{prefix}.fc1"
    h = qlinear(mp.fc1, site_of(qstate, nm), x, mode=mode_of(modes, nm),
                training=training, soft=soft, name=nm)
    _tap(taps, nm, x, h)
    with span("eva.glu"):
        g, u = h.chunk(2, dim=-1)
        h = F.silu(g) * u
    h = layer_norm(mp.norm, h, training=training)
    nm = f"{prefix}.fc2"
    y = qlinear(mp.fc2, site_of(qstate, nm), h, mode=mode_of(modes, nm),
                training=training, soft=soft, name=nm)
    _tap(taps, nm, h, y)
    return y


def eva_block(cfg: EvaConfig, bp: Block, qstate, prefix: str, x, modes, taps,
              *, rope=None, training: bool = False, soft: bool = False):
    """Pre-norm block; also a block-reconstruction unit. ``rope`` is
    ``rope_tables`` for x's device and dtype (made here when None)."""
    if rope is None:
        rope = rope_tables(cfg, x.device, x.dtype)
    x = x + eva_attention(cfg, bp.attn, qstate, f"{prefix}.attn",
                          layer_norm(bp.norm1, x, training=training), rope,
                          modes, taps, training=training, soft=soft)
    x = x + eva_mlp(bp.mlp, qstate, f"{prefix}.mlp",
                    layer_norm(bp.norm2, x, training=training), modes, taps,
                    training=training, soft=soft)
    return x


def eva_patch_embed(cfg: EvaConfig, params: EvaTransformer, qstate, x,
                    modes, taps, *, training: bool = False,
                    soft: bool = False):
    """Image (B, H, W, 3) -> tokens (B, N, D). Reconstruction unit
    'patch_embed'."""
    nm = "patch_embed.proj"
    y = qconv2d(params.patch_embed.proj, site_of(qstate, nm), x,
                mode=mode_of(modes, nm), training=training, soft=soft)
    _tap(taps, nm, x, y)
    return y.reshape(y.shape[0], cfg.num_patches, cfg.dim)


def eva_head(cfg: EvaConfig, params: EvaTransformer, qstate, x, modes, taps,
             *, training: bool = False, soft: bool = False):
    """Pooled feature (after ``fc_norm``) -> logits. Reconstruction unit
    'head'."""
    nm = "head"
    y = qlinear(params.head, site_of(qstate, nm), x, mode=mode_of(modes, nm),
                training=training, soft=soft, name=nm)
    _tap(taps, nm, x, y)
    return y


def eva_pool(params: EvaTransformer, h, *, training: bool = False):
    """The patch tokens' mean through ``fc_norm``."""
    return layer_norm(params.fc_norm, h[:, 1:].mean(dim=1),
                      training=training)


def eva_forward(cfg: EvaConfig, params: EvaTransformer, x, qstate=None,
                modes=None, *, capture: bool = False,
                capture_blocks: bool = False, training: bool = False,
                soft: bool = False):
    """Full forward. x: (B, H, W, 3) NHWC. Returns logits, or (logits,
    taps) when capture/capture_blocks is set, as ``vit_forward``."""
    taps = {} if (capture or capture_blocks) else None
    site_taps = taps if capture else None

    tok = eva_patch_embed(cfg, params, qstate, x, modes, site_taps,
                          training=training, soft=soft)
    if capture_blocks:
        taps["patch_embed"] = (x, tok)
    B = tok.shape[0]
    cls = params.cls_token.expand(B, 1, cfg.dim)
    h = torch.cat([cls, tok], dim=1) + params.pos_embed
    with span("eva.rope"):
        rope = rope_tables(cfg, h.device, h.dtype)

    for i, bp in enumerate(params.blocks):
        h_in = h
        h = eva_block(cfg, bp, qstate, f"blocks.{i}", h, modes, site_taps,
                      rope=rope, training=training, soft=soft)
        if capture_blocks:
            taps[f"blocks.{i}"] = (h_in, h)

    pooled = eva_pool(params, h, training=training)
    logits = eva_head(cfg, params, qstate, pooled, modes, site_taps,
                      training=training, soft=soft)
    if capture_blocks:
        taps["head"] = (pooled, logits)
    if taps is not None:
        return logits, taps
    return logits


def eva_init(cfg: EvaConfig, generator: torch.Generator,
             device=None) -> EvaTransformer:
    """Random init (normal * 0.02 weights, zero biases, unit LayerNorms) from
    an explicit generator, as ``vit_init``."""
    model = EvaTransformer(cfg, device=device)
    with torch.no_grad():
        norms = {f"{n}.{leaf}" for n, m in model.named_modules()
                 if isinstance(m, nn.LayerNorm) for leaf in ("weight", "bias")}
        for name, p in model.named_parameters():
            if name in norms:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
    return model


# ---------------------------------------------------------------------------
# timm's keys
# ---------------------------------------------------------------------------

_TIMM_ONLY = (".q_proj.", ".k_proj.", ".v_proj.", ".q_bias", ".k_bias",
              ".v_bias", ".fc1_g.", ".fc1_x.")


def from_timm_keys(sd: dict) -> dict:
    """timm's {key: tensor or array} of an EVA-02 (q_proj / k_proj / v_proj,
    or its fused qkv with q_bias / v_bias; fc1_g / fc1_x, or GluMlp's fc1)
    -> the module's keys: q, k, v stacked in one qkv whose k bias is 0, gate
    then value in one fc1. Keys already in the module's layout pass
    through; timm's own are dropped. Tensors stay on their device."""
    def t(k):
        return torch.as_tensor(sd[k])

    out = {k: v for k, v in sd.items() if not any(m in k for m in _TIMM_ONLY)}
    blocks = sorted({k.split(".")[1] for k in sd if k.startswith("blocks.")},
                    key=int)
    for i in blocks:
        a, m = f"blocks.{i}.attn", f"blocks.{i}.mlp"
        if f"{a}.q_proj.weight" in sd:
            out[f"{a}.qkv.weight"] = torch.cat(
                [t(f"{a}.{n}_proj.weight") for n in "qkv"])
            biases = [f"{a}.{n}_proj.bias" for n in "qkv"]
        else:
            biases = [f"{a}.{n}_bias" for n in "qkv"]
        if f"{a}.qkv.bias" not in sd:
            q = t(biases[0])
            out[f"{a}.qkv.bias"] = torch.cat(
                [t(b) if b in sd else torch.zeros_like(q) for b in biases])
        if f"{m}.fc1_g.weight" in sd:
            for leaf in ("weight", "bias"):
                out[f"{m}.fc1.{leaf}"] = torch.cat(
                    [t(f"{m}.fc1_g.{leaf}"), t(f"{m}.fc1_x.{leaf}")])
    return out
