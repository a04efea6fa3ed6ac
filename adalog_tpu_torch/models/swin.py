"""Swin Transformer (v1): parameters in nn.Modules, the forward as plain
functions, in NHWC layout.

The counterpart of ``adalog_tpu.models.swin``, with timm 0.9.2
swin_transformer semantics:

  patch_embed (conv k4 s4 + LayerNorm) -> 4 stages; stage i>0 starts with
  PatchMerging (2x2 concat -> norm -> reduction Linear 4C->2C, bias-free);
  blocks alternate shift 0 / window//2 (shift disabled when resolution ==
  window); window attention adds a relative-position bias after the first
  quantized matmul and the shifted-window mask before softmax.

Unlike ViT, q is multiplied by head_dim**-0.5 *before* the first quantized
matmul, which changes matmul1's input ranges.

The modules hold parameters only; their ``state_dict()`` keys are timm's
(``layers.{i}.blocks.{j}.attn.qkv.weight``,
``layers.{i}.blocks.{j}.attn.relative_position_bias_table``,
``layers.{i}.downsample.reduction.weight``, ``head.fc.weight``, ...), which
are also the quant-site names (``...attn.matmul1`` and ``...attn.matmul2``
besides). The relative-position table is gathered to its (1, heads, N, N)
bias in the forward; shift masks and the gather index are constants cached
per device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn

from adalog_tpu_torch.models.layers import (
    qlinear, qconv2d, qmatmul, layer_norm, gelu,
)
from adalog_tpu_torch.models.vit import mode_of, site_of, _tap
from adalog_tpu_torch.ops import fq_attn


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

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)

    def stage_res(self, i: int) -> int:
        return self.img_size // self.patch_size // (2 ** i)

    def stage_window(self, i: int) -> int:
        return min(self.window, self.stage_res(i))

    def stage_window_shift(self, i: int, j: int) -> Tuple[int, int]:
        """(window, shift) for block j of stage i; shift disabled when the
        resolution does not exceed the window."""
        res = self.stage_res(i)
        ws = self.stage_window(i)
        shift = 0 if res <= ws else (0 if j % 2 == 0 else ws // 2)
        return ws, shift


# ---------------------------------------------------------------------------
# Modules (parameters only)
# ---------------------------------------------------------------------------

class SwinPatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig, device=None):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size, device=device)
        self.norm = nn.LayerNorm(cfg.embed_dim, device=device)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, device=None):
        super().__init__()
        self.ws = ws
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads, device=device))


class SwinMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, mlp_ratio: float,
                 device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = WindowAttention(dim, heads, ws, device=device)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio), device=device)


class PatchMerging(nn.Module):
    """norm over the 4C concat, then the reduction Linear 4C -> 2C; bias-free
    until the LayerNorm reparam gives it one."""

    def __init__(self, in_dim: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(4 * in_dim, device=device)
        self.reduction = nn.Linear(4 * in_dim, 2 * in_dim, bias=False,
                                   device=device)


class SwinStage(nn.Module):
    def __init__(self, cfg: SwinConfig, i: int, downsample: bool,
                 device=None):
        super().__init__()
        self.downsample = PatchMerging(cfg.stage_dim(i - 1), device=device) \
            if downsample else None
        self.blocks = nn.ModuleList(
            SwinBlock(cfg.stage_dim(i), cfg.heads[i], cfg.stage_window(i),
                      cfg.mlp_ratio, device=device)
            for _ in range(cfg.depths[i]))


class SwinHead(nn.Module):
    def __init__(self, in_dim: int, num_classes: int, device=None):
        super().__init__()
        self.fc = nn.Linear(in_dim, num_classes, device=device)


class SwinTransformer(nn.Module):
    """``downsample[i]`` says whether stage i starts with a PatchMerging
    (default: every stage but the first)."""

    def __init__(self, cfg: SwinConfig, downsample=None, device=None):
        super().__init__()
        n = len(cfg.depths)
        if downsample is None:
            downsample = [i > 0 for i in range(n)]
        self.patch_embed = SwinPatchEmbed(cfg, device=device)
        self.layers = nn.ModuleList(
            SwinStage(cfg, i, downsample[i], device=device)
            for i in range(n))
        self.norm = nn.LayerNorm(cfg.stage_dim(n - 1), device=device)
        self.head = SwinHead(cfg.stage_dim(n - 1), cfg.num_classes,
                             device=device)


# ---------------------------------------------------------------------------
# Static geometry helpers (numpy)
# ---------------------------------------------------------------------------

def relative_position_index(ws: int) -> np.ndarray:
    """Standard Swin relative-position index, (ws*ws, ws*ws) int array."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]        # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)                               # (N, N)


def gather_rel_pos_bias(table: np.ndarray, ws: int) -> np.ndarray:
    """table ((2ws-1)^2, heads) -> (1, heads, N, N)."""
    idx = relative_position_index(ws)
    bias = table[idx.reshape(-1)].reshape(ws * ws, ws * ws, -1)
    return bias.transpose(2, 0, 1)[None]


def ungather_rel_pos_bias(bias: np.ndarray, ws: int) -> np.ndarray:
    """Inverse of gather_rel_pos_bias: (1, H, N, N) -> ((2ws-1)^2, H).

    Every relative offset occurs for at least one (i, j) pair, so scattering
    the gathered bias back through the index recovers the full table exactly.
    """
    idx = relative_position_index(ws).reshape(-1)          # (N*N,)
    H = bias.shape[1]
    flat = np.asarray(bias)[0].reshape(H, -1)              # (H, N*N)
    table = np.zeros(((2 * ws - 1) ** 2, H), np.float32)
    table[idx] = flat.T                                    # later dups identical
    return table


def shift_attn_mask(res: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask (-100 / 0) for shifted windows."""
    img = np.zeros((res, res), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)                   # (nW, N)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# the constants below are cached per (geometry, device, dtype): a handful of
# small tensors per served model, shared read-only by every caller
@functools.lru_cache(maxsize=64)
def _index_tensor(ws: int, device) -> torch.Tensor:
    return torch.from_numpy(relative_position_index(ws).reshape(-1)).to(device)


@functools.lru_cache(maxsize=64)
def _mask_tensor(res: int, ws: int, shift: int, device, dtype) -> torch.Tensor:
    return torch.from_numpy(shift_attn_mask(res, ws, shift)).to(
        device=device, dtype=dtype)


def rel_pos_bias(ap: WindowAttention) -> torch.Tensor:
    """The attention's table gathered to (1, heads, N, N)."""
    table = ap.relative_position_bias_table
    N = ap.ws * ap.ws
    bias = table[_index_tensor(ap.ws, table.device)].reshape(N, N, -1)
    return bias.permute(2, 0, 1)[None]


def block_shift_mask(cfg: SwinConfig, stage: int, blk: int, device, dtype):
    """The (nW, N, N) shift mask of block ``blk`` of ``stage`` on ``device``
    in ``dtype``, or None for an unshifted block."""
    ws, shift = cfg.stage_window_shift(stage, blk)
    if not shift:
        return None
    return _mask_tensor(cfg.stage_res(stage), ws, shift, device, dtype)


def add_window_bias(ap: WindowAttention, attn, mask):
    """(B_, heads, N, N) logits + rel-pos bias (+ shift mask over the nW
    windows of each image): what the softmax of a window attention takes."""
    attn = attn + rel_pos_bias(ap)
    if mask is not None:
        nW, heads, N = mask.shape[0], attn.shape[1], attn.shape[-1]
        attn = attn.reshape(-1, nW, heads, N, N) + mask[None, :, None]
        attn = attn.reshape(-1, heads, N, N)
    return attn


def flash_bias(ap: WindowAttention, mask) -> torch.Tensor:
    """The additive logit bias the fused attention kernel takes, float32:
    the rel-pos bias (heads, N, N), or with a shift mask (nW, N, N) their
    sum flattened to (nW * heads, N, N), heads the fastest axis. The
    attention slices are flattened (B, nW, heads), so slice
    g = (b*nW + w)*heads + h reads row w*heads + h = g % P."""
    bias = rel_pos_bias(ap)[0].float()
    if mask is not None:
        N = bias.shape[-1]
        bias = (bias[None] + mask[:, None].float()).reshape(-1, N, N)
    return bias


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B * nW, ws*ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(x, ws: int, H: int, W: int):
    """(B * nW, ws*ws, C) -> (B, H, W, C)."""
    C = x.shape[-1]
    B = x.shape[0] // ((H // ws) * (W // ws))
    x = x.reshape(B, H // ws, W // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def swin_window_attention(ap: WindowAttention, qstate, prefix: str, x, heads,
                          mask, modes, taps, *, training: bool = False,
                          soft: bool = False):
    """x: (B_, N, C) windows; mask: None or (nW, N, N) constant in x's
    dtype. The same three tiers as ``vit_attention``: K1, then K3 for
    matmul1 with K2 for the rest, then the plain ops (always in
    training)."""
    B_, N, C = x.shape
    hd = C // heads

    nm = f"{prefix}.qkv"
    qkv = qlinear(ap.qkv, site_of(qstate, nm), x, mode=mode_of(modes, nm),
                  training=training, soft=soft, name=nm)
    _tap(taps, nm, x, qkv)
    heads = qkv.shape[-1] // (3 * hd)
    qkv = qkv.reshape(B_, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (hd ** -0.5)

    nm = f"{prefix}.matmul1"
    kT = k.transpose(-2, -1)
    m1_site, m1_mode = site_of(qstate, nm), mode_of(modes, nm)
    nm2 = f"{prefix}.matmul2"
    m2_site, m2_mode = site_of(qstate, nm2), mode_of(modes, nm2)

    out = attn = None
    fused = taps is None and not training
    if fused and fq_attn.supports_flash(m1_site, m2_site, m1_mode, m2_mode):
        # the whole quantized window attention in one kernel; the rel-pos
        # bias (+ shifted-window mask) folds into a (P, N, N) additive logit
        # bias with period P over the flattened (B, nW, heads) slices
        out = fq_attn.run_flash(m1_site, m2_site, q, kT, v, logit_scale=1.0,
                                bias=flash_bias(ap, mask))
    if out is None:
        attn = qmatmul(m1_site, q, kT, mode=m1_mode, training=training)
        _tap(taps, nm, q, kT, attn)
        attn = add_window_bias(ap, attn, mask)
        if fused and m2_site is not None \
                and fq_attn.supports_softmax(m2_site, m2_mode):
            # partial fast path: softmax, AdaLog and the product with uq(v)
            # fused; the logits (carrying bias and mask) are still a
            # device-memory operand
            out = fq_attn.run_softmax(m2_site, attn, v)
            attn = None
    if attn is not None:
        attn = torch.softmax(attn, dim=-1)
        out = qmatmul(m2_site, attn, v, mode=m2_mode, training=training)
        _tap(taps, nm2, attn, v, out)
    out = out.transpose(1, 2).reshape(B_, N, heads * hd)

    nm = f"{prefix}.proj"
    y = qlinear(ap.proj, site_of(qstate, nm), out, mode=mode_of(modes, nm),
                training=training, soft=soft, name=nm)
    _tap(taps, nm, out, y)
    return y


def swin_block(cfg: SwinConfig, bp: SwinBlock, qstate, prefix: str,
               stage: int, blk: int, x, modes, taps, *,
               training: bool = False, soft: bool = False):
    """x: (B, H, W, C). Also a block-reconstruction unit."""
    B, H, W, C = x.shape
    ws, shift = cfg.stage_window_shift(stage, blk)
    heads = cfg.heads[stage]

    shortcut = x
    h = layer_norm(bp.norm1, x)
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    win = window_partition(h, ws)
    # the mask in the compute dtype, so a bf16 forward stays bf16
    mask = block_shift_mask(cfg, stage, blk, x.device, x.dtype)
    win = swin_window_attention(bp.attn, qstate, f"{prefix}.attn", win, heads,
                                mask, modes, taps, training=training,
                                soft=soft)
    h = window_reverse(win, ws, H, W)
    if shift:
        h = torch.roll(h, (shift, shift), dims=(1, 2))
    x = shortcut + h

    h = layer_norm(bp.norm2, x)
    nm = f"{prefix}.mlp.fc1"
    m = qlinear(bp.mlp.fc1, site_of(qstate, nm), h, mode=mode_of(modes, nm),
                training=training, soft=soft, name=nm)
    _tap(taps, nm, h, m)
    m = gelu(m)
    nm = f"{prefix}.mlp.fc2"
    m2 = qlinear(bp.mlp.fc2, site_of(qstate, nm), m, mode=mode_of(modes, nm),
                 training=training, soft=soft, name=nm)
    _tap(taps, nm, m, m2)
    return x + m2


def patch_merging(pm: PatchMerging, qstate, prefix: str, x, modes, taps, *,
                  training: bool = False, soft: bool = False):
    """(B, H, W, C) -> (B, H/2, W/2, 2C). Also a reconstruction unit.

    The 2x2 neighbour concat order is timm 0.9.2's: channel blocks
    [x(0,0), x(1,0), x(0,1), x(1,1)] by (row, col) offsets."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    x = x.permute(0, 1, 3, 4, 2, 5)                  # (B, H2, W2, sw, sh, C)
    x = x.reshape(B, H // 2, W // 2, 4 * C)
    x = layer_norm(pm.norm, x)
    nm = f"{prefix}.reduction"
    y = qlinear(pm.reduction, site_of(qstate, nm), x, mode=mode_of(modes, nm),
                training=training, soft=soft, name=nm)
    _tap(taps, nm, x, y)
    return y


def swin_patch_embed(cfg: SwinConfig, params: SwinTransformer, qstate, x,
                     modes, taps, *, training: bool = False,
                     soft: bool = False):
    """Image (B, H, W, 3) -> (B, H/4, W/4, C). Reconstruction unit
    'patch_embed'."""
    nm = "patch_embed.proj"
    y = qconv2d(params.patch_embed.proj, site_of(qstate, nm), x,
                mode=mode_of(modes, nm), training=training, soft=soft)
    _tap(taps, nm, x, y)
    return layer_norm(params.patch_embed.norm, y)


def swin_head(params: SwinTransformer, qstate, x, modes, taps, *,
              training: bool = False, soft: bool = False):
    """Post-norm NHWC feature -> logits (average pool, then fc).
    Reconstruction unit 'head'."""
    pooled = torch.mean(x, dim=(1, 2))
    nm = "head.fc"
    y = qlinear(params.head.fc, site_of(qstate, nm), pooled,
                mode=mode_of(modes, nm), training=training, soft=soft,
                name=nm)
    _tap(taps, nm, pooled, y)
    return y


def swin_forward(cfg: SwinConfig, params: SwinTransformer, x, qstate=None,
                 modes=None, *, capture: bool = False,
                 capture_blocks: bool = False, training: bool = False,
                 soft: bool = False):
    """Full forward. x: (B, H, W, 3) NHWC.

    Returns logits, or (logits, taps) when capture/capture_blocks is set.
    taps[site] = (*inputs, output); taps['layers.{i}.blocks.{j}'] and
    taps['layers.{i}.downsample'] = (unit_in, unit_out)."""
    taps = {} if (capture or capture_blocks) else None
    site_taps = taps if capture else None

    h = swin_patch_embed(cfg, params, qstate, x, modes, site_taps,
                         training=training, soft=soft)
    if capture_blocks:
        taps["patch_embed"] = (x, h)

    for i, sp in enumerate(params.layers):
        if sp.downsample is not None:
            h_in = h
            h = patch_merging(sp.downsample, qstate, f"layers.{i}.downsample",
                              h, modes, site_taps, training=training,
                              soft=soft)
            if capture_blocks:
                taps[f"layers.{i}.downsample"] = (h_in, h)
        for j, bp in enumerate(sp.blocks):
            h_in = h
            h = swin_block(cfg, bp, qstate, f"layers.{i}.blocks.{j}", i, j, h,
                           modes, site_taps, training=training, soft=soft)
            if capture_blocks:
                taps[f"layers.{i}.blocks.{j}"] = (h_in, h)

    h = layer_norm(params.norm, h)
    logits = swin_head(params, qstate, h, modes, site_taps,
                       training=training, soft=soft)
    if capture_blocks:
        taps["head"] = (h, logits)
    if taps is not None:
        return logits, taps
    return logits


def swin_init(cfg: SwinConfig, generator: torch.Generator,
              device=None) -> SwinTransformer:
    """Random init (normal * 0.02 weights and rel-pos tables, zero biases,
    unit LayerNorms, bias-free reductions) from an explicit generator; for
    tests and pipeline benchmarking when no pretrained checkpoint is
    available."""
    model = SwinTransformer(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".norm" in name or name.startswith("norm"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
    return model
