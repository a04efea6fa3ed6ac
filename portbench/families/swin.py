"""The Swin family (timm 0.9's swin_transformer): a patch convolution and
LayerNorm, stages of window attention blocks, every second one shifted,
with a relative position bias, patch merging between stages, and the
pooled LayerNorm into the head. What each name is for:
``portbench/cell.py::family``.
"""

from __future__ import annotations

import functools
import math

import torch

from portbench import reference
from portbench.reference import STD, layer_norm, mlp
from portbench.reference import linear_leaves as _lin, norm_leaves as _norm

# ---------------------------------------------------------------------------
# The reference's stages
# ---------------------------------------------------------------------------


def rel_index(ws):
    """timm's relative_position_index: (ws^2, ws^2) into the
    ((2 ws - 1)^2, heads) table."""
    c = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                   indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shift_mask(res, ws, shift):
    """timm's attn_mask of a shifted block: (nW, N, N) of 0 and -100."""
    img = torch.zeros(res, res)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(res // ws, ws, res // ws, ws).permute(0, 2, 1, 3) \
        .reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def windows(x, ws):
    B, Hh, W, C = x.shape
    return x.reshape(B, Hh // ws, ws, W // ws, ws, C).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def unwindows(x, ws, Hh, W):
    C = x.shape[-1]
    B = x.shape[0] // ((Hh // ws) * (W // ws))
    return x.reshape(B, Hh // ws, W // ws, ws, ws, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B, Hh, W, C)


def embed(run, arch, x):
    h = run.conv("patch_embed.proj", x, "patch_embed.proj",
                 arch["patch_size"])
    return layer_norm(run, h, "patch_embed.norm", 1e-5)


def merge(run, arch, h, p):
    """timm 0.9's PatchMerging: [x(0,0), x(1,0), x(0,1), x(1,1)] by (row,
    column) offset, LayerNorm, the bias-free reduction."""
    h = torch.cat([h[:, 0::2, 0::2], h[:, 1::2, 0::2],
                   h[:, 0::2, 1::2], h[:, 1::2, 1::2]], -1)
    return run.linear(f"{p}.reduction", layer_norm(run, h, f"{p}.norm", 1e-5),
                      f"{p}.reduction", bias=False)


def block(run, arch, x, p, heads, ws, shift):
    B, Hh, W, C = x.shape
    hd = C // heads
    y = layer_norm(run, x, f"{p}.norm1", 1e-5)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    y = windows(y, ws)
    Bw, N, _ = y.shape
    qkv = run.linear(f"{p}.attn.qkv", y, f"{p}.attn.qkv")
    q, k, v = qkv.reshape(Bw, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    table = run.t(f"{p}.attn.relative_position_bias_table")
    bias = table[rel_index(ws).reshape(-1).to(table.device)] \
        .reshape(N, N, heads).permute(2, 0, 1)
    mask = shift_mask(Hh, ws, shift).to(device=x.device, dtype=run.dtype) \
        if shift else None

    def add_bias(a):
        a = a + bias[None]
        if mask is None:
            return a
        nW = mask.shape[0]
        return (a.reshape(-1, nW, heads, N, N) + mask[None, :, None]) \
            .reshape(-1, heads, N, N)

    o = run.attend(f"{p}.attn", q * hd ** -0.5, k, v, add_bias=add_bias)
    o = run.linear(f"{p}.attn.proj", o.transpose(1, 2).reshape(Bw, N, C),
                   f"{p}.attn.proj")
    o = unwindows(o, ws, Hh, W)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    x = x + o
    return x + mlp(run, f"{p}.mlp", layer_norm(run, x, f"{p}.norm2", 1e-5))


def head(run, arch, h):
    h = layer_norm(run, h, "norm", 1e-5)
    return run.linear("head.fc", h.mean(dim=(1, 2)), "head.fc")


def units(arch):
    out = []
    res = arch["img_size"] // arch["patch_size"]
    for i, depth in enumerate(arch["depths"]):
        if i > 0:
            p = f"layers.{i}.downsample"
            out.append((p, functools.partial(merge, p=p)))
            res //= 2
        ws = min(arch["window_size"], res)
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}"
            shift = 0 if res <= ws or j % 2 == 0 else ws // 2
            out.append((p, functools.partial(
                block, p=p, heads=arch["num_heads"][i], ws=ws,
                shift=shift)))
    return out


# ---------------------------------------------------------------------------
# Parameters and quantization sites
# ---------------------------------------------------------------------------

def leaves(a):
    E, P, C = a["embed_dim"], a["patch_size"], a["in_chans"]
    out = [("patch_embed.proj.weight", (E, C, P, P), STD),
           ("patch_embed.proj.bias", (E,), STD)]
    out += _norm("patch_embed.norm", E)
    res = a["img_size"] // P
    for i, depth in enumerate(a["depths"]):
        D = E * 2 ** i
        if i > 0:
            p = f"layers.{i}.downsample"
            out += _norm(f"{p}.norm", 2 * D)
            out += [(f"{p}.reduction.weight", (D, 2 * D), STD)]
            res //= 2
        ws, H = min(a["window_size"], res), a["num_heads"][i]
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}"
            out += _norm(f"{p}.norm1", D) + _norm(f"{p}.norm2", D)
            # logits of a std of about 2, so attention rows are peaked
            out += _lin(f"{p}.attn.qkv", 3 * D, D, math.sqrt(2.0 / D))
            out += [(f"{p}.attn.relative_position_bias_table",
                     ((2 * ws - 1) ** 2, H), STD)]
            out += _lin(f"{p}.attn.proj", D, D)
            out += _lin(f"{p}.mlp.fc1", int(D * a["mlp_ratio"]), D)
            out += _lin(f"{p}.mlp.fc2", D, int(D * a["mlp_ratio"]))
    D = E * 2 ** (len(a["depths"]) - 1)
    return out + _norm("norm", D) + _lin("head.fc", a["num_classes"], D)


def sites(arch):
    out = [("patch_embed.proj", "conv", "patch_embed.proj")]
    for i, depth in enumerate(arch["depths"]):
        if i > 0:
            p = f"layers.{i}.downsample.reduction"
            out.append((p, "linear", p))
        for j in range(depth):
            out += reference.block_sites(f"layers.{i}.blocks.{j}")
    return out + [("head.fc", "head", "head.fc")]


# ---------------------------------------------------------------------------
# Shapes of one forward
# ---------------------------------------------------------------------------

def _stages(arch):
    """[(tokens a window S, width D, heads H, windows an image nW, blocks,
    shifted blocks)] of each stage."""
    out = []
    res = arch["img_size"] // arch["patch_size"]
    for i, depth in enumerate(arch["depths"]):
        if i > 0:
            res //= 2
        ws = min(arch["window_size"], res)
        shifted = 0 if res <= ws else depth // 2
        out.append((ws * ws, arch["embed_dim"] * 2 ** i,
                    arch["num_heads"][i], (res // ws) ** 2, depth, shifted))
    return out


def linear_shapes(arch, batch):
    out = []
    ratio = arch["mlp_ratio"]
    for i, (S, D, H, nW, depth, _) in enumerate(_stages(arch)):
        T = batch * S * nW
        if i > 0:
            out.append(("reduction", T, 2 * D, D))
        for _ in range(depth):
            out += [("qkv", T, D, 3 * D), ("proj", T, D, D),
                    ("fc1", T, D, int(D * ratio)),
                    ("fc2", T, int(D * ratio), D)]
    D = _stages(arch)[-1][1]
    return out + [("head", batch, D, arch["num_classes"])]


def attention_calls(arch, batch):
    """Logit bias of the heads, or windows times heads in a shifted
    block."""
    out = []
    for S, D, H, nW, depth, shifted in _stages(arch):
        G = batch * nW * H
        for j in range(depth):
            P = nW * H if (shifted and j % 2 == 1) else H
            out.append((G, S, D // H, P))
    return out


# ---------------------------------------------------------------------------
# The program's names
# ---------------------------------------------------------------------------

PROGRAM_MODULE = "models.swin"
MODEL_CLASS = "SwinTransformer"
# the configuration's key: the program's config field
PROGRAM_KEYS = {"img_size": "img_size", "patch_size": "patch_size",
                "in_chans": "in_chans", "embed_dim": "embed_dim",
                "depths": "depths", "num_heads": "heads",
                "window_size": "window", "mlp_ratio": "mlp_ratio",
                "num_classes": "num_classes"}
SEAMS = [("models.swin", "qlinear"), ("models.swin", "qconv2d"),
         ("ops.fq_attn", "run_flash"), ("models.swin", "swin_block"),
         ("models.swin", "patch_merging")]
UNIT_SEAMS = ["swin_block", "patch_merging"]

# the CPU stand-in: the program's test_tiny_swin
TINY = {"program_model": "test_tiny_swin", "img_size": 32, "patch_size": 4,
        "in_chans": 3, "embed_dim": 16, "depths": [1, 2], "num_heads": [2, 4],
        "window_size": 4, "mlp_ratio": 4.0, "num_classes": 10}
