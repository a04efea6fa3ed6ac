"""The ViT / DeiT family (timm's vision_transformer): a patch convolution, a
class token and learned positions, pre-norm blocks of attention and a GeLU
MLP, and the class token's LayerNorm into the head. What each name is for:
``portbench/cell.py::family``.
"""

from __future__ import annotations

import functools

import torch

from portbench import reference
from portbench.reference import STD, layer_norm, mlp
from portbench.reference import linear_leaves as _lin, norm_leaves as _norm

# ---------------------------------------------------------------------------
# The reference's stages
# ---------------------------------------------------------------------------


def embed(run, arch, x):
    """Image -> tokens: patch convolution, class token, positions."""
    D = arch["embed_dim"]
    tok = run.conv("patch_embed.proj", x, "patch_embed.proj",
                   arch["patch_size"])
    B = tok.shape[0]
    return torch.cat([run.t("cls_token").expand(B, 1, D),
                      tok.reshape(B, -1, D)], 1) + run.t("pos_embed")


def block(run, arch, h, p):
    B, N, D = h.shape
    H = arch["num_heads"]
    hd = D // H
    y = layer_norm(run, h, f"{p}.norm1", 1e-6)
    qkv = run.linear(f"{p}.attn.qkv", y, f"{p}.attn.qkv")
    q, k, v = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    o = run.attend(f"{p}.attn", q, k, v, logit_scale=hd ** -0.5)
    o = o.transpose(1, 2).reshape(B, N, D)
    h = h + run.linear(f"{p}.attn.proj", o, f"{p}.attn.proj")
    return h + mlp(run, f"{p}.mlp", layer_norm(run, h, f"{p}.norm2", 1e-6))


def head(run, arch, h):
    return run.linear("head", layer_norm(run, h, "norm", 1e-6)[:, 0], "head")


def units(arch):
    return [(f"blocks.{i}", functools.partial(block, p=f"blocks.{i}"))
            for i in range(arch["depth"])]


# ---------------------------------------------------------------------------
# Parameters and quantization sites
# ---------------------------------------------------------------------------

QKV_STD = 0.075     # chip_smoke.py:281, QKV_STD


def leaves(a):
    D, P, C = a["embed_dim"], a["patch_size"], a["in_chans"]
    hid = int(D * a["mlp_ratio"])
    n = (a["img_size"] // P) ** 2
    out = [("patch_embed.proj.weight", (D, C, P, P), STD),
           ("patch_embed.proj.bias", (D,), STD),
           ("cls_token", (1, 1, D), STD), ("pos_embed", (1, n + 1, D), STD)]
    for i in range(a["depth"]):
        p = f"blocks.{i}"
        out += _norm(f"{p}.norm1", D) + _norm(f"{p}.norm2", D)
        out += _lin(f"{p}.attn.qkv", 3 * D, D, QKV_STD)
        out += _lin(f"{p}.attn.proj", D, D) + _lin(f"{p}.mlp.fc1", hid, D)
        out += _lin(f"{p}.mlp.fc2", D, hid)
    return out + _norm("norm", D) + _lin("head", a["num_classes"], D)


def sites(arch):
    out = [("patch_embed.proj", "conv", "patch_embed.proj")]
    for i in range(arch["depth"]):
        out += reference.block_sites(f"blocks.{i}")
    return out + [("head", "head", "head")]


# ---------------------------------------------------------------------------
# Shapes of one forward
# ---------------------------------------------------------------------------

def _stages(arch):
    """[(tokens an image S, width D, heads H, windows an image nW, blocks,
    shifted blocks)]: one stage of every block."""
    n = (arch["img_size"] // arch["patch_size"]) ** 2 + 1
    return [(n, arch["embed_dim"], arch["num_heads"], 1, arch["depth"], 0)]


def linear_shapes(arch, batch):
    out = []
    ratio = arch["mlp_ratio"]
    for S, D, H, nW, depth, _ in _stages(arch):
        T = batch * S * nW
        for _ in range(depth):
            out += [("qkv", T, D, 3 * D), ("proj", T, D, D),
                    ("fc1", T, D, int(D * ratio)),
                    ("fc2", T, int(D * ratio), D)]
    D = _stages(arch)[-1][1]
    return out + [("head", batch, D, arch["num_classes"])]


def attention_calls(arch, batch):
    """No logit bias: P 0."""
    out = []
    for S, D, H, nW, depth, _ in _stages(arch):
        G = batch * nW * H
        for _ in range(depth):
            out.append((G, S, D // H, 0))
    return out


# ---------------------------------------------------------------------------
# The program's names
# ---------------------------------------------------------------------------

PROGRAM_MODULE = "models.vit"
MODEL_CLASS = "VisionTransformer"
# the configuration's key: the program's config field
PROGRAM_KEYS = {"img_size": "img_size", "patch_size": "patch_size",
                "in_chans": "in_chans", "embed_dim": "dim", "depth": "depth",
                "num_heads": "heads", "mlp_ratio": "mlp_ratio",
                "num_classes": "num_classes"}
SEAMS = [("models.vit", "qlinear"), ("models.vit", "qconv2d"),
         ("ops.fq_attn", "run_flash"), ("models.vit", "vit_block")]
UNIT_SEAMS = ["vit_block"]

# the CPU stand-in: the program's test_tiny
TINY = {"program_model": "test_tiny", "img_size": 32, "patch_size": 8,
        "in_chans": 3, "embed_dim": 32, "depth": 2, "num_heads": 2,
        "mlp_ratio": 4.0, "num_classes": 10}
