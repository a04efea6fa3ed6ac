"""The EVA-02 family (timm's eva.py, as ``eva02_large_patch14_448`` builds
it): a patch convolution, a class token and learned positions, pre-norm
blocks whose attention turns the patch tokens' q and k by 2D RoPE and
whose SwiGLU MLP has a LayerNorm on the gated product before fc2 (sub-LN),
and the patch tokens' mean through ``fc_norm`` into the head. What each
name is for: ``portbench/cell.py::family``.

Parameters are under timm's keys, in the layout of timm's fused EVA
attention (``attn.qkv.weight`` with ``attn.q_bias`` and ``attn.v_bias``:
k has no bias) and of its ``GluMlp`` (``mlp.fc1`` of gate then value),
which the program's model loads as they are. q, k and v are one site, and
so are gate and value: one activation quantizer for the input each group
shares, as the program quantizes them.
"""

from __future__ import annotations

import functools
import math

import torch

from portbench import reference
from portbench.reference import STD, layer_norm
from portbench.reference import linear_leaves as _lin, norm_leaves as _norm

EPS = 1e-6

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


@functools.lru_cache(maxsize=None)
def rope_angles(grid, ref_grid, head_dim):
    """(grid^2, head_dim / 2) float64 on the host: the angle of pair j of
    patch p = grid * r + c, r * ref / grid * 10000^(-j / n) for j < n and
    c * ref / grid * 10000^(-(j - n) / n) for j >= n, n = head_dim / 4."""
    n = head_dim // 4
    f = 10000.0 ** (-torch.arange(n, dtype=torch.float64) / n)
    pos = torch.arange(grid, dtype=torch.float64) * (ref_grid / grid)
    r, c = pos.repeat_interleave(grid), pos.repeat(grid)
    return torch.cat([r[:, None] * f, c[:, None] * f], dim=1)


def rope(x, angles):
    """Turn the patch tokens of x (..., 1 + grid^2, head_dim) pair by pair:
    (x[2j], x[2j+1]) -> (x[2j] cos a - x[2j+1] sin a, x[2j+1] cos a +
    x[2j] sin a); the class token is left as it is."""
    a = angles.to(device=x.device, dtype=x.dtype)
    cos, sin = torch.cos(a), torch.sin(a)
    t = x[..., 1:, :]
    even, odd = t[..., 0::2], t[..., 1::2]
    out = torch.stack([even * cos - odd * sin, odd * cos + even * sin],
                      dim=-1).flatten(-2)
    return torch.cat([x[..., :1, :], out], dim=-2)


def qkv(run, p, y):
    """The q | k | v site: ``_Run.linear``'s Linear with timm's q_bias, a
    zero k bias and v_bias, which no single key of the weights holds."""
    site, key = f"{p}.attn.qkv", f"{p}.attn.qkv"
    qb = run.t(f"{p}.attn.q_bias")
    b = torch.cat([qb, torch.zeros_like(qb), run.t(f"{p}.attn.v_bias")])
    if run.plan is None:
        run.record(site, x=(y, False))
        return torch.nn.functional.linear(y, run.t(f"{key}.weight"), b)
    s = run.plan[site]
    w = reference.quant_weight(run.w[f"{key}.weight"], s, run.bits["w"],
                               run.dtype)

    def compute(x):
        x = reference.uq(x, run.p(site, "a_scale"), run.p(site, "a_zp"),
                         s["a_bits"], run.dtype)
        return torch.nn.functional.linear(run.ops(x), run.ops(w), b)

    return run.follow(site, y, compute)


def glu_mlp(run, prefix, x):
    """SwiGLU with sub-LN: fc1 (gate | value), silu(gate) * value, the
    LayerNorm over the hidden width, fc2 (a uniform site)."""
    g, u = run.linear(f"{prefix}.fc1", x, f"{prefix}.fc1").chunk(2, dim=-1)
    h = layer_norm(run, torch.nn.functional.silu(g) * u, f"{prefix}.norm",
                   EPS)
    return run.linear(f"{prefix}.fc2", h, f"{prefix}.fc2")


def block(run, arch, h, p):
    B, N, D = h.shape
    H = arch["num_heads"]
    hd = D // H
    grid = arch["img_size"] // arch["patch_size"]
    angles = rope_angles(grid, arch["rope_ref_grid"], hd)
    y = layer_norm(run, h, f"{p}.norm1", EPS)
    q, k, v = qkv(run, p, y).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    o = run.attend(f"{p}.attn", rope(q, angles), rope(k, angles), v,
                   logit_scale=hd ** -0.5)
    o = o.transpose(1, 2).reshape(B, N, D)
    h = h + run.linear(f"{p}.attn.proj", o, f"{p}.attn.proj")
    return h + glu_mlp(run, f"{p}.mlp", layer_norm(run, h, f"{p}.norm2", EPS))


def head(run, arch, h):
    pooled = layer_norm(run, h[:, 1:].mean(dim=1), "fc_norm", EPS)
    return run.linear("head", pooled, "head")


def units(arch):
    return [(f"blocks.{i}", functools.partial(block, p=f"blocks.{i}"))
            for i in range(arch["depth"])]


# ---------------------------------------------------------------------------
# Parameters and quantization sites
# ---------------------------------------------------------------------------


def leaves(a):
    D, P, C = a["embed_dim"], a["patch_size"], a["in_chans"]
    hid = a["mlp_hidden"]
    n = (a["img_size"] // P) ** 2
    out = [("patch_embed.proj.weight", (D, C, P, P), STD),
           ("patch_embed.proj.bias", (D,), STD),
           ("cls_token", (1, 1, D), STD), ("pos_embed", (1, n + 1, D), STD)]
    for i in range(a["depth"]):
        p = f"blocks.{i}"
        out += _norm(f"{p}.norm1", D) + _norm(f"{p}.norm2", D)
        # logits of a std of about 2, so attention rows are peaked
        out += [(f"{p}.attn.qkv.weight", (3 * D, D), math.sqrt(2.0 / D)),
                (f"{p}.attn.q_bias", (D,), STD), (f"{p}.attn.v_bias", (D,), STD)]
        out += _lin(f"{p}.attn.proj", D, D) + _lin(f"{p}.mlp.fc1", 2 * hid, D)
        out += _norm(f"{p}.mlp.norm", hid) + _lin(f"{p}.mlp.fc2", D, hid)
    return out + _norm("fc_norm", D) + _lin("head", a["num_classes"], D)


def sites(arch):
    out = [("patch_embed.proj", "conv", "patch_embed.proj")]
    for i in range(arch["depth"]):
        p = f"blocks.{i}"
        out += [(f"{p}.attn.qkv", "linear", f"{p}.attn.qkv"),
                (f"{p}.attn.matmul1", "matmul1", None),
                (f"{p}.attn.matmul2", "matmul2", None),
                (f"{p}.attn.proj", "linear", f"{p}.attn.proj"),
                (f"{p}.mlp.fc1", "linear", f"{p}.mlp.fc1"),
                (f"{p}.mlp.fc2", "linear", f"{p}.mlp.fc2")]
    return out + [("head", "head", "head")]


# ---------------------------------------------------------------------------
# Shapes of one forward
# ---------------------------------------------------------------------------

def _tokens(arch):
    return (arch["img_size"] // arch["patch_size"]) ** 2 + 1


def linear_shapes(arch, batch):
    """fc2 is kind 'glu_fc2': a uniform site on the int8 path, where the
    kind 'fc2' names ViT's and Swin's post-GeLU sites."""
    T, D, hid = batch * _tokens(arch), arch["embed_dim"], arch["mlp_hidden"]
    out = []
    for _ in range(arch["depth"]):
        out += [("qkv", T, D, 3 * D), ("proj", T, D, D),
                ("fc1", T, D, 2 * hid), ("glu_fc2", T, hid, D)]
    return out + [("head", batch, D, arch["num_classes"])]


def attention_calls(arch, batch):
    """No logit bias: P 0."""
    D, H = arch["embed_dim"], arch["num_heads"]
    return [(batch * H, _tokens(arch), D // H, 0)] * arch["depth"]


# ---------------------------------------------------------------------------
# The program's names
# ---------------------------------------------------------------------------

PROGRAM_MODULE = "models.eva"
MODEL_CLASS = "EvaTransformer"
# the configuration's key: the program's config field
PROGRAM_KEYS = {"img_size": "img_size", "patch_size": "patch_size",
                "in_chans": "in_chans", "embed_dim": "dim", "depth": "depth",
                "num_heads": "heads", "mlp_hidden": "mlp_hidden",
                "rope_ref_grid": "rope_grid", "num_classes": "num_classes"}
SEAMS = [("models.eva", "qlinear"), ("models.eva", "qconv2d"),
         ("ops.fq_attn", "run_flash"), ("models.eva", "eva_block")]
UNIT_SEAMS = ["eva_block"]

# the CPU stand-in: the program's test_tiny_eva
TINY = {"program_model": "test_tiny_eva", "img_size": 32, "patch_size": 8,
        "in_chans": 3, "embed_dim": 32, "depth": 2, "num_heads": 2,
        "mlp_hidden": 85, "rope_ref_grid": 2, "num_classes": 10}
