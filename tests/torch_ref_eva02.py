"""A plain reference of EVA-02 (timm's eva.py as ``eva02_large_patch14_448``
builds it), raw and fake-quantized, for the port's tests.

Plain ``torch`` alone: nothing of JAX, of ``adalog_tpu`` or of
``adalog_tpu_torch``. Everything runs in float64 with TF32 off, on timm's
own parameter keys (separate ``attn.q_proj`` / ``k_proj`` / ``v_proj``, k
without a bias; ``mlp.fc1_g`` / ``fc1_x``, ``mlp.norm``, ``mlp.fc2``;
``fc_norm``, ``head``). The model, from timm's code:

    x (B, H, W, 3) NHWC
    t = conv P x P stride P (patch_embed.proj)            -> (B, g*g, D)
    h = cat(cls_token, t) + pos_embed
    each block:
      y = LN(h; norm1)
      q, k, v = y Wq^T + bq, y Wk^T, y Wv^T + bv; heads of hd
      q, k of the patch tokens (never the class token) turned by RoPE:
        out[2j] = x[2j] cos a_j - x[2j+1] sin a_j
        out[2j+1] = x[2j+1] cos a_j + x[2j] sin a_j
        a_j = r * ref / g * f_j (j < n), c * ref / g * f_(j-n) (j >= n),
        n = hd / 4, f_m = 10000^(-m / n), patch p at row r, column c
      h = h + softmax(q k^T hd^-0.5) v (heads merged) Wp^T + bp
      z = LN(h; norm2)
      h = h + LN(silu(z Wg^T + bg) * (z Wx^T + bx); mlp.norm) W2^T + b2
    logits = LN(mean of h over the patch tokens; fc_norm) Wh^T + bh

LayerNorm eps is 1e-6 everywhere. Departures from the published model:

- weights: whatever the caller hands in (the tests draw them; the
  published checkpoint is not in the repository);
- RoPE: timm builds its sine and cosine tables in float32; here they are
  float64;
- the quantized forward (``plan``) is the port's W4A4 scheme, not part of
  EVA-02: per-tensor asymmetric uniform activations at every Linear (one
  quantizer for q, k and v, one for the gate and value projections, the
  inputs they share), per-row asymmetric uniform weights, the patch
  convolution's weights per output channel and its 8-bit activations
  passed through, per-head uniform operands of both attention products,
  and the post-softmax AdaLog quantizer at scale 1 (base 2^(q / 37)) of
  ``portbench/reference.py``. A code is defined in float32 (round(x / s)
  of float32 x and s, half to even); its value, and all the rest, in
  float64.

A plan is a plain dict: {site: {"w_scale", "w_zp", "a_scale", "a_zp",
"a_bits", "w_bits"}} for ``patch_embed.proj`` (weights only), each
``blocks.{i}.attn.qkv`` / ``.attn.proj`` / ``.mlp.fc1`` / ``.mlp.fc2`` (the
fused sites' rows in the order q, k, v and gate, value) and ``head``;
{"A_scale", "A_zp", "B_scale", "B_zp", "bits"} (per head) for
``blocks.{i}.attn.matmul1``; {"log_q", "s_bits", "B_scale", "B_zp",
"bits"} for ``blocks.{i}.attn.matmul2``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

ADALOG_R = 37.0
EPS = 1e-6
F64 = torch.float64


@contextlib.contextmanager
def exact_products():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def uq(x, scale, zp, bits):
    """Asymmetric uniform fake quantization: code clamp(round(x / s) +
    round(z), 0, 2^b - 1) in float32, value (code - round(z)) * s in
    float64."""
    s32, z32 = scale.float(), torch.round(zp.float())
    code = torch.clamp(torch.round(x.float() / s32) + z32, 0.0,
                       2.0 ** bits - 1)
    return (code - z32).to(F64) * scale.to(F64)


def adalog_unit(p, q, bits):
    """The post-softmax AdaLog quantizer at scale 1, base 2^(q / 37): code
    round(-log2(p) * 37 / q) of p clamped to [1e-15, 1], in float32; codes
    past 2^b - 1 give 0; the value by the hardware form 2^-floor(code q /
    37) * round(2^-((code q) mod 37 / 37) * (2^(b+1) - 2)) / (2^(b+1) -
    2)."""
    levels = 2.0 ** bits
    q32 = q.float()
    code = torch.round(-torch.log2(torch.clamp(p.float(), 1e-15, 1.0))
                       * (ADALOG_R / q32))
    keep = code < levels
    code = torch.clamp(code, 0.0, levels - 1).to(F64)
    prod = code * q32.to(F64)
    shift = torch.floor(prod / ADALOG_R)
    frac = torch.round(prod - shift * ADALOG_R)
    step = 1.0 / (2 * levels - 2)
    mant = torch.round(torch.exp2(-frac / ADALOG_R) / step) * step
    return torch.exp2(-shift) * mant * keep


def quant_weight(w, site):
    shape = (-1,) + (1,) * (w.dim() - 1)
    return uq(w, site["w_scale"].reshape(shape), site["w_zp"].reshape(shape),
              site["w_bits"])


def per_head(t):
    return t.reshape(1, -1, 1, 1)


# ---------------------------------------------------------------------------
# Sites
# ---------------------------------------------------------------------------

def linear(x, w, b, site=None):
    """x W^T + b; with a plan's site, x per tensor and W per row quantized."""
    if site is not None:
        x = uq(x, site["a_scale"], site["a_zp"], site["a_bits"])
        w = quant_weight(w, site)
    return F.linear(x.to(F64), w.to(F64), None if b is None else b.to(F64))


def patch_conv(x, w, b, patch, site=None):
    """NHWC images -> (B, g, g, D); the activations pass through (8 bits in
    the shipped configurations), the weights per output channel."""
    if site is not None:
        w = quant_weight(w, site)
    y = F.conv2d(x.to(F64).permute(0, 3, 1, 2), w.to(F64), b.to(F64),
                 stride=patch)
    return y.permute(0, 2, 3, 1)


def matmul1(q, kT, site=None):
    """q @ kT, both per head uniform with a plan."""
    if site is not None:
        b = site["bits"]
        q = uq(q, per_head(site["A_scale"]), per_head(site["A_zp"]), b)
        kT = uq(kT, per_head(site["B_scale"]), per_head(site["B_zp"]), b)
    return q.to(F64) @ kT.to(F64)


def matmul2(p, v, site=None):
    """p @ v, p by the post-softmax AdaLog, v per head uniform with a
    plan."""
    if site is not None:
        p = adalog_unit(p, site["log_q"], site["s_bits"])
        v = uq(v, per_head(site["B_scale"]), per_head(site["B_zp"]),
               site["bits"])
    return p.to(F64) @ v.to(F64)


def layer_norm(x, sd, key):
    return F.layer_norm(x.to(F64), x.shape[-1:], sd[f"{key}.weight"].to(F64),
                        sd[f"{key}.bias"].to(F64), EPS)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(grid, ref_grid, head_dim):
    """(grid^2, head_dim / 2) float64: the angle of pair j of patch p."""
    n = head_dim // 4
    out = torch.empty(grid * grid, head_dim // 2, dtype=F64)
    for p in range(grid * grid):
        r, c = divmod(p, grid)
        for j in range(head_dim // 2):
            pos, m = (r, j) if j < n else (c, j - n)
            out[p, j] = pos * ref_grid / grid * 10000.0 ** (-m / n)
    return out


def rope(x, angles):
    """Turn the patch tokens of (..., 1 + grid^2, head_dim) pair by pair;
    the class token is left as it is."""
    x = x.to(F64)
    a = angles.to(x.device)
    cos, sin = torch.cos(a), torch.sin(a)
    t = x[..., 1:, :]
    even, odd = t[..., 0::2], t[..., 1::2]
    out = torch.stack([even * cos - odd * sin, odd * cos + even * sin],
                      dim=-1).flatten(-2)
    return torch.cat([x[..., :1, :], out], dim=-2)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def qkv_weight(sd, p, D):
    """q, k, v of block ``p`` stacked: (3D, D) weights and the (3D,) bias
    with k's third 0, the layout of the port's single site."""
    w = torch.cat([sd[f"{p}.attn.{n}_proj.weight"] for n in "qkv"])
    zero = torch.zeros(D, dtype=sd[f"{p}.attn.q_proj.bias"].dtype)
    b = torch.cat([sd[f"{p}.attn.q_proj.bias"], zero,
                   sd[f"{p}.attn.v_proj.bias"]])
    return w, b


def fc1_weight(sd, p):
    """Gate then value: (2H, D) weights and (2H,) bias."""
    return (torch.cat([sd[f"{p}.mlp.fc1_g.weight"], sd[f"{p}.mlp.fc1_x.weight"]]),
            torch.cat([sd[f"{p}.mlp.fc1_g.bias"], sd[f"{p}.mlp.fc1_x.bias"]]))


def glu(h):
    """silu(gate) * value of fc1's (..., 2H) output."""
    g, u = h.to(F64).chunk(2, dim=-1)
    return F.silu(g) * u


def block(sd, cfg, p, h, angles, plan=None):
    D, H = cfg["dim"], cfg["heads"]
    hd = D // H
    B, N, _ = h.shape

    def site(name):
        return None if plan is None else plan[f"{p}.{name}"]

    y = layer_norm(h, sd, f"{p}.norm1")
    qkv = linear(y, *qkv_weight(sd, p, D), site("attn.qkv"))
    q, k, v = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    q, k = rope(q, angles), rope(k, angles)
    a = matmul1(q, k.transpose(-2, -1), site("attn.matmul1")) * hd ** -0.5
    o = matmul2(torch.softmax(a, dim=-1), v, site("attn.matmul2"))
    o = o.transpose(1, 2).reshape(B, N, D)
    h = h + linear(o, sd[f"{p}.attn.proj.weight"], sd[f"{p}.attn.proj.bias"],
                   site("attn.proj"))
    z = layer_norm(h, sd, f"{p}.norm2")
    m = glu(linear(z, *fc1_weight(sd, p), site("mlp.fc1")))
    m = layer_norm(m, sd, f"{p}.mlp.norm")
    return h + linear(m, sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"],
                      site("mlp.fc2"))


def pool(sd, h):
    """The patch tokens' mean through fc_norm."""
    return layer_norm(h[:, 1:].mean(dim=1), sd, "fc_norm")


def forward(sd, cfg, images, plan=None):
    """Logits (B, classes) in float64 of NHWC images. ``cfg``: {"img_size",
    "patch_size", "dim", "depth", "heads", "rope_grid"}; ``sd``: timm's
    {key: tensor}; ``plan``: None (raw) or the module docstring's dict."""
    with torch.no_grad(), exact_products():
        P = cfg["patch_size"]
        g = cfg["img_size"] // P
        angles = rope_angles(g, cfg["rope_grid"], cfg["dim"] // cfg["heads"])
        t = patch_conv(images, sd["patch_embed.proj.weight"],
                       sd["patch_embed.proj.bias"], P,
                       None if plan is None else plan["patch_embed.proj"])
        B = t.shape[0]
        h = torch.cat([sd["cls_token"].to(F64).expand(B, 1, -1),
                       t.reshape(B, g * g, -1)], 1) + sd["pos_embed"].to(F64)
        for i in range(cfg["depth"]):
            h = block(sd, cfg, f"blocks.{i}", h, angles, plan)
        return linear(pool(sd, h), sd["head.weight"], sd["head.bias"],
                      None if plan is None else plan["head"])
