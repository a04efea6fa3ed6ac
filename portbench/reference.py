"""The plain reference: fake-quantized forwards in plain PyTorch, written
from the published descriptions (the AdaLog paper's quantizers, and
timm's models for the families). This module holds what every family
shares: the quantizers, the sites (``_Run``: Linear, convolution, fused
attention, each followed as set out below), LayerNorm and the GeLU MLP,
and the forward through a family's stages; each model family's
embedding, blocks and head are in ``portbench/families/<family>.py``,
written on these.

It imports torch alone, nothing of the program, and takes only what the
benchmark made: the weights as a dict of tensors under timm's keys, and the
quantizer plan (``portbench.state``) as plain tensors. Whatever the
program's set-up derives from those (fake-quantized weight tables, the
post-GeLU shift folded into the fc2 bias, int8 codes) is worked out here
again: weights are quantized from their scales on every call and the
post-GeLU shift is subtracted back before fc2, which is the unfolded form
of the same function.

Precision. A quantizer's code is defined in float32, as the configuration
states its quantizer math: round(x / s) of float32 x and s, IEEE division
and round-half-even, and for AdaLog round(-log2(x / s) * (r / q)) in
float32. Everything else, the dequantized values, every product,
LayerNorm, softmax, GeLU and the residual adds, runs in ``dtype``: float64
for the reference; for the control, float32 with the operands of every
product and convolution rounded to TF32 (``tf32``: the rounding itself,
since cuBLAS takes TF32 only where its heuristics choose a tensor-core
kernel, and not for Swin's small window products).

Modes. ``forward(arch, weights, plan, images, dtype=)`` gives the quantized
logits. With ``plan=None`` and a ``ranges`` dict it runs the raw model and
records each quantization site's input ranges, the capture that
``portbench.state`` sets the activation scales from. With ``forced`` (a
recording of the program's own site inputs and outputs, ``runner``) it
follows the program step by step: at each Linear, convolution and fused
attention it compares its own input, computed from the program's earlier
outputs, with the program's input to the site (the glue: LayerNorm,
residuals, GeLU, reshapes, rolls and windows), computes the site itself
from the program's input and compares that with the program's output, and
then carries on from the program's output. ``gaps`` collects, by site
and kind ("in" or "out"), each image's gap, and by attention site
("tied") the share of query rows that the attention's gap leaves out.

The fused attention is followed over every image of the batch, not only
the followed ones: the program's q, k and v of all images go through the
reference's attention and its output is compared with the program's, row
by row. A query row in which some post-softmax AdaLog code lies within
``TIE_WINDOW`` of a rounding boundary (``adalog_ties``) is left out of
that comparison: a last-bit difference in the softmax rounds such a code
either way, and both are right.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import cell

ADALOG_R = 37.0
GELU_MIN = 0.16997124254703522      # |min over x of x * Phi(x)|
# code units: how far from a rounding boundary an unrounded post-softmax
# code has to lie before the float32 softmax of a sound program rounds it
# the way the float64 reference does (PERF.md, section 2)
TIE_WINDOW = 2e-4
# elements of the attention logits that one block of images may hold
ATTN_BLOCK = 2 ** 25


# ---------------------------------------------------------------------------
# Quantizers: codes in float32, values in the caller's dtype
# ---------------------------------------------------------------------------

def _f32(v):
    if torch.is_tensor(v):
        return v.float()
    return torch.tensor(v, dtype=torch.float32)


def uq(x, scale, zp, bits, dtype):
    """Asymmetric uniform fake quantization: codes round(x / s) + z clamped
    to [0, 2^b - 1], dequantized as (code - z) * s."""
    z = _f32(zp).to(x.device)
    code = torch.clamp(torch.round(x.float() / _f32(scale).to(x.device)) + z,
                       0.0, 2.0 ** bits - 1)
    return (code - z).to(dtype) * scale.to(dtype)


def adalog(x, scale, q, bits, dtype, r=ADALOG_R):
    """AdaLog fake quantization, base 2^(q/r): code round(-log2(x/s) * r/q)
    on x/s clamped to [1e-15, 1]; codes past 2^b - 1 give 0; dequant by the
    shift-and-mantissa tables of the hardware form: 2^-floor(code q / r)
    times round(2^-((code q) mod r / r) * (2^(b+1) - 2)) / (2^(b+1) - 2),
    times s."""
    levels = 2.0 ** bits
    s32, q32 = _f32(scale).to(x.device), _f32(q).to(x.device)
    code = torch.round(-torch.log2(torch.clamp(x.float() / s32, 1e-15, 1.0))
                       * (r / q32))
    keep = code < levels
    code = torch.clamp(code, 0.0, levels - 1).to(dtype)
    prod = code * q32.to(dtype)
    shift = torch.floor(prod / r)
    frac = torch.round(prod - shift * r)
    step = 1.0 / (2 * levels - 2)
    mant = torch.round(torch.exp2(-frac / r) / step) * step
    return torch.exp2(-shift) * mant * s32.to(dtype) * keep


def adalog_ties(x, scale, q, bits, r=ADALOG_R, window=TIE_WINDOW):
    """Where AdaLog's code of ``x`` is not decided to the last bit: the
    unrounded code -log2(x / s) * r / q, taken in float64, lies within
    ``window`` of a rounding boundary n + 1/2 that changes the value
    (n < 2^b: past 2^b - 1/2 every code gives 0)."""
    v = -torch.log2(torch.clamp(x.double() / float(scale), 1e-15, 1.0)) \
        * (r / _f32(q).to(x.device).double())
    return ((v - torch.floor(v) - 0.5).abs() < window) & (v < 2.0 ** bits)


def image_rows(t, rows, batch):
    """The rows of dim 0 of ``t`` that belong to the images ``rows`` of a
    batch of ``batch``, in order: each image owns t.shape[0] // batch
    consecutive rows."""
    r = t.shape[0] // batch
    idx = (torch.as_tensor(rows)[:, None] * r
           + torch.arange(r)[None, :]).reshape(-1)
    return t[idx.to(t.device)]


def tf32(t):
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest, ties
    away from zero, as the tensor cores round a TF32 operand."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def quant_weight(w, site, bits, dtype):
    """Per output row (per output channel of a convolution)."""
    shape = (-1,) + (1,) * (w.dim() - 1)
    return uq(w, site["w_scale"].reshape(shape), site["w_zp"].reshape(shape),
              bits, dtype)


def rel_gap(got, want, per):
    """Per image, |got - want|_2 / |want|_2, the rows of dim 0 split into
    ``per`` images."""
    got = got.double().reshape(per, -1)
    want = want.double().reshape(per, -1).to(got.device)
    return ((got - want).norm(dim=1) / want.norm(dim=1)).tolist()


# ---------------------------------------------------------------------------
# Sites
# ---------------------------------------------------------------------------

class _Run:
    """One computation: the weights, the plan (None: raw, recording ranges
    into ``ranges``), the dtype, the bit widths, and a recording of the
    program to follow (``forced``: {"sites": {name: (x, y)} of the followed
    images, "attn": [(q, kT, v, out)] of the whole batch, consumed in
    order, "rows": the followed images, "batch": the batch's size}) with
    the number of images it follows."""

    def __init__(self, weights, plan, bits, dtype, ranges, forced, images,
                 tf32_products):
        self.w, self.plan, self.bits, self.dtype = weights, plan, bits, dtype
        self.ranges, self.forced, self.images = ranges, forced, images
        self.ops = tf32 if tf32_products else (lambda t: t)
        self.attn_at = 0
        self.gaps = {}

    def t(self, key):
        return self.w[key].to(self.dtype)

    def p(self, site, key):
        return self.plan[site][key]

    def record(self, site, **tensors):
        """Running per-site min and max of the raw model's inputs: a scalar
        per tensor, or per head (dim 1) for the attention operands."""
        if self.ranges is None:
            return
        rec = self.ranges.setdefault(site, {})
        for key, (x, per_head) in tensors.items():
            dims = (0, 2, 3) if per_head else tuple(range(x.dim()))
            lo, hi = x.amin(dim=dims).float(), x.amax(dim=dims).float()
            if key in rec:
                lo = torch.minimum(lo, rec[key][0])
                hi = torch.maximum(hi, rec[key][1])
            rec[key] = (lo, hi)

    def note(self, site, kind, got, want):
        """Keep each image's gap of the program's ``got`` from ``want``."""
        self.gaps.setdefault((site, kind), []).extend(
            rel_gap(got, want, self.images))

    def follow(self, site, x, compute):
        """Without a recording, ``compute(x)``. With one: compare ``x`` with
        the program's input to ``site``, compute from the program's input,
        compare with its output, and go on from the program's output."""
        if self.forced is None:
            return compute(x)
        x_p, y_p = self.forced["sites"][site]
        self.note(site, "in", x_p, x)
        self.note(site, "out", y_p, compute(x_p.to(self.dtype)))
        return y_p.to(self.dtype)

    def linear(self, site, x, key, bias=True):
        """x @ W^T + b; activations quantized per tensor, W per row."""
        w = self.t(f"{key}.weight")
        b = self.t(f"{key}.bias") if bias else None
        if self.plan is None:
            self.record(site, x=(x, False))
            return F.linear(x, w, b)
        s = self.plan[site]
        w = quant_weight(self.w[f"{key}.weight"], s, self.bits["w"],
                         self.dtype)

        def compute(x):
            if "log_q" in s:        # post-GeLU AdaLog on x + shift
                shift = self.p(site, "shift")
                xs = x.float() + shift.float()
                x = adalog(xs, self.p(site, "a_scale"), self.p(site, "log_q"),
                           s["a_bits"], self.dtype) - shift.to(self.dtype)
            else:
                x = uq(x, self.p(site, "a_scale"), self.p(site, "a_zp"),
                       s["a_bits"], self.dtype)
            return F.linear(self.ops(x), self.ops(w), b)

        return self.follow(site, x, compute)

    def postgelu_record(self, site, h):
        if self.ranges is not None:
            self.record(site, shifted=(h + GELU_MIN, False))

    def conv(self, site, x, key, stride):
        """Patch embedding on NHWC images; its activations are 8-bit in the
        shipped configurations and pass through unquantized."""
        w = self.t(f"{key}.weight")
        if self.plan is not None:
            w = quant_weight(self.w[f"{key}.weight"], self.plan[site],
                             self.bits["w"], self.dtype)

        def compute(x):
            y = F.conv2d(self.ops(x.permute(0, 3, 1, 2)), self.ops(w),
                         self.t(f"{key}.bias"), stride=stride)
            return y.permute(0, 2, 3, 1)

        if self.plan is None:
            return compute(x)
        return self.follow(site, x, compute)

    def attend(self, prefix, q, k, v, logit_scale=1.0, add_bias=None):
        """softmax(uq(q) @ uq(k^T) * logit_scale + bias) quantized by the
        post-softmax AdaLog, @ uq(v): (B, H, N, hd) of q, k, v (B, H, N,
        hd), q already scaled where the model scales it first; ``add_bias``
        adds the model's logit bias. Followed as one site, the program's
        fused attention, over every image of the batch
        (``attention_gaps``)."""
        m1, m2 = f"{prefix}.matmul1", f"{prefix}.matmul2"
        kT = k.transpose(-2, -1)
        if self.plan is None:
            self.record(m1, A=(q, True), B=(kT, True))
            self.record(m2, B=(v, True))

        def compute(q, kT, v):
            """(output, tied rows): the query rows with a tied code
            (``adalog_ties``), None for the raw model."""
            if self.plan is None:
                a = q @ kT
            else:
                b, hd = self.bits["a"], (1, -1, 1, 1)
                a = self.ops(uq(q, self.p(m1, "A_scale").reshape(hd),
                                self.p(m1, "A_zp").reshape(hd), b,
                                self.dtype)) \
                    @ self.ops(uq(kT, self.p(m1, "B_scale").reshape(hd),
                                  self.p(m1, "B_zp").reshape(hd), b,
                                  self.dtype))
            a = a * logit_scale
            if add_bias is not None:
                a = add_bias(a)
            p = torch.softmax(a, dim=-1)
            if self.plan is None:
                return p @ v, None
            hd = (1, -1, 1, 1)
            base = self.p(m2, "log_q")
            pq = adalog(p, 1.0, base, self.bits["s"], self.dtype)
            tied = adalog_ties(p, 1.0, base, self.bits["s"]).any(-1)
            return self.ops(pq) @ self.ops(uq(
                v, self.p(m2, "B_scale").reshape(hd),
                self.p(m2, "B_zp").reshape(hd), self.bits["a"],
                self.dtype)), tied

        if self.forced is None:
            return compute(q, kT, v)[0]
        site = f"{prefix}.attention"
        qa, kTa, va, outa = self.forced["attn"][self.attn_at]
        self.attn_at += 1
        rows, batch = self.forced["rows"], self.forced["batch"]
        for got, want in ((qa, q), (kTa, kT), (va, v)):
            self.note(site, "in", image_rows(got, rows, batch), want)
        self.attention_gaps(site, compute, batch, qa, kTa, va, outa)
        return image_rows(outa, rows, batch).to(self.dtype)

    def attention_gaps(self, site, compute, batch, q, kT, v, out):
        """Each image's gap of the program's attention output ``out`` from
        the reference's, both over every image of the batch, computed from
        the program's q, kT, v in blocks of whole images; the query rows
        with a tied code are left out of the difference."""
        per = q.shape[0] // batch
        step = max(1, ATTN_BLOCK // (per * q.shape[1] * q.shape[2] ** 2))
        gaps = self.gaps.setdefault((site, "out"), [])
        tied = rows = 0
        for i in range(0, batch, step):
            k = min(batch, i + step) - i
            sl = slice(i * per, (i + k) * per)
            ref, ties = compute(*(t[sl].to(self.dtype) for t in (q, kT, v)))
            ref = ref.double()
            diff = (out[sl].double() - ref) * (~ties)[..., None]
            gaps.extend((diff.reshape(k, -1).norm(dim=1)
                         / ref.reshape(k, -1).norm(dim=1)).tolist())
            tied += int(ties.sum())
            rows += ties.numel()
        self.gaps.setdefault((site, "tied"), []).append(tied / rows)


def layer_norm(run, x, key, eps):
    return F.layer_norm(x, x.shape[-1:], run.t(f"{key}.weight"),
                        run.t(f"{key}.bias"), eps)


def mlp(run, prefix, x):
    h = F.gelu(run.linear(f"{prefix}.fc1", x, f"{prefix}.fc1"))
    run.postgelu_record(f"{prefix}.fc2", h)
    return run.linear(f"{prefix}.fc2", h, f"{prefix}.fc2")


# ---------------------------------------------------------------------------
# What the family modules share (portbench/families/)
# ---------------------------------------------------------------------------

STD = 0.02


def linear_leaves(key, o, i, std=STD):
    """The leaves (``state.make_weights``) of a Linear of ``o`` outputs and
    ``i`` inputs."""
    return [(f"{key}.weight", (o, i), std), (f"{key}.bias", (o,), STD)]


def norm_leaves(key, d):
    # (key, shape, std, mean): LayerNorm weights about 1
    return [(f"{key}.weight", (d,), STD, 1.0), (f"{key}.bias", (d,), STD)]


def block_sites(p):
    """The sites (``state.sites``) of an attention block ``p`` whose qkv
    and proj go through ``_Run.linear``, its attention through
    ``_Run.attend`` and its MLP through ``mlp``."""
    return [(f"{p}.attn.qkv", "linear", f"{p}.attn.qkv"),
            (f"{p}.attn.matmul1", "matmul1", None),
            (f"{p}.attn.matmul2", "matmul2", None),
            (f"{p}.attn.proj", "linear", f"{p}.attn.proj"),
            (f"{p}.mlp.fc1", "linear", f"{p}.mlp.fc1"),
            (f"{p}.mlp.fc2", "postgelu", f"{p}.mlp.fc2")]


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------

def stages(arch):
    """(embed, [(unit name, unit)], head) of the model, from its family's
    module: the embedding takes the images, each unit (a block, or a patch
    merging) and the head take the output of the stage before. Unit names
    are the program's block and merging prefixes, timm's module paths."""
    family = cell.family_of(arch)
    return family.embed, family.units(arch), family.head


def runner(arch, plan, weights, dtype=torch.float64, ranges=None,
           forced=None, images=None, tf32_products=False):
    """The state of one computation: ``plan`` None runs the raw model,
    recording input ranges into ``ranges``; ``forced`` follows a recording
    of the program over ``images`` images (the module's docstring);
    ``tf32_products`` rounds the operands of every product and convolution
    to TF32 (the control, in float32)."""
    q = arch["quant"]
    bits = {"w": q["w_bit"], "a": q["a_bit"], "s": q["s_bit"]}
    return _Run(weights, plan, bits, dtype, ranges, forced, images,
                tf32_products)


def stage(run, arch, fn, x):
    """One stage in the runner's dtype, without autograd."""
    with torch.no_grad():
        return fn(run, arch, x.to(run.dtype))


def forward(arch, weights, plan, images, *, dtype=torch.float64,
            ranges=None):
    """Logits (B, classes) in ``dtype`` of NHWC float images. ``plan`` None
    runs the raw model, recording input ranges into ``ranges``."""
    run = runner(arch, plan, weights, dtype, ranges)
    embed, units, head = stages(arch)
    h = stage(run, arch, embed, images)
    for _, unit in units:
        h = stage(run, arch, unit, h)
    return stage(run, arch, head, h)
