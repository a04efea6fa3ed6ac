"""What the benchmark makes from ``--seed``, before the program sees any of
it: the weights, the images and the W4A4 quantizer plan.

Nothing here imports the program. The weights are timm-keyed tensors drawn
on the device by one ``torch.Generator`` in one call and cut into leaves;
the images are drawn the same way and copied to the host, where a data
loader would hand them over. The quantizer plan is a dict of plain tensors:
per-row min/max weight scales, per-tensor (per-head at the attention
products) min/max activation scales over the reference's raw capture of a
batch of calibration images, and AdaLog bases drawn per site from the seed
in the range that the port's W4A4 calibrations picked (11 to 26). The
program gets the plan as its own quantizer state (``portbench.program``),
the reference gets it as it is.

Each model family lists its parameters and sites in its module
(``portbench/families/<family>.py``). The weight scales follow
``chip_smoke.py::timm_weights`` / ``swin_weights`` (lines 1144-1198 and
``QKV_STD`` at 281 at the commit that added this benchmark: qkv widened
so attention rows are peaked, as in a trained model), drawn on the
device instead of by numpy, with small random biases and LayerNorm
affines in place of zeros and ones, so that no term of a layer is zero
by construction. The plan replaces
``chip_smoke.py::smoke_qstate`` (line 1200): its single AdaLog base 29 and
its capture through the program's own forward.
"""

from __future__ import annotations

import math

import torch

from portbench import cell, reference

ADALOG_Q = (11, 26)     # AdaLog bases of the port's W4A4 calibrations


def leaves(arch):
    """[(timm key, shape, std[, mean])] of every parameter, from the
    configuration's family module."""
    return cell.family_of(arch).leaves(arch)


def make_weights(arch, seed, device):
    """{timm key: float32 tensor on ``device``}: one normal draw from a
    generator on the device, cut into leaves and scaled."""
    spec = leaves(arch)
    total = sum(math.prod(s[1]) for s in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for key, shape, std, *mean in spec:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape).mul_(std)
        out[key] = t.add_(mean[0]) if mean else t
        at += n
    return out


def make_images(arch, seed, n_batches, batch, device, salt=0,
                pinned=False):
    """``n_batches`` NHWC float32 batches, drawn on the device and handed
    over on the host, as a loader hands them over; ``salt`` draws another
    set from the same seed. ``pinned`` hands them over in page-locked
    memory, as a DataLoader with ``pin_memory=True`` does, where the
    device is a card."""
    g = torch.Generator(device=device).manual_seed(seed + ((salt + 1) << 40))
    s, c = arch["img_size"], arch["in_chans"]
    x = torch.randn((n_batches, batch, s, s, c), generator=g, device=device)
    if not (pinned and device.type == "cuda"):
        return [b.cpu() for b in x.unbind(0)]
    return [torch.empty(b.shape, pin_memory=True).copy_(b)
            for b in x.unbind(0)]


def _minmax(lo, hi, bits):
    """Scale and zero point of an asymmetric uniform quantizer over [lo, hi]
    widened to hold 0."""
    lo = torch.clamp(lo, max=0.0)
    hi = torch.clamp(hi, min=0.0)
    scale = torch.clamp((hi - lo) / (2 ** bits - 1), min=1e-8)
    return scale, torch.round(-lo / scale)


def _weight_minmax(w, bits):
    """Per output row over the flattened row, as min/max weight quantizers
    take it (no widening to 0)."""
    w = w.reshape(w.shape[0], -1)
    lo, hi = w.amin(dim=1), w.amax(dim=1)
    scale = torch.clamp((hi - lo) / (2 ** bits - 1), min=1e-8)
    return scale, torch.round(-lo / scale)


def sites(arch):
    """[(site, kind, weight key)] in forward order, from the configuration's
    family module: kind 'conv', 'linear', 'head', 'postgelu', 'matmul1',
    'matmul2', or a kind of the family's own that its plan_<kind>
    fills."""
    return cell.family_of(arch).sites(arch)


def make_plan(arch, weights, calib_images, seed):
    """{site: {name: float32 tensor, 'a_bits': int}} from min/max over the
    reference's raw forward of ``calib_images`` (on the weights' device).
    A site of a kind of the family's own is filled by the family module's
    ``plan_<kind>(site's plan, quant, site's ranges, generator)``."""
    q = arch["quant"]
    ranges = {}
    reference.forward(arch, weights, None, calib_images,
                      dtype=torch.float64, ranges=ranges)
    g = torch.Generator().manual_seed(seed + 1)
    family = cell.family_of(arch)
    plan = {}
    for name, kind, wkey in sites(arch):
        s = {}
        if wkey is not None:
            s["w_scale"], s["w_zp"] = _weight_minmax(
                weights[f"{wkey}.weight"], q["w_bit"])
        r = ranges.get(name, {})
        if kind in ("linear", "head"):
            s["a_bits"] = q["qhead_a_bit"] if kind == "head" else q["a_bit"]
            s["a_scale"], s["a_zp"] = _minmax(*r["x"], s["a_bits"])
        elif kind == "postgelu":
            s["a_bits"] = q["a_bit"]
            s["a_scale"] = r["shifted"][1].reshape(1)
            s["shift"] = torch.full_like(s["a_scale"], reference.GELU_MIN)
        elif kind == "matmul1":
            s["A_scale"], s["A_zp"] = _minmax(*r["A"], q["a_bit"])
            s["B_scale"], s["B_zp"] = _minmax(*r["B"], q["a_bit"])
        elif kind == "matmul2":
            s["B_scale"], s["B_zp"] = _minmax(*r["B"], q["a_bit"])
        elif kind != "conv":
            getattr(family, f"plan_{kind}")(s, q, r, g)
        if kind in ("postgelu", "matmul2"):
            lo, hi = ADALOG_Q
            s["log_q"] = torch.randint(lo, hi + 1, (), generator=g) \
                .float().to(calib_images.device)
        plan[name] = s
    return plan
