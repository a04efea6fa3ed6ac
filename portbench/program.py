"""The system under test, as a user deploys it: the benchmark's weights and
quantizer plan written as a v2 checkpoint, then ``load_quantized``, whose
``predict`` the window drives.

This is the one module of the benchmark that imports the program
(``adalog_tpu_torch``), and only what a user of it calls: the zoo's spec,
the modules that hold parameters, the quantizer state's template and
dataclasses, the post-GeLU bias fold, the checkpoint writer and
``load_quantized``. It also reads the kernel wrappers' launch counters.

The comparison that decides ``correct`` records what the forward hands to
and gets from its quantized sites through the functions that the forward
looks up in its modules at each call (the ``SEAMS`` of the configuration's
family module, ``portbench/families/<family>.py``, which also names the
program's model module and class and its config's fields, as plain
data). A program that stops calling one of them, by fusing across it or
by capturing the forward in a graph, leaves sites unrecorded; ``missing``
then names the seam, and the run stops without a result.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import tempfile

import torch

from portbench import cell, reference


def spec_for(arch):
    """The program's model spec of the configuration, checked size by size
    against the configuration's file (the family's ``PROGRAM_KEYS``)."""
    from adalog_tpu_torch.models.zoo import model_spec

    spec = model_spec(arch["program_model"])
    for ours, theirs in cell.family_of(arch).PROGRAM_KEYS.items():
        want, got = arch[ours], getattr(spec.cfg, theirs)
        if (tuple(want) if isinstance(want, list) else want) != got:
            raise ValueError(f"{arch['name']}: {ours} is {want} in the "
                             f"configuration, {got} in the program's "
                             f"{spec.name}")
    return spec


def port_config(arch):
    """The program's Config: the configuration's quantizer widths and its
    serving options (``serving``: eval_int8, use_pallas_gemm)."""
    from adalog_tpu_torch.utils.config import Config

    q = arch["quant"]
    return Config(w_bit=q["w_bit"], a_bit=q["a_bit"], s_bit=q["s_bit"],
                  qconv_a_bit=q["qconv_a_bit"],
                  qhead_a_bit=q["qhead_a_bit"],
                  matmul_head_channel_wise=q["matmul_head_channel_wise"],
                  post_softmax_quantizer=q["post_softmax_quantizer"],
                  post_gelu_quantizer=q["post_gelu_quantizer"],
                  eval_dtype=arch["eval_dtype"], **arch["serving"])


def port_state(arch, spec, cfg, weights, plan):
    """(model, qstate) of the program, filled from the benchmark's weights
    and plan, with the post-GeLU shift folded into each fc2 bias as a
    finished calibration leaves it. The model is the family's
    ``MODEL_CLASS`` of its ``PROGRAM_MODULE``."""
    from adalog_tpu_torch.calib.init_state import init_qstate
    from adalog_tpu_torch.calib.reparam import fold_gelu_shift_into_bias
    from adalog_tpu_torch.models.layers import LinearSite, MatMulSite
    from adalog_tpu_torch.calib.layout import tree_get, tree_set

    dev = next(iter(weights.values())).device
    family = cell.family_of(arch)
    cls = getattr(_program_module(family.PROGRAM_MODULE), family.MODEL_CLASS)
    model = cls(spec.cfg, device=dev)
    model.load_state_dict(weights, strict=True)
    qstate = init_qstate(spec, cfg, model)
    with torch.no_grad():
        for name, site in qstate.items():
            s = plan[name]
            if not isinstance(site, MatMulSite):
                wq = site.wq
                wq.scale = s["w_scale"].reshape(wq.scale.shape).clone()
                wq.zero_point = s["w_zp"].reshape(wq.scale.shape).clone()
            if isinstance(site, LinearSite):
                aq = site.aq
                if aq.kind == "adalog":
                    aq.scale = s["a_scale"].reshape(aq.scale.shape).clone()
                    aq.shift = s["shift"].reshape(aq.shift.shape).clone()
                    aq.log_q = s["log_q"].clone()
                else:
                    aq.scale = s["a_scale"].reshape(aq.scale.shape).clone()
                    aq.zero_point = s["a_zp"].reshape(aq.scale.shape).clone()
            elif isinstance(site, MatMulSite):
                for op, qs in (("A", site.Aq), ("B", site.Bq)):
                    if qs.kind == "adalog":
                        qs.log_q = s["log_q"].clone()
                    else:
                        qs.scale = s[f"{op}_scale"].reshape(
                            qs.scale.shape).clone()
                        qs.zero_point = s[f"{op}_zp"].reshape(
                            qs.scale.shape).clone()
        for name, site in qstate.items():
            if isinstance(site, LinearSite) and site.aq.shifted:
                path = tuple(int(p) if p.isdigit() else p
                             for p in name.split("."))
                lin = fold_gelu_shift_into_bias(
                    tree_get(model, path), site,
                    shift=float(site.aq.shift.reshape(-1)[0]))
                model = tree_set(model, path, lin)
                site.aq.bias_reparamed = torch.ones(
                    (), dtype=torch.bool, device=dev)
    return model, qstate


def load(arch, weights, plan, device):
    """``predict`` of ``load_quantized`` on the benchmark's state, through
    a v2 checkpoint written under TMPDIR and removed once loaded."""
    from adalog_tpu_torch.serve import load_quantized
    from adalog_tpu_torch.utils.checkpoint import save_checkpoint

    spec = spec_for(arch)
    cfg = port_config(arch)
    model, qstate = port_state(arch, spec, cfg, weights, plan)
    fd, path = tempfile.mkstemp(suffix=".ckpt", prefix="portbench_")
    os.close(fd)
    try:
        save_checkpoint(path, model, qstate)
        del model, qstate
        predict, *_ = load_quantized(spec.name, path, config=cfg,
                                     device=device)
    finally:
        os.remove(path)
    return predict


def counters():
    """{kernel: launches so far, kernel.variant: launches so far} of the
    wrappers that count (K1, K4, K5, and K2/K3)."""
    from adalog_tpu_torch.ops import fq_attn, fq_gemm, int8_linear

    out = {}
    for tag, fn in (("K1", fq_attn.fq_flash_attn),
                    ("K2", fq_attn.fq_softmax_attn_matmul),
                    ("K3", fq_attn.fq_attn_matmul),
                    ("K4", fq_gemm.fq_gemm),
                    ("K5", int8_linear.int8_gemm)):
        out[tag] = fn.launches
        for v, n in getattr(fn, "variant_launches", {}).items():
            out[f"{tag}.{v}"] = n
    return out


def _program_module(name):
    """The module ``adalog_tpu_torch.<name>``."""
    return importlib.import_module(f"adalog_tpu_torch.{name}")


@contextlib.contextmanager
def recorded(arch, batch, rows, head):
    """Record, while the block is open, what the program's forward hands
    to and gets from each quantized Linear and the patch convolution for
    the images ``rows`` of a batch of ``batch`` (rows of dim 0 belong to
    the images in order, so a tensor of L rows gives each image L /
    batch), and the fused attention's q, kT, v and output for every
    image. The head ``head`` is recorded for every image, and so is the
    output of the last block (or patch merging). Yields (sampled, whole):
    {"sites": {name: (x, y)}, "attn": [(q, kT, v, out)], "last": out},
    the sites and last output of the sampled images and the attention of
    all, and {"sites": {head: (x, y)}, "last": out} of all. The program's
    forwards look the configuration's family's ``SEAMS`` up in their
    modules at each call, so ``predict`` runs them through the recorder
    unchanged; the family's ``UNIT_SEAMS`` give the last output."""
    family = cell.family_of(arch)

    def take(t):
        return reference.image_rows(t, rows, batch).detach().clone()

    sampled = {"sites": {}, "attn": []}
    whole = {"sites": {}}

    def qlinear(fn):
        def run(p, site, x, **kw):
            y = fn(p, site, x, **kw)
            name = kw.get("name")
            if name == head:
                whole["sites"][name] = (x.detach(), y.detach())
            else:
                sampled["sites"][name] = (take(x), take(y))
            return y
        return run

    def qconv2d(fn):
        def run(p, site, x, **kw):
            y = fn(p, site, x, **kw)
            sampled["sites"]["patch_embed.proj"] = (take(x), take(y))
            return y
        return run

    def run_flash(fn):
        def run(m1, m2, q, kT, v, **kw):
            out = fn(m1, m2, q, kT, v, **kw)
            sampled["attn"].append(tuple(t.detach().clone()
                                         for t in (q, kT, v, out)))
            return out
        return run

    def unit(fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            whole["last"] = out.detach()
            return out
        return run

    wraps = {"qlinear": qlinear, "qconv2d": qconv2d, "run_flash": run_flash,
             **dict.fromkeys(family.UNIT_SEAMS, unit)}
    patches = [(_program_module(m), name) for m, name in family.SEAMS]
    saved = [(m, name, getattr(m, name)) for m, name in patches]
    try:
        for m, name in patches:
            setattr(m, name, wraps[name](getattr(m, name)))
        yield sampled, whole
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
        if "last" in whole:
            sampled["last"] = take(whole["last"])


def missing(arch, sites, sampled, whole):
    """What a recording of ``recorded`` lacks, one line per seam that the
    forward went around, or [] where it holds every site. ``sites`` is
    ``state.sites`` of the configuration."""
    family = cell.family_of(arch)
    mod = f"adalog_tpu_torch.{family.PROGRAM_MODULE}"
    head = next(n for n, kind, _ in sites if kind == "head")
    out = []
    if "patch_embed.proj" not in sampled["sites"]:
        out.append(f"{mod}.qconv2d: the patch convolution was not recorded")
    lost = [n for n, kind, _ in sites if kind in ("linear", "postgelu")
            and n not in sampled["sites"]]
    lost += [] if head in whole["sites"] else [head]
    if lost:
        out.append(f"{mod}.qlinear: {len(lost)} Linear sites were not "
                   f"recorded ({', '.join(lost[:4])}"
                   f"{', ...' if len(lost) > 4 else ''})")
    blocks = sum(kind == "matmul1" for _, kind, _ in sites)
    if len(sampled["attn"]) != blocks:
        out.append(f"adalog_tpu_torch.ops.fq_attn.run_flash: "
                   f"{len(sampled['attn'])} fused attentions recorded, the "
                   f"forward makes {blocks}")
    if "last" not in whole:
        out.append(f"{mod}.{', '.join(family.UNIT_SEAMS)}: the last "
                   "block's output was not recorded")
    return out
