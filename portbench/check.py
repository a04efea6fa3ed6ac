"""The comparison that decides ``correct`` for a served classifier.

A quantized network at 4 bits is chaotic under rounding: a last-bit
difference moves a code across a rounding boundary, the next quantizers
amplify the step, and after a few blocks two sound implementations give
logits as far apart as the TF32 control's. So the reference follows the
program step by step from the program's own state (``reference``'s
``forced`` mode), and checks the first and last stages on their own:

- after the window, ``check_batches`` of the batches it served are drawn
  from the seed and served once more through the same ``predict``, with
  the inputs and outputs of every quantized Linear and the patch
  convolution recorded (``program.recorded``) for ``check_images`` images
  of each, drawn from the seed, and the fused attention's inputs and
  output, the head's and the last block's output recorded for every
  image;
- the reference, float64 on the program's device, recomputes each site
  from the program's input to it and compares with the program's output,
  and recomputes each site's input from the program's earlier outputs (the
  embedding from the images themselves) and compares with what the
  program handed the site;
- the fused attention is recomputed for every image of the checked
  batches from the program's q, k and v, leaving out the query rows in
  which a post-softmax code is tied on a rounding boundary
  (``reference.adalog_ties``);
- the head of every image of the checked batches is recomputed from the
  program's last block output and compared with the logits the window
  served.

A gap is |program - reference|_2 / |reference|_2 over one image's part of
a tensor. The numbers and their limits (``limits/<cell>.json``) are in
``numbers``; how each limit was set is in PERF.md. The control
(``portbench/readings.py``) is the same reference computed in float32 with
TF32 products, put in the program's place.
"""

from __future__ import annotations

import torch

from portbench import reference


def sample(seed, served, k):
    """``k`` indices of the served batches drawn from the seed."""
    g = torch.Generator().manual_seed(seed + 7)
    order = torch.randperm(len(served), generator=g).tolist()
    return sorted(order[:k])


def sample_rows(seed, k, batch, n):
    """``n`` of a batch's ``batch`` images, drawn from the seed for the
    ``k``-th checked batch, in order."""
    g = torch.Generator().manual_seed(seed * 31 + k)
    return sorted(torch.randperm(batch, generator=g)[:n].tolist())


def follow(arch, weights, plan, images, rows, sampled, whole, logits, *,
           dtype=torch.float64, tf32=False):
    """{(site, "in" | "out"): [each image's gap]} of the reference following
    one served batch step by step (``reference``'s ``forced`` mode): the
    recorded sites of the images ``rows`` from the images themselves to the
    last block, then the head of every image from the program's last block
    output against ``logits``, the logits that the window served. Runs in
    ``dtype`` on the weights' device, with cuBLAS's and cuDNN's TF32 off;
    ``tf32`` rounds the operands of its products to TF32 (the control).
    ``sampled`` and ``whole`` are ``program.recorded``'s recordings."""
    dev = next(iter(weights.values())).device
    embed, units, head = reference.stages(arch)
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        forced = dict(sampled, rows=rows, batch=images.shape[0])
        run = reference.runner(arch, plan, weights, dtype, forced=forced,
                               images=len(rows), tf32_products=tf32)
        h = reference.stage(run, arch, embed, images[rows].to(dev))
        for _, unit in units:
            h = reference.stage(run, arch, unit, h)
        run.note("last", "in", sampled["last"], h)
        (name, (x, _)), = whole["sites"].items()
        top = reference.runner(
            arch, plan, weights, dtype, images=images.shape[0],
            forced={"sites": {name: (x, logits.to(x.device))}},
            tf32_products=tf32)
        reference.stage(top, arch, head, whole["last"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was
    return {**run.gaps, **top.gaps}


def numbers(gaps):
    """The numbers compared, from {(site, kind): [each image's gap]}:

    - ``site_rel_err_max``: the widest gap of any image at any site's input
      (the glue between sites) or at the output of a Linear, the patch
      convolution or the head (every image of the checked batches);
    - ``attention_rel_err_max``: the widest gap of any image of the checked
      batches at the fused attention's output, with the query rows whose
      post-softmax code is tied left out (``reference.attention_gaps``)."""
    def is_attn(site, kind):
        return kind == "out" and site.endswith(".attention")

    return {
        "site_rel_err_max": max(max(v) for (s, k), v in gaps.items()
                                if k in ("in", "out") and not is_attn(s, k)),
        "attention_rel_err_max": max(max(v) for (s, k), v in gaps.items()
                                     if is_attn(s, k)),
    }


def judge(found, limits):
    """(correct, {name: {"value", "limit"}}) of the numbers that have a
    limit; a number that is not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = found[name]
        out[name] = {"value": v, "limit": limit}
        ok = ok and v == v and v <= limit
    return ok, out
