"""The generator of served traffic: closed-loop batches from one client.

The traffic file gives ``batch`` (images a call), ``distinct_batches``
(how many different batches are drawn from the seed and cycled),
``calib_images`` (the raw capture that sets the activation ranges),
``pinned_images`` (true: the batches are handed over in page-locked host
memory, as a DataLoader with ``pin_memory=True`` hands them over),
``warmup_batches``, ``trace_batches`` (the profiled calls after the
window of a ``--trace 1`` run), ``check_batches`` (how many of the
window's batches the reference checks), ``check_images`` (how many images
of each the reference follows site by site; the fused attention and the
head are checked for all). The serving options handed to the program's
Config are the configuration's (``serving``), not the traffic's.

Each call of the window is one batch: ``predict`` on host images, as a
validation loop hands them over, and its logits copied to the host before
the next call is made. The window closes at the first call that ends past
``seconds``.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from portbench import check, program, state


def prepare(arch, traffic, seed, device):
    """(weights, plan, images, predict): the benchmark's state from the seed
    and the program loaded on it. Prints each step's seconds to stderr."""
    steps, t = [], time.perf_counter()

    def step(name):
        nonlocal t
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        steps.append(f"{name} {now - t:.2f} s")
        t = now

    weights = state.make_weights(arch, seed, device)
    step("weights")
    calib = state.make_images(arch, seed, 1, traffic["calib_images"],
                              device, salt=1)[0].to(device)
    plan = state.make_plan(arch, weights, calib, seed)
    del calib
    step("plan")
    images = state.make_images(arch, seed, traffic["distinct_batches"],
                               traffic["batch"], device,
                               pinned=traffic.get("pinned_images", False))
    step("images")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    predict = program.load(arch, weights, plan, device)
    step("load")
    print("setup: " + ", ".join(steps), file=sys.stderr)
    return weights, plan, images, predict


def served_again(predict, x, arch, rows):
    """(sampled, whole) recordings (``program.recorded``) of ``x`` served
    once more through ``predict``. Raises where the forward went around a
    seam of the recorder, naming it."""
    sites = state.sites(arch)
    head = next(n for n, kind, _ in sites if kind == "head")
    with program.recorded(arch, x.shape[0], rows, head) as rec:
        predict(x)
    lost = program.missing(arch, sites, *rec)
    if lost:
        raise RuntimeError(
            "portbench: the program's forward no longer passes through "
            "the functions that the check records (the family's SEAMS in "
            "portbench/families/), so correct cannot be decided:\n  "
            + "\n  ".join(lost))
    return rec


def judge_batches(arch, weights, plan, images, checked, **kw):
    """The numbers of ``check.numbers`` over the checked batches:
    [(image batch index, window logits, rows, (sampled, whole))]. ``kw``
    goes to ``check.follow`` (the control's precision)."""
    gaps = {}
    for bi, y, rows, (sampled, whole) in checked:
        for key, v in check.follow(arch, weights, plan, images[bi], rows,
                                   sampled, whole, y, **kw).items():
            gaps.setdefault(key, []).extend(v)
    return check.numbers(gaps), gaps


def p95(values):
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def run(cell, seed, seconds, trace, device, started, wrap=None):
    """One run of the cell: returns (e2e {name: value}, layer context,
    check numbers, attempted, failed, memory peak, trace summary).
    ``started`` is the process's start on ``time.perf_counter``; ``wrap``
    (tests) wraps ``predict``."""
    arch, tr = cell["arch"], cell["traffic"]
    cuda = device.type == "cuda"
    weights, plan, images, predict = prepare(arch, tr, seed, device)
    if wrap is not None:
        predict = wrap(predict)
    n = len(images)
    t = time.perf_counter()
    for i in range(tr["warmup_batches"]):
        predict(images[i % n]).cpu()
    if cuda:
        torch.cuda.synchronize(device)
    print(f"setup: warm-up {time.perf_counter() - t:.2f} s, since the "
          f"process started {time.perf_counter() - started:.2f} s",
          file=sys.stderr)

    served, lat, host = [], [], []
    t_start = time.perf_counter()
    setup_s = t_start - started
    while True:
        x = images[len(served) % n]
        a = time.perf_counter()
        out = predict(x)
        b = time.perf_counter()
        served.append((len(served) % n, out.cpu()))
        c = time.perf_counter()
        lat.append(c - a)
        host.append(b - a)
        if c - t_start >= seconds:
            break
    wall = c - t_start

    summary = counts = None
    if trace and cuda:
        from portbench import trace as tracing

        before = program.counters()
        summary = tracing.profile(
            lambda i: predict(images[i % n]).cpu(), tr["trace_batches"],
            torch)
        after = program.counters()
        counts = {k: after[k] - before[k] for k in after}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    checked = []
    for j, k in enumerate(check.sample(seed, served, tr["check_batches"])):
        bi, y = served[k]
        rows = check.sample_rows(seed, j, y.shape[0], tr["check_images"])
        checked.append((bi, y, rows,
                        served_again(predict, images[bi], arch, rows)))
    del predict
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    batch = tr["batch"]
    e2e = {"setup_s": setup_s, "serve_img_s": batch * len(served) / wall,
           "serve_batch_ms_p95": 1e3 * p95(lat)}
    failed = sum(1 for _, y in served if not torch.isfinite(y).all())
    found, _ = judge_batches(arch, weights, plan, images, checked)
    ctx = {"arch": arch, "traffic": tr, "batch": batch,
           "host_ms": [1e3 * h for h in host], "img_s": e2e["serve_img_s"],
           "trace": summary, "launches": counts}
    return e2e, ctx, found, len(served), failed, peak, summary
