"""Device time by the program's own spans: a second profiled stretch of
served batches with the program's spans on, each device operation put
under the innermost span that launched it, and the device's idle time
split into the part the host spent inside ``serve.predict`` and the part
it spent in the caller.

The span metrics' readers (``portbench/metrics/serve.*_ms.py`` that name
this module) call ``measure``, once a run: after the window, the check
and ``trace.py``'s stretch, on the card, it builds the program again
from the run's ``--seed`` exactly as the window's was built
(``serving.prepare``), warms it up as the window was, and profiles
``trace_batches`` batches of the same images with the spans on. The
generator's own traced stretch is left as it is, spans off, and feeds the
other per-layer metrics.

The profiler gives each device operation (kernel, copy, set) the
correlation id of the runtime call that launched it (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...), a host event of its own. The operation goes
under the innermost span open at that call: the spans nest by their host
extent, as the profiler's ``cpu_parent`` chain does, and the innermost is
the one that started last. The runtime call is found for every launch,
also for one that no aten op made (K1 and K5 launch from their own
libraries through ctypes; the profiler links no op to those), which the
correlation with the launching op (``linked_correlation_id``) misses.
The serving loop is one thread, so spans nest across the whole trace.
``torch.profiler.record_function`` emits each span a second
time as a device-side ``gpu_user_annotation`` event; those are left out
of device time and of busy time (they cover the kernels they annotate, so
counting them would count the same time twice), and their sum is
reported apart. ``trace.py``'s stretch runs with the spans off, so none
of these reach its summary.

The program's spans are listed in ``adalog_tpu_torch/utils/profiling.py``,
whose switch this module reads besides ``portbench/program.py``'s use of
the program. A program without that switch is not measured again, and
every reader of this module then returns nothing; a summary in which a
reader's span was never entered gives nothing for it either.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

PREDICT = "serve.predict"
NONE = "(none)"            # launched outside every span: the caller's own


def events(prof):
    """(host, dev) of a finished ``torch.profiler.profile``: host =
    [(correlation id, name, start ns, end ns, is a span)] of the spans and
    of the CUDA runtime calls (host events named ``cu*``); dev = [(name,
    start ns, end ns, correlation id, is an annotation)]."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        note = bool(e.is_user_annotation())
        if e.device_type() != DeviceType.CPU:
            dev.append((e.name(), e.start_ns(), e.end_ns(),
                        e.correlation_id(), note))
        elif note or e.name().startswith("cu"):
            host.append((e.correlation_id(), e.name(), e.start_ns(),
                         e.end_ns(), note))
    return host, dev


def innermost(host):
    """{correlation id of each runtime call: name of the innermost span
    open at its start, or NONE}: spans and calls sorted by start, a stack
    of the open spans."""
    out, stack = {}, []
    # spans before calls that start with them; outer spans first
    for cid, name, a, b, is_span in sorted(
            host, key=lambda h: (h[2], -h[3], not h[4])):
        while stack and stack[-1][1] <= a:
            stack.pop()
        if is_span:
            stack.append((name, b))
        else:
            out[cid] = stack[-1][0] if stack else NONE
    return out


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys):
    """Length of the intersection of two sorted unions of intervals."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def summarize(host, dev, window_s, n):
    """The stretch of ``n`` batches by span (times in ns in, ms out):
    device ms by innermost span (``NONE``: launched outside every span;
    "(unlinked)": no runtime call found), the device ms of all operations
    and of the annotations left out, busy and idle, and the idle ms that
    the host spent inside ``serve.predict``. ``seen``: the span names the
    host entered. A device event that is an annotation, or carries the name
    of a span, is an annotation."""
    parent = innermost(host)
    seen = {h[1] for h in host if h[4]}
    notes = [d for d in dev if d[4] or d[0] in seen]
    ops = [d for d in dev if not (d[4] or d[0] in seen)]
    span_ms, outside = {}, {}
    for name, a, b, cid, _ in ops:
        where = parent.get(cid, "(unlinked)")
        span_ms[where] = span_ms.get(where, 0.0) + (b - a) / 1e6
        if where == NONE:
            outside[name] = outside.get(name, 0.0) + (b - a) / 1e6
    busy = _union([(a, b) for _, a, b, _, _ in ops])
    starts = [h[2] for h in host] + [d[1] for d in ops]
    ends = [h[3] for h in host] + [d[2] for d in ops]
    idle = []
    if busy:
        edges = [min(starts)] + [x for iv in busy for x in iv] + [max(ends)]
        idle = [[a, b] for a, b in zip(edges[::2], edges[1::2]) if b > a]
    predict = _union([(h[2], h[3]) for h in host
                      if h[4] and h[1] == PREDICT])
    idle_ns = sum(b - a for a, b in idle)
    predict_idle_ns = _overlap(idle, predict)
    return {
        "batches": n,
        "window_s": window_s,
        "seen": sorted(seen),
        "span_ms": span_ms,
        "outside_ms": outside,
        "device_ms": sum(span_ms.values()),
        "annotation_ms": sum((b - a) / 1e6 for _, a, b, _, _ in notes),
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "idle_ms": idle_ns / 1e6,
        "predict_idle_ms": predict_idle_ns / 1e6,
    }


def per_batch(s, names):
    """Device ms a batch under the spans ``names``, or None where the host
    entered none of them."""
    if not s or not set(names) & set(s["seen"]):
        return None
    return sum(s["span_ms"].get(k, 0.0) for k in names) / s["batches"]


def profile(step, n, torch, spans_on):
    """Run ``step(i)`` for i < n under torch.profiler (host and device)
    inside ``spans_on()``, synchronized, and summarize it by span. Returns
    None where the profiler saw no device operation."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof, spans_on():
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    s = summarize(*events(prof), window_s, n)
    return s if s["busy_s"] > 0 else None


_MEASURED = {}


def program_spans():
    """The program's ``spans`` switch (``adalog_tpu_torch.utils.profiling``),
    or None where the program has none."""
    from adalog_tpu_torch.utils import profiling

    return getattr(profiling, "spans", None)


def run_seed(argv=None):
    """The ``--seed`` of the run's command line, or None."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int)
    return ap.parse_known_args(sys.argv[1:] if argv is None else argv)[0].seed


def measure(ctx):
    """The span summary of this run's cell (``summarize``), measured once a
    process; None off the card, without a ``--seed`` on the command line,
    or where the program has no spans. Prints the summary to stderr beside
    the spans-off stretch's window and device ms."""
    if not ctx.get("trace"):
        return None
    import torch

    from portbench import serving

    seed, on = run_seed(), program_spans()
    if seed is None or on is None or not torch.cuda.is_available():
        return None
    arch, tr = ctx["arch"], ctx["traffic"]
    key = (arch["name"], seed)
    if key not in _MEASURED:
        device = torch.device("cuda:0")
        _, _, images, predict = serving.prepare(arch, tr, seed, device)
        n = len(images)
        for i in range(tr["warmup_batches"]):
            predict(images[i % n]).cpu()
        got = profile(lambda i: predict(images[i % n]).cpu(),
                      tr["trace_batches"], torch, on)
        del predict, images
        torch.cuda.empty_cache()
        first = ctx["trace"]
        print("spans: " + json.dumps(dict(
            got or {}, first_window_s=first["window_s"],
            first_device_ms=sum(first["class_ms"].values()))),
            file=sys.stderr)
        _MEASURED[key] = got
    return _MEASURED[key]
