"""The profiler pass and what is read from it: device busy time, device
time by kernel class and by name, and the idle gaps between device events
named by what the host was doing then.

``busy_us`` and the profiler loop follow ``chip_smoke.py::busy_us`` and
``profile_phase`` (lines 3684-3756 at the commit that added this
benchmark). ``kernel_class`` is chip_smoke's ``kernel_class`` (lines
3671-3681) corrected: the port's own kernels K1 to K5 are matched by name
before cuBLAS's "gemm", so the int8 GEMM (K5) no longer counts as cuBLAS,
and the attention matmul kernels (K2, K3) no longer count as "other".
"""

from __future__ import annotations

import time

import numpy as np

TOP = 10


def kernel_class(name):
    """'copy', K1..K5, 'GEMM' (cuBLAS / cuDNN products and convolutions) or
    'other'."""
    n = name.lower()
    if n.startswith(("memcpy", "memset")):
        return "copy"
    if "fq_flash_attn" in n:
        return "K1"
    if "fq_softmax_matmul" in n:
        return "K2"
    if any(k in n for k in ("fq_adalog_matmul", "fq_uniform_matmul",
                            "fq_attn_matmul")):
        return "K3"
    if "fq_gemm" in n:
        return "K4"
    if "int8_gemm" in n:
        return "K5"
    if any(k in n for k in ("gemm", "conv", "xmma", "cutlass", "fprop",
                            "nvjet", "cudnn")):
        return "GEMM"
    return "other"


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile(step, n, torch):
    """Run ``step(i)`` for i < n under torch.profiler (host and device
    activities), synchronized, and summarize the trace. Returns None where
    the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CUDA]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU]
    if not dev:
        return None
    return summarize(dev, host, window_s, n)


def summarize(dev, host, window_s, n):
    """dev, host: [(name, start us, end us)]. The trace's summary: busy and
    window seconds, device ms by class and by name, top device operations,
    idle gaps named by the innermost host event spanning each."""
    spans = [(a, b) for _, a, b in dev]
    by_class, by_name = {}, {}
    for name, a, b in dev:
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + (b - a) / 1e3
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    merged = _merged(spans)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])
            if a1 > b0]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = {}
    if host and gaps:
        hs = np.array([a for _, a, _ in host], dtype=np.float64)
        he = np.array([b for _, _, b in host], dtype=np.float64)
        for a, b in gaps[:200]:
            mid = 0.5 * (a + b)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            if inside.size:
                k = inside[np.argmin(he[inside] - hs[inside])]
                what = host[k][0]
            else:
                what = "(no host event)"
            idle[what] = idle.get(what, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "batches": n,
        "window_s": window_s,
        "busy_s": busy_us(spans) / 1e6,
        "class_ms": by_class,
        "name_ms": by_name,
        "device_ops": [[k[:160], v / 1e3] for k, v in top],
        "idle_gaps": [[k[:160], v] for k, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }
