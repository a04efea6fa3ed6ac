"""Tracing / profiling, the counterpart of ``adalog_tpu.utils.profiling``.

The reference has no profiling beyond AverageMeter batch times (SURVEY.md §5).
Here: named spans at the layer boundaries of the forward and of serving
(``span``), switched on for an extent by ``spans``, and a ``torch.profiler``
trace of the host and the CUDA device with the spans on, written as a
Chrome trace that Perfetto and TensorBoard open (``device_trace``).

A span on is a ``torch.profiler.record_function``: it lives on the
profiler's clock, in the same trace as the device events, and nests by its
host extent, so each device operation can be put under the innermost span
that launched it. Off (the default) ``span`` reads one module flag and
returns a shared no-op context. The switch is process-wide.

The spans, by where they are opened:

  serve.predict     serve.py, the callable ``make_predictor`` returns
  serve.h2d         the images' copy to the device and dtype
  serve.forward     the model forward and the logits' cast
  fq.act.<kind>     an activation fake quantizer (models/layers.py; kind:
                    uniform, twin, log2, logsqrt2, adalog)
  fq.weight         a weight quantized at call time
  linear            ``F.linear`` (and a row-parallel site's all_reduce)
  linear.int8       the int8 product with its own quantization (K5)
  linear.fq_gemm    the fused activation-quant GEMM (K4)
  conv              the patch-embedding convolution
  norm, gelu        LayerNorm, GeLU
  attn              qkv output to merged heads (models/vit.py, swin.py,
                    eva.py)
  swin.window       Swin's rolls, window partition and reverse, and the
                    patch merge's gather
  swin.bias         Swin's rel-pos bias gather and shift-mask add
  eva.rope          EVA-02's rotation of q and k (inside attn) and its
                    sine and cosine tables (models/eva.py)
  eva.glu           EVA-02's gated product silu(gate) * value
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator

import torch

log = logging.getLogger("adalog_tpu_torch")


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


_ON = False
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context naming its extent ``name`` in a profiler trace while
    ``spans`` is on; the shared no-op context otherwise. ``name`` is one of
    the module docstring's fixed names."""
    if not _ON:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def spans() -> Iterator[None]:
    """Spans on for the extent of the block; the previous state is restored
    on exit, an exception's too."""
    global _ON
    was, _ON = _ON, True
    try:
        yield
    finally:
        _ON = was


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the host and (where there is one) the CUDA device into
    ``logdir/trace.json``, a Chrome trace that Perfetto and TensorBoard's
    profile plugin open, with the spans on."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, spans():
        try:
            yield prof
        finally:
            _sync()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("device trace written to %s", path)
