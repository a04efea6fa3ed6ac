"""One pass for each served activation fake quantizer (kernel K6).

The eval forward of a quantized Linear site fake-quantizes its input with
``quantizers.apply.apply_quantizer``, which PyTorch runs eagerly as a chain
of elementwise kernels: about 20 passes over x at an AdaLog site, about 6 at
a uniform one. K6 (``csrc/fq_act.cu``) is the same chain in one launch that
reads x once and writes the result once, bit for bit what the chain gives
on the card, NaN where it gives NaN. It replaces no TPU kernel: the JAX
package leaves this quantizer to XLA's fusion.

``fq_act_quant`` is the wrapper: for a CPU tensor it runs the plain
version, which is ``apply_quantizer`` itself; for a CUDA tensor it launches
the kernel or raises. ``fq_act_quant.launches`` counts kernel launches,
``fq_act_quant.variant_launches`` the same by quantizer kind ("uniform",
"adalog"), ``fq_act_quant.calls`` every call on either device.

Which sites take it is decided once per loaded model, from what the state
shows: ``act_site`` builds the ``ActSite`` of an activation quantizer that
is uniform (either sign) or AdaLog (shifted or not), of at most
``MAX_BITS`` bits, with one-element float32 parameters and a positive
normal scale; it holds every value that depends on the state alone, from
PyTorch's own evaluation on the state's device (the scale, the rounded zero
point, k = 37 / q, the shift and its shift-back term, the value of each
AdaLog code times the scale), read on the host there, once. A predictor's
plan (ops/routes.py) gives every Linear site K6 takes one, and
``models.layers.qlinear`` sends such a site's input to ``fq_act_quant``
outside training and soft rounding, which launches K6 or raises (a float16
input, rows that fold into no single stride: neither occurs in a served
forward). Sites of other kinds or with per-channel parameters stay on
``apply_quantizer``. Calibration and BRECQ enter no plan. Nothing on the
forward reads a device tensor on the host, and the input is never written.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from adalog_tpu_torch.ops import cuda_build
from adalog_tpu_torch.quantizers.apply import apply_quantizer
from adalog_tpu_torch.quantizers.logarithm import ADALOG_R, adalog_dequant_code
from adalog_tpu_torch.quantizers.ste import round_ste

MAX_BITS = 8          # the kernel's AdaLog table holds 2N = 256 codes
TABLE_MAX = 2 ** MAX_BITS
KINDS = ("uniform", "adalog")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FLT_MIN = 2.0 ** -126
_FLT_MAX = float(torch.finfo(torch.float32).max)


class Params(ctypes.Structure):
    """csrc/fq_act.cu's FqActParams: what the kernel reads of a site."""
    _fields_ = [("scale", ctypes.c_float), ("zp", ctypes.c_float),
                ("lo", ctypes.c_float), ("hi", ctypes.c_float),
                ("k", ctypes.c_float), ("shift", ctypes.c_float),
                ("back", ctypes.c_float), ("shifted", ctypes.c_int),
                ("n_table", ctypes.c_int),
                ("table", ctypes.c_float * TABLE_MAX)]


class ActSite(NamedTuple):
    """A site of the table: ``qs`` its activation quantizer (the plain
    version's state), ``kind`` "uniform" or "adalog", ``code`` the kernel's
    kind (0 asymmetric uniform, 1 symmetric uniform, 2 AdaLog) and
    ``params`` the kernel's parameters."""
    qs: object
    kind: str
    code: int
    params: Params


# ---------------------------------------------------------------------------
# Sites
# ---------------------------------------------------------------------------

def _state_tensors(aq):
    out = [aq.scale]
    if aq.kind == "uniform" and not aq.symmetric:
        out.append(aq.zero_point)
    if aq.kind == "adalog":
        out.append(aq.log_q)
    if aq.shifted:
        out += [aq.shift, aq.bias_reparamed]
    return out


def refusal(aq) -> Optional[str]:
    """Why K6 does not take an activation quantizer, from its structure
    alone (no device read); None when it may (``site_params`` then checks
    the scale's value)."""
    if aq.kind not in KINDS:
        return f"kind {aq.kind!r}: K6 takes uniform and AdaLog quantizers"
    if not 1 <= aq.bits <= MAX_BITS:
        return f"{aq.bits} bits: K6 takes 1 to {MAX_BITS}"
    for t in _state_tensors(aq):
        if t is None or t.numel() != 1:
            return "per-channel parameters: K6 takes one-element ones"
        if t is not aq.bias_reparamed and t.dtype != torch.float32:
            return f"{t.dtype} parameters: the eager chain would promote x"
    return None


def site_params(aq) -> Optional[Params]:
    """The kernel's parameters of a quantizer that ``refusal`` lets through,
    each from PyTorch's own evaluation on the state's device, as the eager
    chain forms it, read on the host in one transfer; None where the scale
    is not a positive normal number whose reciprocal is one too."""
    N = 2 ** (aq.bits - 1)
    vals = [aq.scale]
    if aq.kind == "uniform" and not aq.symmetric:
        vals.append(round_ste(aq.zero_point))
    if aq.kind == "adalog":
        codes = torch.arange(2 * N, dtype=torch.float32,
                             device=aq.scale.device)
        vals += [ADALOG_R / aq.log_q,
                 adalog_dequant_code(codes, aq.log_q, bits=aq.bits)
                 * aq.scale]
    if aq.shifted:
        vals += [aq.shift,
                 aq.shift * (1.0 - aq.bias_reparamed.to(torch.float32))]
    host = torch.cat([v.reshape(-1) for v in vals]).tolist()
    scale = host.pop(0)
    if not (_FLT_MIN <= scale <= _FLT_MAX and 1.0 / scale >= _FLT_MIN):
        return None
    p = Params(scale=scale)
    if aq.kind == "uniform":
        p.lo, p.hi = (-N, N - 1) if aq.symmetric else (0, 2 * N - 1)
        if not aq.symmetric:
            p.zp = host.pop(0)
    else:
        p.k = host.pop(0)
        if not math.isfinite(p.k):
            return None
        p.n_table = 2 * N
        p.table[:2 * N] = host[:2 * N]
        del host[:2 * N]
    if aq.shifted:
        p.shifted = 1
        p.shift, p.back = host
    return p


def act_site(aq) -> Optional[ActSite]:
    """The ``ActSite`` of an activation quantizer that K6 takes (``refusal``
    and ``site_params`` let it through), else None. Reads its parameters on
    the host once, so it belongs where a predictor is built."""
    if refusal(aq) is not None:
        return None
    prm = site_params(aq)
    if prm is None:
        return None
    code = 2 if aq.kind == "adalog" else int(bool(aq.symmetric))
    return ActSite(aq, aq.kind, code, prm)


# ---------------------------------------------------------------------------
# The input's layout
# ---------------------------------------------------------------------------

def row_layout(x):
    """(rows, cols, row stride) of x read as rows of its last dimension:
    one row for a contiguous x; for a strided one, its leading dimensions
    must fold into one row stride and its last be contiguous (a slice of
    rows such as the class token's). None where they do not."""
    if x.is_contiguous():
        return 1, x.numel(), x.numel()
    if x.dim() < 2 or x.stride(-1) != 1:
        return None
    cols = x.shape[-1]
    lead = [(n, s) for n, s in zip(x.shape[:-1], x.stride()[:-1]) if n != 1]
    for (_, s), (n2, s2) in zip(lead, lead[1:]):
        if s != s2 * n2:
            return None
    lda = lead[-1][1]
    if lda < cols:
        return None
    return math.prod(n for n, _ in lead), cols, lda


# ---------------------------------------------------------------------------
# CUDA kernel: load, launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.library("fq_act")
    fn = lib.fq_act_quant_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fq_act_params_bytes.restype = ctypes.c_int
    if lib.fq_act_params_bytes() != ctypes.sizeof(Params):
        raise RuntimeError("csrc/fq_act.cu's FqActParams differs from "
                           "ops/fq_act.py's Params")
    return lib


def fq_act_quant(site: ActSite, x):
    """The fake-quantized x of a table site, a new tensor of x's shape and
    dtype (x is not written). A CPU tensor runs the plain version,
    ``apply_quantizer``; a CUDA tensor launches K6 on the current stream,
    or raises for another dtype than float32 or bfloat16 or for rows that
    ``row_layout`` does not read; any other device raises."""
    fq_act_quant.calls += 1
    if x.device.type == "cpu":
        return apply_quantizer(site.qs, x)
    if x.device.type != "cuda":
        raise RuntimeError(f"fq_act_quant has no path for {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fq_act_quant takes float32 or bfloat16 x, not "
                        f"{x.dtype}")
    layout = row_layout(x)
    if layout is None:
        raise ValueError(f"fq_act_quant: the rows of x {tuple(x.shape)} "
                         f"(strides {x.stride()}) are not evenly strided")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    rows, cols, lda = layout
    err = _library().fq_act_quant_launch(
        site.code, _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), rows,
        cols, lda, ctypes.addressof(site.params), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fq_act_quant kernel launch failed: CUDA error "
                           f"{err}")
    fq_act_quant.launches += 1
    fq_act_quant.variant_launches[site.kind] += 1
    return out


fq_act_quant.launches = 0
fq_act_quant.calls = 0
fq_act_quant.variant_launches = {k: 0 for k in KINDS}
