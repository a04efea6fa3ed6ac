"""Fused activation-fake-quant GEMM (kernel K4): y = fq_a(x) @ w_qᵀ (+ b).

The counterpart of ``adalog_tpu.ops.fq_gemm``. The eval forward of a
quantized Linear is y = fq_a(x) @ fq_w(W)ᵀ + b. The weight half does not
depend on the input and is prepared once per loaded model
(ops/weight_prep.py); the activation half is fused into the GEMM: the kernel
fake-quantizes each x tile as it loads it (fp32 math) and the quantized
activations never reach device memory. Unfused, the quantizer is 7 (uniform)
to 20+ (AdaLog) elementwise passes over x.

Kinds (one per site, static):
  'uniform'       asymmetric per-tensor uniform quant
  'adalog_shift'  AdaLog of x + shift with no subtract-back: the post-GeLU
                  fc2 site once its shift is folded into the bias
                  (calib/reparam.py::fold_gelu_shift_into_bias)

``fq_gemm`` is the wrapper: for CPU tensors it runs ``fq_gemm_plain``, the
same math in plain PyTorch; for CUDA tensors it launches the kernel in
``csrc/fq_gemm.cu`` (built at first use, ops/cuda_build.py) or raises.
``fq_gemm.launches`` counts kernel launches, ``fq_gemm.calls`` every call on
either device.

Which Linear sites take the kernel is decided once per loaded model:
``prepare`` builds {site: (kind, bits, params on the device)}, a predictor
enters ``activate(table)`` around its forward, and ``qlinear`` looks its
site up. Nothing on the forward reads a device tensor on the host.
"""

from __future__ import annotations

import contextvars
import ctypes
import functools
from contextlib import contextmanager

import torch

from adalog_tpu_torch.ops import cuda_build
from adalog_tpu_torch.quantizers.logarithm import ADALOG_R

KINDS = ("uniform", "adalog_shift")


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _pow2_neg(f):
    """2**(-f) for integer-valued 0 <= f <= 126, from the exponent bits."""
    return torch.bitwise_left_shift(127 - f.to(torch.int32), 23).view(
        torch.float32)


def _exp2_neg_int(f):
    """2**(-f) for any non-negative integer-valued f, exact: subnormal from
    f = 127 to 149 and 0 beyond, as IEEE exp2 gives it."""
    lo = torch.clamp(f, max=126.0)
    return _pow2_neg(lo) * _pow2_neg(torch.clamp(f - lo, max=126.0))


def quantize_plain(x, params, *, kind: str, bits: int):
    """fq_a(x) in fp32 with params [scale, zero_point, shift, log_q]: the
    quantizer of the JAX kernel's ``_quantize_tile``."""
    x = x.float()
    s, zp, shift, q = params.float().unbind()
    N = 2 ** (bits - 1)
    if kind == "uniform":
        z = torch.round(zp)
        c = torch.clamp(torch.round(x / s) + z, 0.0, 2.0 * N - 1)
        return (c - z) * s
    # divisors as tensors: PyTorch's CUDA kernels divide by a Python number
    # as a multiply by its reciprocal, which is not the kernel's division
    r = torch.tensor(ADALOG_R, dtype=torch.float32, device=x.device)
    ts = torch.tensor(1.0 / (4 * N - 2), dtype=torch.float32, device=x.device)
    scaled = torch.clamp((x + shift) / s, 1e-15, 1.0)
    code = torch.round(-torch.log2(scaled) * ADALOG_R / q)
    keep = (code < 2 * N).to(torch.float32)
    code = torch.clamp(code, 0.0, 2.0 * N - 1)
    prod = code * q
    mant = torch.round(torch.exp2(-torch.remainder(prod, ADALOG_R) / r)
                       / ts) * ts
    dq = _exp2_neg_int(torch.floor(prod / r)) * mant
    return dq * keep * s       # the shift stays: it is folded into the bias


def fq_gemm_plain(x, w, params, bias=None, *, kind: str, bits: int):
    """The kernel's math in plain PyTorch; same arguments as ``fq_gemm``.

    The quantized x is rounded to x's dtype, the product accumulates in
    fp32 and is rounded to x's dtype, then the bias is added in that dtype
    (the JAX kernel's output cast, then ``qlinear``'s bias add)."""
    xq = quantize_plain(x, params, kind=kind, bits=bits).to(x.dtype)
    y = torch.matmul(xq.float(), w.float().t()).to(x.dtype)
    return y if bias is None else y + bias


# ---------------------------------------------------------------------------
# CUDA kernel: load, launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.library("fq_gemm")
    fn = lib.fq_gemm_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(x, w, params, bias, kind, bits):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fq_gemm takes float32 or bfloat16, not {x.dtype}")
    if w.dtype != x.dtype or (bias is not None and bias.dtype != x.dtype):
        raise TypeError("x, w and bias must share one dtype")
    if x.dim() != 2 or w.dim() != 2 or w.shape[1] != x.shape[1] \
            or x.shape[1] == 0:
        raise ValueError(f"x must be (T, K) and w (O, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[0],):
        raise ValueError(f"bias must be ({w.shape[0]},), got "
                         f"{tuple(bias.shape)}")
    if tuple(params.shape) != (4,) or params.dtype != torch.float32:
        raise ValueError("params must be (4,) float32 [scale, zero_point, "
                         "shift, log_q]")
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: want one of {KINDS}")
    if not 1 <= bits <= 16:
        raise ValueError(f"bit width {bits} outside 1..16")


def _launch(x, w, params, bias, kind, bits):
    dev = x.device
    for t in (w, params) + (() if bias is None else (bias,)):
        if t.device != dev:
            raise ValueError(f"all fq_gemm inputs must be on {dev}")
    T, K = x.shape
    O = w.shape[0]
    if x.stride(1) != 1 or (T > 1 and x.stride(0) < K):
        x = x.contiguous()
    w, params = w.contiguous(), params.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((T, O), dtype=x.dtype, device=dev)
    if T == 0 or O == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fq_gemm_launch(
            1 if x.dtype == torch.bfloat16 else 0, KINDS.index(kind),
            x.data_ptr(), w.data_ptr(), params.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            T, K, O, x.stride(0) if T > 1 else K, bits, stream)
    if err != 0:
        raise RuntimeError(f"fq_gemm kernel launch failed: CUDA error {err}")
    fq_gemm.launches += 1
    return out


def fq_gemm(x, w, params, bias=None, *, kind: str, bits: int):
    """y = fq_a(x) @ wᵀ (+ bias) with the activation quantizer fused.

    x: (T, K) float32 or bfloat16 (the compute dtype; rows may be strided);
    w: (O, K) the prepared fake-quantized weight, in x's dtype; params: (4,)
    float32 [scale, zero_point, shift, log_q] (``site_params``; for
    adalog_shift the kernel needs log_q a positive integer with
    (2^bits - 1) * log_q < 2^24, which ``prepare`` checks); bias: None or
    (O,) in x's dtype. Returns (T, O) in x's dtype, accumulated in fp32.

    CPU tensors run the plain version; CUDA tensors launch the kernel; any
    other device raises."""
    _check(x, w, params, bias, kind, bits)
    fq_gemm.calls += 1
    if x.device.type == "cpu":
        return fq_gemm_plain(x, w, params, bias, kind=kind, bits=bits)
    if x.device.type != "cuda":
        raise RuntimeError(f"fq_gemm has no path for {x.device}")
    return _launch(x, w, params, bias, kind, bits)


fq_gemm.launches = 0
fq_gemm.calls = 0


# ---------------------------------------------------------------------------
# Sites, and the load-time dispatch table
# ---------------------------------------------------------------------------

def site_params(aq) -> torch.Tensor:
    """Pack a QuantizerState into the kernel's (4,) float32 param vector
    [scale, zero_point, shift, log_q] (unused slots zero)."""
    def first(a):
        if a is None:
            return torch.zeros((), dtype=torch.float32, device=aq.scale.device)
        return a.reshape(-1)[0].to(torch.float32)

    return torch.stack([first(aq.scale), first(aq.zero_point),
                        first(aq.shift), first(aq.log_q)])


def supports(site, mode: str) -> bool:
    """Can this Linear site's eval forward run through the fused kernel?
    Per-tensor asymmetric uniform sites always; shifted AdaLog sites once
    the GeLU shift has been folded into the bias. (JAX's ``supports`` also
    asks whether the kernels are on; here that is whether a table is
    active, and ``prepare`` calls this once per site at load time.)"""
    if mode != "quant":
        return False
    aq = site.aq
    if aq.bits == 32:
        return False
    if aq.kind == "uniform" and not aq.symmetric and aq.scale.numel() == 1:
        return True
    if aq.kind == "adalog" and aq.shifted:
        return aq.bias_reparamed is not None and bool(aq.bias_reparamed)
    return False


def kernel_kind(site) -> str:
    return "uniform" if site.aq.kind == "uniform" else "adalog_shift"


def _check_base(name, aq):
    """The kernel takes an AdaLog base q that is a positive integer with
    (2^bits - 1) * q < 2^24, so that code * q is an exact integer in fp32
    (a calibrated base always is: state.py's integer base numerator)."""
    q = float(aq.log_q.reshape(-1)[0])
    if q != round(q) or q < 1 or (2 ** aq.bits - 1) * q >= 2 ** 24:
        raise ValueError(f"{name}: AdaLog base log_q={q} is not a positive "
                         f"integer below 2^24 / (2^{aq.bits} - 1); the fused "
                         "GEMM kernel cannot take this site")


def prepare(qstate) -> dict:
    """{site name: (kind, bits, params)} for every Linear site of
    ``qstate`` that takes the kernel, params on the qstate's device. Reads
    each AdaLog site's base on the host, once, and raises if the kernel
    cannot take it."""
    from adalog_tpu_torch.models.layers import LinearSite

    table = {}
    with torch.no_grad():
        for name, site in qstate.items():
            if not (isinstance(site, LinearSite) and supports(site, "quant")):
                continue
            kind = kernel_kind(site)
            if kind == "adalog_shift":
                _check_base(name, site.aq)
            table[name] = (kind, site.aq.bits, site_params(site.aq))
    return table


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "adalog_fq_gemm_table", default=None)


@contextmanager
def activate(table):
    """Route the Linear sites of ``table`` (from ``prepare``) through
    ``fq_gemm`` inside the block; None leaves every site on the plain path."""
    tok = _ACTIVE.set(table)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def enabled() -> bool:
    return _ACTIVE.get() is not None


def lookup(name):
    """(kind, bits, params) of site ``name`` in the active table, or None."""
    table = _ACTIVE.get()
    if table is None or name is None:
        return None
    return table.get(name)
