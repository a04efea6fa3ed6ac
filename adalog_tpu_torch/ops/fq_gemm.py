"""Fused activation-fake-quant GEMM (kernel K4): y = fq_a(x) @ w_qᵀ (+ b).

The counterpart of ``adalog_tpu.ops.fq_gemm``. The eval forward of a
quantized Linear is y = fq_a(x) @ fq_w(W)ᵀ + b. The weight half does not
depend on the input and is prepared once per loaded model
(ops/routes.py); the activation half is fused into the GEMM: the kernel
fake-quantizes each x tile as it loads it (fp32 math) and the quantized
activations never reach device memory. Unfused, the quantizer is 7 (uniform)
to 20+ (AdaLog) elementwise passes over x.

Kinds (one per site, static):
  'uniform'       asymmetric per-tensor uniform quant
  'adalog_shift'  AdaLog of x + shift with no subtract-back: the post-GeLU
                  fc2 site once its shift is folded into the bias
                  (calib/reparam.py::fold_gelu_shift_into_bias)

``fq_gemm`` is the wrapper: for CPU tensors it runs ``fq_gemm_plain``, the
same math in plain PyTorch; for CUDA tensors it launches a kernel of
``csrc/fq_gemm.cu`` (built at first use, ops/cuda_build.py) or raises.
``fq_gemm.launches`` counts kernel launches, ``fq_gemm.variant_launches``
the same by variant, ``fq_gemm.calls`` every call on either device.

Two hand-written variants (``gemm_variant`` routes; ``variant=`` forces):
  "mma"  the products on the tensor cores, each x element quantized once
         (or once per group of columns), w streamed through a cp.async
         ring. bf16 inputs always take it. fp32 inputs take it when the
         site's weight codes are known (``weight_prep.weight_codes``) and
         every staged integer is exact in bf16: the kernel multiplies the
         integers c - z (or steps * 2^-shift for AdaLog) by c_w - z_w and
         scales the fp32 sum by s * s_w[o] (``_mma_operands`` is the same
         formulation in plain PyTorch).
  "fma"  the first kernels of the port (exact fp32 products on the FMA
         pipes; one unpipelined mma.sync tile for bf16), for fp32 calls
         without weight codes or with integers that are not exact.

Which Linear sites take the kernel, and which variant, is decided once per
loaded model: a predictor's plan (ops/routes.py) holds the ``GemmSite`` of
each (``gemm_site``), and ``qlinear`` calls ``run`` with it. Nothing on the
forward reads a device tensor on the host.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from adalog_tpu_torch.ops import cuda_build
from adalog_tpu_torch.quantizers.logarithm import ADALOG_R

KINDS = ("uniform", "adalog_shift")
VARIANTS = ("auto", "mma", "fma")
# fp32 inputs through variant "mma": every staged operand must be exact in
# bf16 (8 significant bits): uniform codes of at most 8 bits with
# |c - z| <= 256, AdaLog mantissas of at most 4N - 2 <= 254 steps
_MMA_INT_BITS = 8
_MMA_INT_MAX = 256
_MMA_INT_CODE_BITS = 7
_MMA_TABLE_BITS = 8               # the kernel's value table holds 256 codes


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
# Variant "mma" in plain PyTorch: operands, value table, epilogue scales
# ---------------------------------------------------------------------------

class WeightCodes(NamedTuple):
    """A Linear site's quantized weight as integers: ``codes`` (O, K)
    bfloat16 holds c_w - z_w and ``scale`` (O,) float32 the row scales, with
    codes * scale[:, None] == w_q bit for bit. ``weight_prep.weight_codes``
    builds it, and only where every integer is exact in bf16."""
    codes: torch.Tensor
    scale: torch.Tensor


def _adalog_value_table(params, bits: int, steps_only: bool):
    """(2N,) float32: the dequantized value of every adalog_shift code
    0..2N-1 by ``quantize_plain``'s own arithmetic, so an entry is bit-equal
    to what it returns for that code: 2^-shift * (steps * ts) * s with steps
    an integer of at most 4N - 2. ``steps_only`` leaves ts * s out (steps *
    2^-shift, exact in bf16 while 4N - 2 < 256)."""
    s, _, _, q = params.float().unbind()
    N = 2 ** (bits - 1)
    r = torch.tensor(ADALOG_R, dtype=torch.float32, device=params.device)
    ts = torch.tensor(1.0 / (4 * N - 2), dtype=torch.float32,
                      device=params.device)
    prod = torch.arange(2 * N, dtype=torch.float32, device=params.device) * q
    steps = torch.round(torch.exp2(-torch.remainder(prod, ADALOG_R) / r) / ts)
    pow2 = _exp2_neg_int(torch.floor(prod / r))
    return pow2 * steps if steps_only else pow2 * (steps * ts) * s


def _adalog_lookup(x, params, table):
    """adalog_shift of x through a (2N,) table of ``_adalog_value_table``:
    the code by ``quantize_plain``'s arithmetic, its value from the table, 0
    for codes >= 2N."""
    s, _, shift, q = params.float().unbind()
    n_codes = table.shape[0]
    scaled = torch.clamp((x.float() + shift) / s, 1e-15, 1.0)
    code = torch.round(-torch.log2(scaled) * ADALOG_R / q)
    keep = (code < n_codes).to(torch.float32)
    idx = torch.clamp(code, 0.0, n_codes - 1.0).to(torch.int64)
    return table[idx] * keep


def _mma_operands(x, w, params, *, kind: str, bits: int, codes=None):
    """What variant "mma" of the kernel multiplies, in plain PyTorch: (A
    (T, K) bfloat16, B (O, K) bfloat16, the (O,) float32 scale of the sums
    or None).

    bf16 inputs: A is the quantized x rounded to bf16 (AdaLog values from
    the code table), B is w, no scale. fp32 inputs with the site's
    ``codes``: A holds the integers c - z (uniform) or steps * 2^-shift
    (adalog_shift), B the integers c_w - z_w, and the sum of a column o is
    scaled by s * s_w[o] (uniform) or (ts * s) * s_w[o]."""
    int_mode = x.dtype == torch.float32
    s, zp = params[0].float(), params[1].float()
    if kind == "uniform":
        z = torch.round(zp)
        c = torch.clamp(torch.round(x.float() / s) + z, 0.0, 2.0 ** bits - 1)
        a = (c - z) if int_mode else (c - z) * s
        a_scale = s
    else:
        a = _adalog_lookup(x, params,
                           _adalog_value_table(params, bits, int_mode))
        a_scale = torch.tensor(1.0 / (2 ** (bits + 1) - 2),
                               dtype=torch.float32, device=x.device) * s
    if not int_mode:
        return a.to(torch.bfloat16), w, None
    if codes is None:
        raise ValueError("fp32 inputs need the site's weight codes")
    return a.to(torch.bfloat16), codes.codes, a_scale * codes.scale


def _gemm_mma_plain(x, w, params, bias=None, *, kind: str, bits: int,
                    codes=None):
    """Variant "mma" of the kernel, step for step, in plain PyTorch: the
    product of ``_mma_operands`` in fp32, the scale on the sums, the cast,
    the bias. Equal to ``fq_gemm_plain`` bit for bit in its operands for
    bf16 inputs, and up to the rounding of the fp32 products and sums for
    fp32 inputs (integer sums here)."""
    a, b, scale = _mma_operands(x, w, params, kind=kind, bits=bits,
                                codes=codes)
    y = torch.matmul(a.float(), b.float().t())
    if scale is not None:
        y = y * scale
    y = y.to(x.dtype)
    return y if bias is None else y + bias


# ---------------------------------------------------------------------------
# Routing between the two kernel variants
# ---------------------------------------------------------------------------

def activation_ints_exact(params, kind: str, bits: int) -> bool:
    """True when every operand variant "mma" stages for fp32 inputs is exact
    in bf16: uniform codes of at most 8 bits with |c - round(z)| <= 256 for
    every c in 0..2^bits - 1; adalog_shift of at most 7 bits. Reads the zero
    point (on a CUDA tensor that waits for the device), so it belongs where
    a predictor is built, not on a served path."""
    if kind == "adalog_shift":
        return bits <= _MMA_INT_CODE_BITS
    if bits > _MMA_INT_BITS:
        return False
    z = float(torch.round(params[1].float()))
    return 2.0 ** bits - 1 - _MMA_INT_MAX <= z <= _MMA_INT_MAX


def mma_refusal(dtype, kind: str, bits: int, codes,
                exact_ints: bool) -> Optional[str]:
    """Why variant "mma" does not take a call, or None when it does. bf16
    inputs always go; fp32 inputs need the weight ``codes`` and
    ``exact_ints``, the verdict of ``activation_ints_exact``."""
    if dtype != torch.float32:
        return None
    if codes is None:
        return ("fp32 inputs without the site's weight codes: the products "
                "stay exact only through integer operands")
    if kind == "uniform" and bits > _MMA_INT_BITS:
        return (f"fp32 activations of {bits} bits: codes past "
                f"{_MMA_INT_BITS} bits are not exact in bf16")
    if kind == "adalog_shift" and bits > _MMA_INT_CODE_BITS:
        return (f"fp32 AdaLog activations of {bits} bits: 4N - 2 mantissa "
                "steps are not exact in bf16")
    if not exact_ints:
        return ("the zero point of the fp32 activations is out of range: "
                f"|c - z| > {_MMA_INT_MAX} is not exact in bf16")
    return None


def gemm_variant(dtype, kind: str, bits: int, codes, exact_ints: bool,
                 variant: str = "auto") -> str:
    """Which hand-written variant of K4 a call takes: "mma" where it
    applies, else "fma". A forced "mma" that does not take the call
    raises."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: want one of {VARIANTS}")
    why = mma_refusal(dtype, kind, bits, codes, exact_ints)
    if variant == "mma" and why is not None:
        raise ValueError(f"fq_gemm variant 'mma' refused: {why}")
    return "mma" if variant == "mma" or (variant == "auto" and why is None) \
        else "fma"


# ---------------------------------------------------------------------------
# CUDA kernels: load, launch
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library(profile: bool = False):
    """The kernels' library; ``profile`` builds and loads the one whose
    "mma" kernels count their warps' cycles by phase (K4_PROFILE in the
    source)."""
    lib = ctypes.CDLL(cuda_build.build("fq_gemm", ("K4_PROFILE",))) \
        if profile else cuda_build.library("fq_gemm")
    fn = lib.fq_gemm_launch
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if profile:
        lib.fq_gemm_profile.argtypes = [ctypes.c_void_p]
        lib.fq_gemm_profile.restype = ctypes.c_int
    return lib


def _check(x, w, params, bias, kind, bits, codes=None):
    if x.dtype not in _DTYPE_CODE:
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
    if codes is not None and (
            codes.codes.dtype != torch.bfloat16
            or codes.codes.shape != w.shape
            or codes.scale.dtype != torch.float32
            or tuple(codes.scale.shape) != (w.shape[0],)):
        raise ValueError("codes must be WeightCodes((O, K) bfloat16, (O,) "
                         "float32) of w's shape")


def _launch(x, w, params, bias, kind, bits, variant, codes, profile=False):
    """One launch on the current stream. w, params, bias and the codes are
    contiguous and on x's device (the callers see to it)."""
    T, K = x.shape
    O = w.shape[0]
    if x.stride(1) != 1 or (T > 1 and x.stride(0) < K):
        x = x.contiguous()
    out = torch.empty((T, O), dtype=x.dtype, device=x.device)
    if T == 0 or O == 0:
        return out
    int_mode = variant == "mma" and x.dtype == torch.float32
    err = _library(profile).fq_gemm_launch(
        1 if variant == "mma" else 0, _DTYPE_CODE[x.dtype],
        KINDS.index(kind), x.data_ptr(), w.data_ptr(), params.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        codes.codes.data_ptr() if int_mode else None,
        codes.scale.data_ptr() if int_mode else None,
        T, K, O, x.stride(0) if T > 1 else K, bits, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fq_gemm kernel ({variant}) launch failed: CUDA "
                           f"error {err}")
    fq_gemm.launches += 1
    fq_gemm.variant_launches[variant] += 1
    return out


def fq_gemm(x, w, params, bias=None, *, kind: str, bits: int,
            variant: str = "auto", codes: Optional[WeightCodes] = None,
            exact_ints: Optional[bool] = None):
    """y = fq_a(x) @ wᵀ (+ bias) with the activation quantizer fused.

    x: (T, K) float32 or bfloat16 (the compute dtype; rows may be strided);
    w: (O, K) the prepared fake-quantized weight, in x's dtype; params: (4,)
    float32 [scale, zero_point, shift, log_q] (``site_params``; for
    adalog_shift the kernel needs log_q a positive integer with
    (2^bits - 1) * log_q < 2^24, which ``gemm_site`` checks); bias: None or
    (O,) in x's dtype. Returns (T, O) in x's dtype, accumulated in fp32.

    CPU tensors run the plain version; CUDA tensors launch a kernel; any
    other device raises. ``variant`` picks the kernel: "auto" routes by
    ``gemm_variant``, "mma" or "fma" force one (a forced "mma" that does not
    take the call raises, on the CPU too). fp32 inputs reach "mma" only with
    ``codes``, the ``WeightCodes`` of w, and ``exact_ints``, the verdict of
    ``activation_ints_exact`` (None has the wrapper read the zero point
    itself where the answer decides, which waits for the device)."""
    _check(x, w, params, bias, kind, bits, codes)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: want one of {VARIANTS}")
    fq_gemm.calls += 1
    cpu = x.device.type == "cpu"
    if not cpu and x.device.type != "cuda":
        raise RuntimeError(f"fq_gemm has no path for {x.device}")
    if not cpu or variant != "auto":
        if exact_ints is None:
            exact_ints = variant != "fma" and mma_refusal(
                x.dtype, kind, bits, codes, True) is None \
                and activation_ints_exact(params, kind, bits)
        variant = gemm_variant(x.dtype, kind, bits, codes, bool(exact_ints),
                               variant)
    if cpu:
        return fq_gemm_plain(x, w, params, bias, kind=kind, bits=bits)
    tensors = (w, params) + (() if bias is None else (bias,)) \
        + (tuple(codes) if codes is not None else ())
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all fq_gemm inputs must be on {x.device}")
    if codes is not None:
        codes = WeightCodes(codes.codes.contiguous(),
                            codes.scale.contiguous())
    return _launch(x, w.contiguous(), params.contiguous(),
                   None if bias is None else bias.contiguous(), kind, bits,
                   variant, codes)


fq_gemm.launches = 0
fq_gemm.calls = 0
fq_gemm.variant_launches = {"mma": 0, "fma": 0}

# the phases variant "mma" counts its cycles by
GEMM_PHASES = ("set-up: first loads, table, the resident row tile",
               "waiting for the ring and at the barrier",
               "starting the next stage's loads", "products (ldmatrix, mma)",
               "the next stage's quantizer (wide-N order)", "epilogue")


def gemm_phase_cycles(x, w, params, bias=None, *, kind: str, bits: int,
                      codes: Optional[WeightCodes] = None):
    """{phase: cycles summed over the warps} of one launch of variant "mma"
    on these inputs, from a second build of the kernel that reads clock64
    between its phases (K4_PROFILE; the timers cost it some registers and
    time, so the shares are the result, not the sum). Same arguments as
    ``fq_gemm``; CUDA tensors only; waits for the device, and reads the
    zero point."""
    _check(x, w, params, bias, kind, bits, codes)
    if x.device.type != "cuda":
        raise RuntimeError("gemm_phase_cycles times the kernel on a GPU")
    gemm_variant(x.dtype, kind, bits, codes,
                 activation_ints_exact(params, kind, bits), "mma")
    lib = _library(True)
    cycles = (ctypes.c_ulonglong * 8)()
    with torch.cuda.device(x.device):
        torch.cuda.synchronize()
        err = lib.fq_gemm_profile(cycles)            # reads, then zeroes
        _launch(x, w.contiguous(), params.contiguous(),
                None if bias is None else bias.contiguous(), kind, bits,
                "mma", codes, profile=True)
        torch.cuda.synchronize()
        err = err or lib.fq_gemm_profile(cycles)
    if err != 0:
        raise RuntimeError(f"fq_gemm profile read failed: CUDA error {err}")
    return dict(zip(GEMM_PHASES, cycles[:len(GEMM_PHASES)]))


# ---------------------------------------------------------------------------
# Sites
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
    asks whether the kernels are on; here that is the predictor's switch,
    and ``routes.build`` calls this once per site at load time.)"""
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


@dataclass(frozen=True)
class GemmSite:
    """What ``run`` needs of a site, all decided and checked where the
    predictor is built. ``params`` is the (4,)
    float32 vector on the device; ``codes`` the site's ``WeightCodes`` or
    None; ``mma_fp32`` whether fp32 inputs take variant "mma" (codes known
    and every staged integer exact in bf16). bf16 inputs always do."""
    kind: str
    bits: int
    params: torch.Tensor
    codes: Optional[WeightCodes] = None
    mma_fp32: bool = False

    def variant(self, dtype) -> str:
        return "mma" if dtype == torch.bfloat16 or self.mma_fp32 else "fma"


def gemm_site(name, site, codes: Optional[WeightCodes] = None) -> GemmSite:
    """The ``GemmSite`` of a Linear site that ``supports`` takes, params on
    the state's device. ``codes`` are the site's ``weight_prep.weight_codes``,
    without which fp32 inputs stay on variant "fma". Reads an AdaLog site's
    base and a uniform site's zero point on the host, once, and raises if
    the kernel cannot take the site."""
    kind, bits = kernel_kind(site), site.aq.bits
    if kind == "adalog_shift":
        _check_base(name, site.aq)
    params = site_params(site.aq).contiguous()
    if codes is not None:
        codes = WeightCodes(codes.codes.to(params.device).contiguous(),
                            codes.scale.to(params.device).contiguous())
    mma_fp32 = codes is not None and mma_refusal(
        torch.float32, kind, bits, codes,
        activation_ints_exact(params, kind, bits)) is None
    return GemmSite(kind, bits, params, codes, mma_fp32)


def run(site: GemmSite, x, w, bias=None):
    """The served call of a site: ``fq_gemm`` with the variant, the codes and
    every check on the site's own tensors taken from ``site``, where
    ``gemm_site`` settled them; w (O, K) and bias come prepared
    (contiguous, in x's dtype, on its device)."""
    fq_gemm.calls += 1
    if x.device.type == "cpu":
        return fq_gemm_plain(x, w, site.params, bias, kind=site.kind,
                             bits=site.bits)
    if x.device.type != "cuda":
        raise RuntimeError(f"fq_gemm has no path for {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype \
            or (bias is not None and bias.dtype != x.dtype):
        raise TypeError("x, w and bias must share float32 or bfloat16")
    if w.device != x.device or site.params.device != x.device \
            or (bias is not None and bias.device != x.device):
        raise ValueError(f"all fq_gemm inputs must be on {x.device}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[1] != x.shape[1] \
            or not w.is_contiguous() \
            or (bias is not None and (not bias.is_contiguous()
                                      or bias.shape[0] != w.shape[0])) \
            or (site.codes is not None
                and site.codes.codes.shape != w.shape):
        raise ValueError(f"x must be (T, K), w (O, K) contiguous, bias (O,) "
                         f"and the site's codes (O, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    return _launch(x, w, site.params, bias, site.kind, site.bits,
                   site.variant(x.dtype), site.codes)
