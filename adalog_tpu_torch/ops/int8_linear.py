"""True-integer execution of quantized Linear sites (kernel K5).

The counterpart of ``adalog_tpu.ops.int8_linear``. For a site whose
activation quantizer is uniform, asymmetric and per-tensor and whose weight
quantizer is uniform, both at most 7 bits, the quantized forward is an
integer product:

    y = (x_int @ w_intᵀ) * (s_a * s_w[o]) (+ b)
    x_int = clamp(round(x / s_a) + round(z_a), 0, 2^bits - 1) - round(z_a)
    w_int = clamp(round(w / s_w) + round(z_w), 0, 2^bits - 1) - round(z_w)

Both operands fit int8 and the int32 sum is exact, so the result is the
fake-quant forward up to the rounding of its fp32 products.

``int8_gemm`` is the wrapper of the kernel: for CPU tensors it runs
``int8_gemm_plain`` (an exact int32 product in plain PyTorch); for CUDA
tensors it launches the kernels of ``csrc/int8_gemm.cu`` (built at first
use, ops/cuda_build.py) or raises. ``int8_gemm.launches`` counts the
wrapper's launches, one a call whatever the variant launches on the card
(a forward's count over its sites' is the number of forwards),
``int8_gemm.variant_launches`` the same by variant, ``int8_gemm.calls``
every call on either device. ``int8_qlinear`` is the call of one site.

Three hand-written variants (``int8_variant`` routes to the first that
takes the call; ``variant=`` forces one):
  "wgmma"        the design for Hopper: each x element quantized once per
                 row tile into resident int8 codes, w through a TMA ring
                 into wgmma, two consumer warpgroups in ping-pong so one
                 tile's stores overlap the next tile's products. It takes K
                 a multiple of 16 up to WGMMA_K_MAX, x's rows 16-byte
                 aligned and O * itemsize a multiple of 16
                 (``wgmma_refusal``): every int8 site of the served models
                 but eva02's fc2.
  "wgmma_codes"  two launches: x's codes written once to a scratch buffer,
                 then "wgmma"'s block with the codes' slabs and w both
                 through the ring. Any K and any x layout; O * itemsize a
                 multiple of 16 (``wgmma_codes_refusal``): eva02's fc2 (K =
                 2730, rows of 10,920 bytes).
  "mma"          the first kernel (mma.sync, a cp.async double buffer, x
                 quantized again for every 128-column tile), for the rest
                 (bf16 outputs of an odd number of 8-column groups, such as
                 eva02's fc1 in bf16).
All equal ``int8_gemm_plain`` bit for bit. The kernels read w's rows a
multiple of 16 bytes apart (TMA's pitch): ``site_weights`` keeps each
site's codes so (``pitched_codes``), and a call with other codes pads a
copy.

Which sites run here is decided once per loaded model: a predictor's plan
(ops/routes.py) holds the ``Int8Weights`` of every supported site
(``site_weights``), from the module the predictor runs (already cast to
the eval dtype, so bf16 serving derives its codes from bf16 weights), and
``qlinear`` hands them to ``int8_qlinear``. There is no process-global
switch: JAX's ``set_enabled`` turns int8 on for
every later forward of the process, here only the predictor's own calls
take it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from adalog_tpu_torch.ops import cuda_build

MAX_BITS = 7        # codes of at most 7 bits and their zero points fit int8
_INT8_MAX = 127
VARIANTS = ("auto", "wgmma", "wgmma_codes", "mma")
# the largest K whose codes stay resident in "wgmma"'s shared memory
# (csrc/int8_gemm.cu: W_KMAX)
WGMMA_K_MAX = 2176
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


class WeightMap(NamedTuple):
    """The TMA tensor map "wgmma" and "wgmma_codes" read ``w_int`` through
    (``blob``, 128 bytes), with the address, shape and row pitch in bytes
    it was encoded for."""
    ptr: int
    shape: tuple
    pitch: int
    blob: bytes


class Int8Weights(NamedTuple):
    """What the kernel needs of a site: ``w_int`` (O, K) int8 holds
    c_w - round(z_w), rows 16-byte aligned (``pitched_codes``);
    ``scale_row`` (O,) float32 is s_a * s_w[o], the one
    fp32 product JAX forms per call; ``a_params`` (2,) float32 is the
    activation quantizer's [scale, zero point]; ``w_map`` the tensor map of
    w_int (``weight_map``), encoded once where the predictor is built, on the
    card only (None on the CPU)."""
    w_int: torch.Tensor
    scale_row: torch.Tensor
    a_params: torch.Tensor
    w_map: Optional[WeightMap] = None


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def activation_codes(x, a_params, *, bits: int):
    """c - round(z) of x's uniform quantizer, as float32 integers. The
    division is by a tensor (PyTorch's CUDA kernels divide by a Python
    number as a multiply by its reciprocal)."""
    s, z = a_params[0], torch.round(a_params[1])
    return torch.clamp(torch.round(x.float() / s) + z, 0.0,
                       2.0 ** bits - 1) - z


def int8_gemm_plain(x, w_int, a_params, scale_row, bias=None, *, bits: int):
    """The kernel's function in plain PyTorch; same arguments as
    ``int8_gemm``. The integer sum is exact: an int32 product on the CPU;
    CUDA has none, so there the codes multiply in float64, whose sums are
    exact while |sum| <= 127^2 K < 2^53. Then, as JAX: the sum to float32,
    times scale_row, plus the bias in float32, one rounding to x's dtype."""
    a = activation_codes(x, a_params, bits=bits)
    if x.device.type == "cpu":
        acc = torch.mm(a.to(torch.int32), w_int.to(torch.int32).t())
    else:
        acc = torch.mm(a.double(), w_int.double().t()).to(torch.int32)
    y = acc.float() * scale_row
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Routing between the two kernel variants
# ---------------------------------------------------------------------------

def wgmma_refusal(T: int, K: int, O: int, lda: int, x_ptr_mod16: int,
                  dtype) -> Optional[str]:
    """Why variant "wgmma" does not take a call with x (T, K) of row stride
    ``lda`` (elements) at an address that is ``x_ptr_mod16`` past a
    multiple of 16, w (O, K) and an output of ``dtype``; None when it does.
    T takes no part: rows past T in the last 64-row tile are computed and
    never stored."""
    item = _ITEMSIZE[dtype]
    if K % 16:
        return (f"K = {K} is not a multiple of 16: w's rows are the TMA "
                "copy's row pitch")
    if (lda * item) % 16 or x_ptr_mod16 % 16:
        return ("x's row stride or base is not 16-byte aligned: its rows "
                "load as 16-byte pieces")
    if (O * item) % 16:
        return (f"O = {O}: output rows of {O * item} bytes do not leave as "
                "16-byte pieces")
    if K > WGMMA_K_MAX:
        return (f"K = {K} past the {WGMMA_K_MAX} whose codes stay resident "
                "in shared memory")
    return None


def wgmma_codes_refusal(T: int, K: int, O: int, lda: int, x_ptr_mod16: int,
                        dtype) -> Optional[str]:
    """Why variant "wgmma_codes" does not take a call (arguments as
    ``wgmma_refusal``); None when it does. Its codes pass reads x in any
    layout and its ring takes any K, so only the output rows count."""
    item = _ITEMSIZE[dtype]
    if (O * item) % 16:
        return (f"O = {O}: output rows of {O * item} bytes do not leave as "
                "16-byte pieces")
    return None


_REFUSALS = {"wgmma": wgmma_refusal, "wgmma_codes": wgmma_codes_refusal}


def int8_variant(T: int, K: int, O: int, lda: int, x_ptr_mod16: int, dtype,
                 variant: str = "auto") -> str:
    """Which hand-written variant of K5 a call takes: "wgmma" where it
    applies, else "wgmma_codes" where it applies, else "mma". A forced
    "wgmma" or "wgmma_codes" that does not take the call raises."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: want one of {VARIANTS}")
    if variant == "mma":
        return "mma"
    for v, refusal in _REFUSALS.items():
        why = refusal(T, K, O, lda, x_ptr_mod16, dtype)
        if variant == v and why is not None:
            raise ValueError(f"int8_gemm variant {v!r} refused: {why}")
        if variant in (v, "auto") and why is None:
            return v
    return "mma"


# ---------------------------------------------------------------------------
# CUDA kernels: load, launch
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODE = {"mma": 0, "wgmma": 1, "wgmma_codes": 2}


@functools.lru_cache(maxsize=None)
def _library(profile: bool = False):
    """The kernels' library; ``profile`` builds and loads the one whose
    kernels count their warps' cycles by phase (K5_PROFILE in the
    source)."""
    lib = ctypes.CDLL(cuda_build.build("int8_gemm", ("K5_PROFILE",))) \
        if profile else cuda_build.library("int8_gemm")
    fn = lib.int8_gemm_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.int8_gemm_wmap.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.int8_gemm_wmap.restype = ctypes.c_int
    lib.int8_gemm_codes_pitch.argtypes = [ctypes.c_int]
    lib.int8_gemm_codes_pitch.restype = ctypes.c_int
    lib.int8_gemm_layout.argtypes = [ctypes.c_int] * 3
    lib.int8_gemm_layout.restype = ctypes.c_int
    lib.int8_gemm_kmax.restype = ctypes.c_int
    if lib.int8_gemm_kmax() != WGMMA_K_MAX:
        raise RuntimeError("csrc/int8_gemm.cu's W_KMAX differs from "
                           "WGMMA_K_MAX")
    if profile:
        lib.int8_gemm_profile.argtypes = [ctypes.c_void_p]
        lib.int8_gemm_profile.restype = ctypes.c_int
    return lib


def pitched_codes(w_int):
    """(O, K) int8 codes as the (O, K) view of a zero-padded (O, roundup(K,
    16)) buffer on their device: the same codes, shape and dtype, rows a
    multiple of 16 bytes apart as TMA reads them (contiguous where K is a
    multiple of 16). A copy."""
    O, K = w_int.shape
    buf = torch.zeros((O, -(-K // 16) * 16), dtype=torch.int8,
                      device=w_int.device)
    buf[:, :K] = w_int
    return buf[:, :K]


def _pitch(w_int) -> int:
    """The row pitch in bytes the kernels read w_int (O, K) with: its row
    stride, or for one row K rounded up to 16."""
    O, K = w_int.shape
    return w_int.stride(0) if O > 1 else -(-K // 16) * 16


def _pitched(w_int) -> bool:
    """Do the kernels take w_int's layout as it is: unit column stride,
    rows a multiple of 16 bytes apart, 16-byte aligned."""
    return w_int.stride(1) == 1 and _pitch(w_int) % 16 == 0 \
        and _pitch(w_int) >= w_int.shape[1] and w_int.data_ptr() % 16 == 0


def weight_map(w_int) -> WeightMap:
    """The TMA tensor map of (O, K) int8 codes on the card whose rows lie a
    multiple of 16 bytes apart (``pitched_codes``; any contiguous codes at K
    a multiple of 16), for "wgmma" and "wgmma_codes": width K, so TMA fills
    past K with 0. A host call; no device work."""
    if w_int.device.type != "cuda":
        raise RuntimeError("weight_map encodes a tensor map of a CUDA "
                           "tensor")
    if not _pitched(w_int):
        raise ValueError("weight_map takes codes whose rows lie a multiple "
                         "of 16 bytes apart (pitched_codes)")
    O, K = w_int.shape
    blob = ctypes.create_string_buffer(128)
    err = _library().int8_gemm_wmap(blob, w_int.data_ptr(), K, O,
                                    _pitch(w_int))
    if err != 0:
        raise RuntimeError(f"int8_gemm tensor map encoding failed: error "
                           f"{err}")
    return WeightMap(w_int.data_ptr(), (O, K), _pitch(w_int), blob.raw)


def _x_layout(x):
    """x as the kernels read it (rows may be strided, columns not), its row
    stride and its address past a multiple of 16."""
    T, K = x.shape
    if x.stride(1) != 1 or (T > 1 and x.stride(0) < K):
        x = x.contiguous()
    return x, (x.stride(0) if T > 1 else K), x.data_ptr() % 16


def _check(x, w_int, a_params, scale_row, bias, bits):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"int8_gemm takes float32 or bfloat16 x, not "
                        f"{x.dtype}")
    if bias is not None and bias.dtype != x.dtype:
        raise TypeError("bias must be in x's dtype")
    if w_int.dtype != torch.int8 or scale_row.dtype != torch.float32 \
            or a_params.dtype != torch.float32:
        raise TypeError("w_int must be int8, scale_row and a_params float32")
    if x.dim() != 2 or w_int.dim() != 2 or w_int.shape[1] != x.shape[1] \
            or x.shape[1] == 0:
        raise ValueError(f"x must be (T, K) and w_int (O, K), got "
                         f"{tuple(x.shape)} and {tuple(w_int.shape)}")
    O = w_int.shape[0]
    if tuple(scale_row.shape) != (O,) or tuple(a_params.shape) != (2,) \
            or (bias is not None and tuple(bias.shape) != (O,)):
        raise ValueError(f"scale_row and bias must be ({O},), a_params (2,)")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"activation bits {bits} outside 1..{MAX_BITS}")


def _launch(x, lda, w_int, a_params, scale_row, bias, bits, variant, w_map,
            profile=False):
    """One launch on the current stream; x as ``_x_layout`` gives it, every
    other tensor contiguous and on x's device (the caller sees to it)."""
    T, K = x.shape
    O = w_int.shape[0]
    out = torch.empty((T, O), dtype=x.dtype, device=x.device)
    if T == 0 or O == 0:
        return out
    lib = _library(profile)
    blob = codes = None
    if variant != "mma":
        if w_map is None or w_map[:3] != (w_int.data_ptr(),
                                          tuple(w_int.shape), _pitch(w_int)):
            w_map = weight_map(w_int)
        blob = w_map.blob
    if variant == "wgmma_codes":         # x's codes, for the second launch
        codes = torch.empty((T, lib.int8_gemm_codes_pitch(K)),
                            dtype=torch.int8, device=x.device)
    err = lib.int8_gemm_launch(
        _VARIANT_CODE[variant], _DTYPE_CODE[x.dtype], x.data_ptr(),
        w_int.data_ptr(), blob, a_params.data_ptr(), scale_row.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if codes is None else codes.data_ptr(),
        T, K, O, lda, _pitch(w_int), bits, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_gemm kernel ({variant}) launch failed: "
                           f"CUDA error {err}")
    int8_gemm.launches += 1
    int8_gemm.variant_launches[variant] += 1
    return out


def _prepared(x, w_int, a_params, scale_row, bias):
    """Every input but x and w contiguous and on x's device; w's rows a
    multiple of 16 bytes apart (a padded copy where they are not)."""
    for t in (w_int, a_params, scale_row) + (() if bias is None else (bias,)):
        if t.device != x.device:
            raise ValueError(f"all int8_gemm inputs must be on {x.device}")
    if not _pitched(w_int):
        w_int = pitched_codes(w_int)
    return (w_int, a_params.contiguous(), scale_row.contiguous(),
            None if bias is None else bias.contiguous())


def int8_gemm(x, w_int, a_params, scale_row, bias=None, *, bits: int,
              variant: str = "auto", w_map: Optional[WeightMap] = None):
    """y = (codes(x) @ w_intᵀ) * scale_row (+ bias), the activation
    quantizer fused.

    x: (T, K) float32 or bfloat16 (rows may be strided); w_int: (O, K) int8
    weight codes; a_params: (2,) float32 [scale, zero point] of the
    activation quantizer at ``bits`` <= 7, its rounded zero point within
    [2^bits - 128, 127] so every code fits int8; scale_row: (O,) float32;
    bias: None or (O,) in x's dtype. Returns (T, O) in x's dtype.

    CPU tensors run the plain version; CUDA tensors launch a kernel; any
    other device raises. ``variant`` picks the kernel: "auto" routes by
    ``int8_variant``, "wgmma", "wgmma_codes" or "mma" force one (a forced
    variant that does not take the call raises, on the CPU too).
    ``w_map``, the ``WeightMap`` of w_int, spares "wgmma" and "wgmma_codes"
    encoding one per call."""
    _check(x, w_int, a_params, scale_row, bias, bits)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: want one of {VARIANTS}")
    int8_gemm.calls += 1
    cpu = x.device.type == "cpu"
    if not cpu and x.device.type != "cuda":
        raise RuntimeError(f"int8_gemm has no path for {x.device}")
    x_in, lda, mod16 = _x_layout(x)
    variant = int8_variant(x.shape[0], x.shape[1], w_int.shape[0], lda,
                           mod16, x.dtype, variant)
    if cpu:
        return int8_gemm_plain(x, w_int, a_params, scale_row, bias,
                               bits=bits)
    return _launch(x_in, lda, *_prepared(x, w_int, a_params, scale_row, bias),
                   bits, variant, w_map)


int8_gemm.launches = 0
int8_gemm.calls = 0
int8_gemm.variant_launches = {"wgmma": 0, "wgmma_codes": 0, "mma": 0}

# the phases "wgmma" and "mma" count their cycles by
INT8_PHASES = ("waiting for w", "loading and quantizing x", "products",
               "epilogue and stores", "at a row tile's barriers")


def int8_phase_cycles(x, w_int, a_params, scale_row, bias=None, *,
                      bits: int, variant: str):
    """{phase: cycles summed over the warps} of one launch of ``variant``
    ("wgmma" or "mma") on these inputs, from a second build of the kernels
    that reads clock64 between their phases (K5_PROFILE; the timers cost
    registers and time, so the shares are the result, not the sum; "wgmma"
    counts every warp but its TMA producer's). Same arguments as
    ``int8_gemm``; CUDA tensors only; waits for the device."""
    _check(x, w_int, a_params, scale_row, bias, bits)
    if x.device.type != "cuda":
        raise RuntimeError("int8_phase_cycles times the kernel on a GPU")
    if variant not in ("wgmma", "mma"):
        raise ValueError(f"variant {variant!r}: want 'wgmma' or 'mma'")
    x_in, lda, mod16 = _x_layout(x)
    int8_variant(x.shape[0], x.shape[1], w_int.shape[0], lda, mod16,
                 x.dtype, variant)
    lib = _library(True)
    cycles = (ctypes.c_ulonglong * 8)()
    with torch.cuda.device(x.device):
        torch.cuda.synchronize()
        err = lib.int8_gemm_profile(cycles)          # reads, then zeroes
        _launch(x_in, lda, *_prepared(x, w_int, a_params, scale_row, bias),
                bits, variant, None, profile=True)
        torch.cuda.synchronize()
        err = err or lib.int8_gemm_profile(cycles)
    if err != 0:
        raise RuntimeError(f"int8_gemm profile read failed: CUDA error {err}")
    return dict(zip(INT8_PHASES, cycles[:len(INT8_PHASES)]))


# ---------------------------------------------------------------------------
# Sites
# ---------------------------------------------------------------------------

def supports(site, mode: str) -> bool:
    """Can this Linear site's eval forward run as an integer product?
    Uniform asymmetric per-tensor activations and uniform weights without
    an AdaRound alpha, both at most 7 bits, as in JAX's ``supports``; the
    weights asymmetric too (JAX's codes read their zero point). Whether int8
    is on is the predictor's switch (``routes.build``)."""
    if mode != "quant":
        return False
    aq, wq = site.aq, site.wq
    return (aq.kind == "uniform" and not aq.symmetric
            and aq.scale.numel() == 1 and aq.bits <= MAX_BITS
            and wq.bits <= MAX_BITS and wq.alpha is None
            and not wq.symmetric)


def weight_codes(weight, site):
    """(w_int (O, K) int8, s_row (O,) float32) of a supported site: the
    arithmetic of JAX's ``weight_codes`` on the weight as given (a bf16
    module gives codes of its bf16 values, as JAX's ``cast_dtype``)."""
    from adalog_tpu_torch.ops.weight_prep import site_weight_codes

    codes, s_row = site_weight_codes(weight, site)
    return codes.to(torch.int8), s_row


def site_weights(weight, site) -> Int8Weights:
    """The ``Int8Weights`` of a supported site, computed on the weight's
    device with no host read: its codes in ``pitched_codes``' storage, and
    on the card the tensor map of them."""
    aq = site.aq
    w_int, s_row = weight_codes(weight, site)
    w_int = pitched_codes(w_int)
    a_params = torch.stack([aq.scale.reshape(()),
                            aq.zero_point.reshape(())]).float()
    w_map = weight_map(w_int) if w_int.device.type == "cuda" else None
    return Int8Weights(w_int, (a_params[0] * s_row).contiguous(),
                       a_params.to(weight.device).contiguous(), w_map)


def check_fits_int8(name, site):
    """Raise unless every code of the site fits int8: c - round(z) for every
    code c in 0..2^bits - 1 of the activation and of each weight row, which
    holds when every rounded zero point lies in [2^bits - 1 - 127, 127].
    Reads the zero points on the host, once, where a predictor is built."""
    for what, q in (("activation", site.aq), ("weight", site.wq)):
        z = torch.round(q.zero_point.float())
        if not bool(((z >= 2 ** q.bits - 1 - _INT8_MAX)
                     & (z <= _INT8_MAX)).all()):
            raise ValueError(f"{name}: a {what} zero point outside "
                             f"[{2 ** q.bits - 1 - _INT8_MAX}, {_INT8_MAX}] "
                             "gives codes past int8; the int8 kernel cannot "
                             "take this site")


def int8_qlinear(p: torch.nn.Linear, site, x, weights=None):
    """The integer forward of a supported Linear site: x (..., K) ->
    (..., O) in x's dtype, with the site's ``Int8Weights`` (a served call
    hands its route's over), or with weights computed here, per call, where
    ``weights`` is None (JAX's ``int8_qlinear`` called directly)."""
    if weights is None:
        weights = site_weights(p.weight, site)
    y = int8_gemm(x.reshape(-1, x.shape[-1]), weights.w_int,
                  weights.a_params, weights.scale_row, p.bias,
                  bits=site.aq.bits, w_map=weights.w_map)
    return y.reshape(*x.shape[:-1], y.shape[-1])
