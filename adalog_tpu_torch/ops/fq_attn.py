"""Fused fake-quant attention: the counterpart of ``adalog_tpu.ops.fq_attn``.

Three kernels, tried in this order by the model forwards:

K1 ``fq_flash_attn`` (dispatch ``run_flash``): the whole quantized attention
of a block in one CUDA kernel,

    uq(q) @ uq(kT) -> * logit_scale -> (+ bias) -> row softmax
      -> AdaLog fake-quant at scale 1 -> @ uq(v)

K2 ``fq_softmax_attn_matmul`` (``run_softmax``): the second half alone, on
logits that already carry scale, bias and mask,

    row softmax(L) -> AdaLog fake-quant at scale 1 -> @ uq(B)

K3 ``fq_attn_matmul`` (``run``, from ``models.layers.qmatmul``): one
quantized product, fq(A) @ uq(B), A per-slice uniform or AdaLog at scale 1.

uq is the per-slice asymmetric uniform quantizer of the matmul sites; the
AdaLog quantizer of the post-softmax site runs at its frozen scale 1.0 with
the searched base q.

Each wrapper runs its ``*_plain`` version, the same math in plain PyTorch,
for CPU tensors; for CUDA tensors it launches its kernel
(``csrc/fq_flash_attn.cu``; ``csrc/fq_attn_matmul.cu`` for K2 and K3), built
with nvcc the first time it is needed (ops/cuda_build.py), or raises. Each
wrapper's ``launches`` counts kernel launches, ``calls`` every call on
either device.

K1 has two hand-written variants in one source (``flash_variant`` routes):
"mma" runs both products on the tensor cores with the logits in registers
and a per-slice table of the AdaLog values; "fma", the first kernel, runs
exact fp32 products on the FMA pipes and takes what "mma" does not (S above
256, more than 256 AdaLog codes, fp32 operands whose integer codes are not
exact in bf16). ``fq_flash_attn(..., variant="mma" | "fma")`` forces one.
"""

from __future__ import annotations

import contextvars
import ctypes
import functools
from contextlib import contextmanager
from typing import Optional

import torch

from adalog_tpu_torch.ops import cuda_build, fq_gemm
from adalog_tpu_torch.quantizers.logarithm import ADALOG_R

# must match fq_flash_attn.cu and fq_attn_matmul.cu
_WARPS = 12
_MAX_ROWS_PER_BLOCK = 64          # A rows of one block of fq_attn_matmul.cu
_MAX_SMEM_BYTES = 232448          # opt-in dynamic shared memory of one block
_MAX_HEAD_DIM = 128               # 4 output columns per lane
# variant "mma" of fq_flash_attn.cu
VARIANTS = ("auto", "mma", "fma")
_MMA_MAX_S = 256                  # a row of logits in registers: 32 n8 tiles
_MMA_MAX_CODE_BITS = 8            # the code table holds at most 256 values
_MMA_INT_BITS = 8                 # fp32 inputs: operand codes c in 0..255,
_MMA_INT_MAX = 256                # |c - z| <= 256, and 4N - 2 <= 254 steps
_MMA_INT_CODE_BITS = 7            # of the mantissa, all exact in bf16


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _uq(x, s, z, bits):
    N = 2 ** (bits - 1)
    zr = torch.round(z)
    q = torch.clamp(torch.round(x / s) + zr, 0.0, 2.0 * N - 1)
    return (q - zr) * s


def _exp2_neg_int(f):
    """2**(-f) for small non-negative integer-valued f, assembled from the
    exponent bits (exact while f < 127)."""
    biased = torch.bitwise_left_shift(127 - f.to(torch.int32), 23)
    return biased.view(torch.float32)


def _adalog_unit(x, q, bits):
    """AdaLog fake quant at scale 1.0 of probabilities x in [0, 1]."""
    N = 2 ** (bits - 1)
    code = torch.round(-torch.log2(torch.clamp(x, min=1e-15)) * ADALOG_R / q)
    keep = (code < 2 * N).to(torch.float32)
    code = torch.clamp(code, 0.0, 2.0 * N - 1)
    prod = code * q
    ts = 1.0 / (4 * N - 2)
    mant = torch.round(torch.exp2(-torch.remainder(prod, ADALOG_R) / ADALOG_R)
                       / ts) * ts
    # floor(prod/R) <= (2N-1)*q/R < 127 at every shipped bit width
    return _exp2_neg_int(torch.floor(prod / ADALOG_R)) * mant * keep


def fq_flash_attn_plain(q, kT, v, m1a_params, m1b_params, m2q, m2b_params,
                        bias=None, *, m1a_bits: int, m1b_bits: int,
                        m2a_bits: int, m2b_bits: int, logit_scale: float):
    """The kernel's math in plain PyTorch; same arguments as ``fq_flash_attn``.

    The compute dtype is the input's: quantized operands are rounded to it
    before each product, and products accumulate in fp32."""
    cd = q.dtype

    def per_g(a):
        return a.to(torch.float32).reshape(-1, 1, 1)

    qf = _uq(q.float(), per_g(m1a_params[:, 0]), per_g(m1a_params[:, 1]),
             m1a_bits)
    kf = _uq(kT.float(), per_g(m1b_params[:, 0]), per_g(m1b_params[:, 1]),
             m1b_bits)
    l = torch.matmul(qf.to(cd).float(), kf.to(cd).float())
    if logit_scale != 1.0:
        l = l * logit_scale
    if bias is not None:
        P = bias.shape[0]
        l = (l.reshape(-1, P, *l.shape[1:]) + bias.float()).reshape(l.shape)
    m = torch.amax(l, dim=-1, keepdim=True)
    e = torch.exp(l - m)
    sm = e / torch.sum(e, dim=-1, keepdim=True)
    smq = _adalog_unit(sm, per_g(m2q), m2a_bits)
    vf = _uq(v.float(), per_g(m2b_params[:, 0]), per_g(m2b_params[:, 1]),
             m2b_bits)
    return torch.matmul(smq.to(cd).float(), vf.to(cd).float())


def _adalog_table(m2q, bits: int, steps_only: bool):
    """(G, 2N) float32: the dequantized value of every AdaLog code 0..2N-1
    at scale 1 and base m2q[g], by ``_adalog_unit``'s own arithmetic, so an
    entry is bit-equal to what it returns for that code. A value is
    2^-shift * (steps * ts) with steps an integer of at most 4N - 2;
    ``steps_only`` leaves the factor ts out (steps * 2^-shift, exact in bf16
    while 4N - 2 < 256)."""
    N = 2 ** (bits - 1)
    code = torch.arange(2 * N, dtype=torch.float32,
                        device=m2q.device).reshape(1, -1)
    prod = code * m2q.to(torch.float32).reshape(-1, 1)
    ts = 1.0 / (4 * N - 2)
    steps = torch.round(torch.exp2(-torch.remainder(prod, ADALOG_R) / ADALOG_R)
                        / ts)
    pow2 = _exp2_neg_int(torch.floor(prod / ADALOG_R))
    return pow2 * steps if steps_only else pow2 * (steps * ts)


def _adalog_lookup(x, table, q):
    """AdaLog fake quant at scale 1 of probabilities x (G, S, K) through a
    (G, 2N) table of ``_adalog_table``: the code by arithmetic, its value
    from the table, 0 for codes >= 2N."""
    n_codes = table.shape[1]
    code = torch.round(-torch.log2(torch.clamp(x, min=1e-15)) * ADALOG_R / q)
    keep = (code < n_codes).to(torch.float32)
    idx = torch.clamp(code, 0.0, n_codes - 1.0).to(torch.int64)
    rows = table[:, None, :].expand(-1, x.shape[1], -1)
    return torch.gather(rows, 2, idx) * keep


def _mma_operands(q, kT, v, m1a_params, m1b_params, m2q, m2b_params, *,
                  m1a_bits: int, m1b_bits: int, m2a_bits: int, m2b_bits: int):
    """What variant "mma" of the kernel stages, in plain PyTorch: the bf16
    operands of q, kT and v, the (G, 2N) code table, and the per-slice
    (G, 1, 1) scales of the logits and of the output.

    bf16 inputs: the operands are the dequantized values rounded to bf16,
    the table holds the values, both scales are 1. fp32 inputs: the operands
    are the integers c - z (exact in bf16 while |c - z| <= 256), the table
    holds steps * 2^-shift, the logits are scaled by sq * sk and the output
    by ts * sv."""
    int_mode = q.dtype == torch.float32

    def per_g(a):
        return a.to(torch.float32).reshape(-1, 1, 1)

    def operand(x, params, bits):
        s, zr = per_g(params[:, 0]), torch.round(per_g(params[:, 1]))
        c = torch.clamp(torch.round(x.float() / s) + zr, 0.0, 2.0 ** bits - 1)
        return ((c - zr) if int_mode else (c - zr) * s).to(torch.bfloat16)

    one = torch.ones((q.shape[0], 1, 1), dtype=torch.float32, device=q.device)
    ts = torch.tensor(1.0 / (2 ** (m2a_bits + 1) - 2), dtype=torch.float32,
                      device=q.device)
    return dict(
        q=operand(q, m1a_params, m1a_bits),
        kT=operand(kT, m1b_params, m1b_bits),
        v=operand(v, m2b_params, m2b_bits),
        table=_adalog_table(m2q, m2a_bits, int_mode),
        logit_scale=per_g(m1a_params[:, 0]) * per_g(m1b_params[:, 0])
        if int_mode else one,
        out_scale=ts * per_g(m2b_params[:, 0]) if int_mode else one)


def _flash_mma_plain(q, kT, v, m1a_params, m1b_params, m2q, m2b_params,
                     bias=None, *, m1a_bits: int, m1b_bits: int,
                     m2a_bits: int, m2b_bits: int, logit_scale: float):
    """Variant "mma" of the kernel, step for step, in plain PyTorch: the
    products of ``_mma_operands`` in fp32, the scales on the sums, the
    AdaLog values from the code table. Equal to ``fq_flash_attn_plain`` up
    to the rounding of the fp32 sums (exact integer sums here)."""
    ops = _mma_operands(q, kT, v, m1a_params, m1b_params, m2q, m2b_params,
                        m1a_bits=m1a_bits, m1b_bits=m1b_bits,
                        m2a_bits=m2a_bits, m2b_bits=m2b_bits)
    l = torch.matmul(ops["q"].float(), ops["kT"].float())
    l = l * ops["logit_scale"] * logit_scale
    if bias is not None:
        P = bias.shape[0]
        l = (l.reshape(-1, P, *l.shape[1:]) + bias.float()).reshape(l.shape)
    m = torch.amax(l, dim=-1, keepdim=True)
    e = torch.exp(l - m)
    sm = e / torch.sum(e, dim=-1, keepdim=True)
    p = _adalog_lookup(sm, ops["table"],
                       m2q.to(torch.float32).reshape(-1, 1, 1))
    out = torch.matmul(p.to(torch.bfloat16).float(), ops["v"].float())
    return out * ops["out_scale"]


def _attn_matmul_plain(A, B, a_params, b_params, a_kind, a_bits, b_bits,
                       do_softmax):
    cd = A.dtype

    def per_g(a):
        return a.to(torch.float32).reshape(-1, 1, 1)

    a = A.float()
    if do_softmax:
        m = torch.amax(a, dim=-1, keepdim=True)
        e = torch.exp(a - m)
        a = e / torch.sum(e, dim=-1, keepdim=True)
    if a_kind == "adalog":
        aq = _adalog_unit(a, per_g(a_params[:, 0]), a_bits)
    else:
        aq = _uq(a, per_g(a_params[:, 0]), per_g(a_params[:, 1]), a_bits)
    bq = _uq(B.float(), per_g(b_params[:, 0]), per_g(b_params[:, 1]), b_bits)
    return torch.matmul(aq.to(cd).float(), bq.to(cd).float())


def fq_attn_matmul_plain(A, B, a_params, b_params, *, a_kind: str,
                         a_bits: int, b_bits: int):
    """K3's math in plain PyTorch; same arguments as ``fq_attn_matmul``.
    Quantized operands are rounded to A's dtype before the product, which
    accumulates in fp32."""
    return _attn_matmul_plain(A, B, a_params, b_params, a_kind, a_bits,
                              b_bits, False)


def fq_softmax_attn_matmul_plain(L, B, a_params, b_params, *, a_bits: int,
                                 b_bits: int):
    """K2's math in plain PyTorch; same arguments as
    ``fq_softmax_attn_matmul``."""
    return _attn_matmul_plain(L, B, a_params, b_params, "adalog", a_bits,
                              b_bits, True)


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library(profile: bool = False):
    """The kernel's library; with ``profile`` the build whose variant "mma"
    counts its warps' cycles by phase (K1_PROFILE in the source)."""
    lib = ctypes.CDLL(cuda_build.build("fq_flash_attn", ("K1_PROFILE",))) \
        if profile else cuda_build.library("fq_flash_attn")
    fn = lib.fq_flash_attn_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if profile:
        lib.fq_flash_attn_profile.argtypes = [ctypes.c_void_p]
        lib.fq_flash_attn_profile.restype = ctypes.c_int
    return lib


def _smem_bytes(S: int, D: int) -> int:
    """Dynamic shared memory of one block of variant "fma": uq(kT) and
    uq(v) of the slice plus one q row and one probability row per warp, all
    fp32."""
    return (2 * S * D + _WARPS * (S + D)) * 4


def _check(q, kT, v, m1a_params, m1b_params, m2q, m2b_params, bias, bits):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fq_flash_attn takes float32 or bfloat16, not {q.dtype}")
    if kT.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, kT and v must share one dtype")
    if q.dim() != 3:
        raise ValueError(f"q must be (G, S, D), got {tuple(q.shape)}")
    G, S, D = q.shape
    if tuple(kT.shape) != (G, D, S) or tuple(v.shape) != (G, S, D):
        raise ValueError(f"shapes q {tuple(q.shape)}, kT {tuple(kT.shape)}, "
                         f"v {tuple(v.shape)}: want (G,S,D), (G,D,S), (G,S,D)")
    for name, a, shape in (("m1a_params", m1a_params, (G, 2)),
                           ("m1b_params", m1b_params, (G, 2)),
                           ("m2q", m2q, (G,)),
                           ("m2b_params", m2b_params, (G, 2))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    if bias is not None:
        if bias.dim() != 3 or tuple(bias.shape[1:]) != (S, S) \
                or G % bias.shape[0]:
            raise ValueError(f"bias must be (P, S, S) with P dividing G={G}, "
                             f"got {tuple(bias.shape)}")
    for b in bits:
        if not 1 <= b <= 16:
            raise ValueError(f"bit width {b} outside 1..16")


def check_kernel_shape(S: int, D: int):
    """Raise for shapes variant "fma" of the kernel does not take: it stages
    uq(kT) and uq(v) of one slice in fp32 in one block's shared memory
    (S=577 at D=64 does not fit), and the head dim is at most 128. Variant
    "mma" has its own limits (``mma_refusal``)."""
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {_MAX_HEAD_DIM}")
    if _smem_bytes(S, D) > _MAX_SMEM_BYTES:
        raise ValueError(
            f"S={S}, D={D} needs {_smem_bytes(S, D)} bytes of shared memory "
            f"per block, above {_MAX_SMEM_BYTES}")


def zero_points_exact(params, bits: int) -> bool:
    """True when every integer c - z of a uniform quantizer with (G, 2)
    [scale, zero point] ``params`` is exact in bf16: |c - round(z)| <= 256
    for every code c in 0..2^bits - 1. Reads the tensor (on a CUDA tensor
    that waits for the device), so it belongs where a predictor is built,
    not on its path."""
    z = torch.round(params[..., 1].to(torch.float32))
    lo, hi = 2.0 ** bits - 1 - _MMA_INT_MAX, float(_MMA_INT_MAX)
    return bool(((z >= lo) & (z <= hi)).all())


def integers_exact(qstate) -> bool:
    """One verdict for a quantizer state, taken once where a predictor is
    built: True when the zero points of every uniform quantizer of every
    attention matmul site keep c - z exact in bf16, which variant "mma"
    needs of fp32 inputs (``activate`` carries it to ``run_flash``)."""
    for site in qstate.values():
        for qs in (getattr(site, "Aq", None), getattr(site, "Bq", None)):
            if qs is None or qs.kind != "uniform" or qs.bits == 32 \
                    or qs.zero_point is None:
                continue
            zp = qs.zero_point.reshape(-1)
            if not zero_points_exact(torch.stack([zp, zp], dim=1), qs.bits):
                return False
    return True


def mma_refusal(S: int, D: int, dtype, bits, exact_ints: bool) -> Optional[str]:
    """Why variant "mma" does not take a call, or None when it does. ``bits``
    is (m1a, m1b, m2a, m2b); ``exact_ints`` the verdict on the zero points
    of fp32 inputs (ignored for bf16)."""
    m1a_bits, m1b_bits, m2a_bits, m2b_bits = bits
    if S > _MMA_MAX_S:
        return f"S={S} > {_MMA_MAX_S}: a row of logits does not fit registers"
    if D > _MAX_HEAD_DIM:
        return f"head dim {D} > {_MAX_HEAD_DIM}"
    if m2a_bits > _MMA_MAX_CODE_BITS:
        return (f"m2a_bits={m2a_bits} > {_MMA_MAX_CODE_BITS}: the code table "
                "holds 256 values")
    if dtype == torch.float32:
        if max(m1a_bits, m1b_bits, m2b_bits) > _MMA_INT_BITS:
            return (f"fp32 operands of {max(m1a_bits, m1b_bits, m2b_bits)} "
                    f"bits: codes past {_MMA_INT_BITS} bits are not exact in "
                    "bf16")
        if m2a_bits > _MMA_INT_CODE_BITS:
            return (f"fp32 probabilities of {m2a_bits} bits: 4N - 2 mantissa "
                    "steps are not exact in bf16")
        if not exact_ints:
            return ("a zero point of the fp32 operands is out of range: "
                    f"|c - z| > {_MMA_INT_MAX} is not exact in bf16")
    return None


def flash_variant(S: int, D: int, dtype, bits, exact_ints: bool,
                  variant: str = "auto") -> str:
    """Which hand-written variant of K1 a call takes, from its shapes, dtype,
    bit widths and the verdict on its zero points: "mma" where it applies,
    else "fma". A forced variant that does not take the call raises; so does
    a call neither takes."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: want one of {VARIANTS}")
    why = mma_refusal(S, D, dtype, bits, exact_ints)
    if variant == "mma" and why is not None:
        raise ValueError(f"fq_flash_attn variant 'mma' refused: {why}")
    if variant == "mma" or (variant == "auto" and why is None):
        return "mma"
    check_kernel_shape(S, D)
    return "fma"


def _launch(q, kT, v, m1a_params, m1b_params, m2q, m2b_params, bias,
            bits, logit_scale, variant, profile=False):
    dev = q.device
    for t in (kT, v, m1a_params, m1b_params, m2q, m2b_params) + \
            (() if bias is None else (bias,)):
        if t.device != dev:
            raise ValueError(f"all fq_flash_attn inputs must be on {dev}")
    G, S, D = q.shape
    q, kT, v = q.contiguous(), kT.contiguous(), v.contiguous()
    prm = [a.to(torch.float32).contiguous()
           for a in (m1a_params, m1b_params, m2q, m2b_params)]
    bias_f = None if bias is None else bias.to(torch.float32).contiguous()
    out = torch.empty((G, S, D), dtype=torch.float32, device=dev)
    lib = _library(profile)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fq_flash_attn_launch(
            1 if variant == "mma" else 0,
            1 if q.dtype == torch.bfloat16 else 0,
            q.data_ptr(), kT.data_ptr(), v.data_ptr(),
            prm[0].data_ptr(), prm[1].data_ptr(), prm[2].data_ptr(),
            prm[3].data_ptr(),
            None if bias_f is None else bias_f.data_ptr(), out.data_ptr(),
            0 if bias_f is None else bias_f.shape[0], G, S, D, *bits,
            float(logit_scale), stream)
    if err != 0:
        raise RuntimeError(f"fq_flash_attn kernel ({variant}) launch failed: "
                           f"CUDA error {err}")
    fq_flash_attn.launches += 1
    fq_flash_attn.variant_launches[variant] += 1
    return out


def fq_flash_attn(q, kT, v, m1a_params, m1b_params, m2q, m2b_params,
                  bias=None, *, m1a_bits: int, m1b_bits: int, m2a_bits: int,
                  m2b_bits: int, logit_scale: float, variant: str = "auto",
                  exact_ints: Optional[bool] = None):
    """Fully fused fake-quant attention.

    q: (G, S, D); kT: (G, D, S); v: (G, S, D), float32 or bfloat16 (the
    compute dtype). m1a/m1b/m2b_params: (G, 2) [scale, zp] of q, kT and v;
    m2q: (G,) AdaLog base of the probabilities (scale frozen at 1.0).
    bias: None or (P, S, S) additive logit bias, P dividing G; slice g reads
    bias[g % P]. Returns (G, S, D) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel; any
    other device raises. ``variant`` picks the kernel: "auto" routes by
    ``flash_variant``, "mma" or "fma" force one (and raise where it does
    not take the call; a CPU call checks that too). ``exact_ints`` is the
    caller's verdict on the zero points (``integers_exact``, taken where a
    predictor is built); None has the wrapper read them itself when an fp32
    call could take "mma", which waits for the device."""
    bits = (m1a_bits, m1b_bits, m2a_bits, m2b_bits)
    _check(q, kT, v, m1a_params, m1b_params, m2q, m2b_params, bias, bits)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: want one of {VARIANTS}")
    fq_flash_attn.calls += 1
    cpu = q.device.type == "cpu"
    if not cpu and q.device.type != "cuda":
        raise RuntimeError(f"fq_flash_attn has no path for {q.device}")
    if not cpu or variant != "auto":
        S, D = q.shape[1], q.shape[2]
        if exact_ints is None:
            # asked only where the answer decides: an fp32 call that "mma"
            # would otherwise take
            exact_ints = variant != "fma" and q.dtype == torch.float32 \
                and mma_refusal(S, D, q.dtype, bits, True) is None \
                and zero_points_exact(m1a_params, m1a_bits) \
                and zero_points_exact(m1b_params, m1b_bits) \
                and zero_points_exact(m2b_params, m2b_bits)
        variant = flash_variant(S, D, q.dtype, bits, bool(exact_ints), variant)
    if cpu:
        return fq_flash_attn_plain(
            q, kT, v, m1a_params, m1b_params, m2q, m2b_params, bias,
            m1a_bits=m1a_bits, m1b_bits=m1b_bits, m2a_bits=m2a_bits,
            m2b_bits=m2b_bits, logit_scale=logit_scale)
    return _launch(q, kT, v, m1a_params, m1b_params, m2q, m2b_params, bias,
                   bits, logit_scale, variant)


fq_flash_attn.launches = 0
fq_flash_attn.calls = 0
fq_flash_attn.variant_launches = {"mma": 0, "fma": 0}

# the phases variant "mma" counts its cycles by, in the kernel's order
FLASH_PHASES = ("stage uq(kT), uq(v), code table", "stage uq(q) tile",
                "q @ kT", "scale, bias, row max", "exp, row sum",
                "AdaLog codes and values", "p @ v", "store")


def flash_phase_cycles(q, kT, v, m1a_params, m1b_params, m2q, m2b_params,
                       bias=None, *, m1a_bits: int, m1b_bits: int,
                       m2a_bits: int, m2b_bits: int, logit_scale: float):
    """Where the cycles of one call of variant "mma" go: {phase: cycles
    summed over the call's warps}, read with clock64 by a second build of
    the kernel (K1_PROFILE; the timers cost it some registers and time, so
    the shares are the result, not the sum). Same arguments as
    ``fq_flash_attn``; CUDA tensors only; waits for the device."""
    bits = (m1a_bits, m1b_bits, m2a_bits, m2b_bits)
    _check(q, kT, v, m1a_params, m1b_params, m2q, m2b_params, bias, bits)
    if q.device.type != "cuda":
        raise RuntimeError("flash_phase_cycles times the kernel on a GPU")
    exact = q.dtype != torch.float32 or (
        zero_points_exact(m1a_params, m1a_bits)
        and zero_points_exact(m1b_params, m1b_bits)
        and zero_points_exact(m2b_params, m2b_bits))
    flash_variant(q.shape[1], q.shape[2], q.dtype, bits, exact, "mma")
    lib = _library(True)
    cycles = (ctypes.c_ulonglong * 16)()
    with torch.cuda.device(q.device):
        torch.cuda.synchronize()
        err = lib.fq_flash_attn_profile(cycles)      # reads, then zeroes
        _launch(q, kT, v, m1a_params, m1b_params, m2q, m2b_params, bias,
                bits, logit_scale, "mma", profile=True)
        torch.cuda.synchronize()
        err = err or lib.fq_flash_attn_profile(cycles)
    if err != 0:
        raise RuntimeError(f"fq_flash_attn profile read failed: CUDA error "
                           f"{err}")
    return dict(zip(FLASH_PHASES, cycles[:len(FLASH_PHASES)]))


# ---------------------------------------------------------------------------
# K2 and K3: one CUDA source, one launch function
# ---------------------------------------------------------------------------

A_KINDS = ("uniform", "adalog")
_MODE_SOFTMAX = 2                 # fq_attn_matmul.cu: 0 uniform A, 1 AdaLog A


@functools.lru_cache(maxsize=None)
def _matmul_library():
    lib = cuda_build.library("fq_attn_matmul")
    fn = lib.fq_attn_matmul_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def matmul_tile_plan(S: int):
    """(A rows a block, warps a block) of fq_attn_matmul.cu for S rows a
    slice: the rows are split evenly over tiles of at most
    _MAX_ROWS_PER_BLOCK, and a tile's rows evenly over at most _WARPS warps
    (one warp a row), so S=49 runs 10 warps for 5 rounds and S=197 4 tiles
    of 50 rows, 10 warps."""
    tiles = -(-S // _MAX_ROWS_PER_BLOCK)
    rows = -(-S // tiles)
    rounds = -(-rows // _WARPS)
    return rows, -(-rows // rounds)


def _matmul_smem_bytes(S: int, K: int, C: int) -> int:
    """Dynamic shared memory of one block: uq(B) of the slice plus one A
    row per warp, all fp32."""
    return (K * C + matmul_tile_plan(S)[1] * K) * 4


def check_matmul_kernel_shape(G: int, S: int, K: int, C: int):
    """Raise for shapes K2/K3's kernel does not take: the staged uq(B) of
    one slice, (K, C) in fp32, plus the warps' A rows must fit in one
    block's shared memory, and G * tiles must fit the grid's x dimension."""
    if min(G, S, K, C) < 1:
        raise ValueError(f"empty attention matmul G={G}, S={S}, K={K}, C={C}")
    need = _matmul_smem_bytes(S, K, C)
    if need > _MAX_SMEM_BYTES:
        raise ValueError(
            f"S={S}, K={K}, C={C} needs {need} bytes of shared memory per "
            f"block ({K * C * 4} for B), above {_MAX_SMEM_BYTES}")
    blocks = G * -(-S // matmul_tile_plan(S)[0])
    if blocks >= 2 ** 31:
        raise ValueError(f"G={G}, S={S} needs {blocks} blocks, above 2^31 - 1")


def _check_matmul(name, A, B, a_params, b_params, a_kind, a_bits, b_bits):
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, not {A.dtype}")
    if B.dtype != A.dtype:
        raise TypeError("A and B must share one dtype")
    if A.dim() != 3 or B.dim() != 3 or B.shape[0] != A.shape[0] \
            or B.shape[1] != A.shape[2]:
        raise ValueError(f"shapes A {tuple(A.shape)}, B {tuple(B.shape)}: "
                         "want (G,S,K), (G,K,C)")
    G = A.shape[0]
    for nm, a in (("a_params", a_params), ("b_params", b_params)):
        if tuple(a.shape) != (G, 2):
            raise ValueError(f"{nm} must be ({G}, 2), got {tuple(a.shape)}")
    if a_kind not in A_KINDS:
        raise ValueError(f"a_kind {a_kind!r}: want one of {A_KINDS}")
    for b in (a_bits, b_bits):
        if not 1 <= b <= 16:
            raise ValueError(f"bit width {b} outside 1..16")


def _launch_matmul(wrapper, mode, A, B, a_params, b_params, a_bits, b_bits):
    G, S, K = A.shape
    C = B.shape[2]
    check_matmul_kernel_shape(G, S, K, C)
    dev = A.device
    for t in (B, a_params, b_params):
        if t.device != dev:
            raise ValueError(f"all {wrapper.__name__} inputs must be on {dev}")
    A, B = A.contiguous(), B.contiguous()
    ap = a_params.to(torch.float32).contiguous()
    bp = b_params.to(torch.float32).contiguous()
    out = torch.empty((G, S, C), dtype=torch.float32, device=dev)
    rows, warps = matmul_tile_plan(S)
    lib = _matmul_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fq_attn_matmul_launch(
            1 if A.dtype == torch.bfloat16 else 0, mode, A.data_ptr(),
            B.data_ptr(), ap.data_ptr(), bp.data_ptr(), out.data_ptr(),
            G, S, K, C, rows, warps, a_bits, b_bits, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {err}")
    wrapper.launches += 1
    return out


def fq_attn_matmul(A, B, a_params, b_params, *, a_kind: str, a_bits: int,
                   b_bits: int):
    """Fused fake-quant batched matmul for attention sites (K3).

    A: (G, S, K); B: (G, K, C) with G = batch*heads flattened, float32 or
    bfloat16 (the compute dtype). a_params: (G, 2) [scale-or-q, zp];
    b_params: (G, 2) [scale, zp]. For a_kind='adalog', a_params[:, 0] holds
    the log base q (scale is 1.0, A in [0, 1]). Returns (G, S, C) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel; any
    other device raises."""
    _check_matmul("fq_attn_matmul", A, B, a_params, b_params, a_kind, a_bits,
                  b_bits)
    fq_attn_matmul.calls += 1
    if A.device.type == "cpu":
        return fq_attn_matmul_plain(A, B, a_params, b_params, a_kind=a_kind,
                                    a_bits=a_bits, b_bits=b_bits)
    if A.device.type != "cuda":
        raise RuntimeError(f"fq_attn_matmul has no path for {A.device}")
    return _launch_matmul(fq_attn_matmul, A_KINDS.index(a_kind), A, B,
                          a_params, b_params, a_bits, b_bits)


fq_attn_matmul.launches = 0
fq_attn_matmul.calls = 0


def fq_softmax_attn_matmul(L, B, a_params, b_params, *, a_bits: int,
                           b_bits: int):
    """softmax(L) -> AdaLog fake-quant -> @ fake-quant(B), all fused (K2).

    L: (G, S, K) pre-softmax attention logits (scale, bias and mask already
    applied); the row softmax runs in the kernel, so the probabilities never
    reach device memory. a_params: (G, 2) with the AdaLog base in column 0;
    b_params: (G, 2) [scale, zp]. Returns (G, S, C) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel; any
    other device raises."""
    _check_matmul("fq_softmax_attn_matmul", L, B, a_params, b_params,
                  "adalog", a_bits, b_bits)
    fq_softmax_attn_matmul.calls += 1
    if L.device.type == "cpu":
        return fq_softmax_attn_matmul_plain(L, B, a_params, b_params,
                                            a_bits=a_bits, b_bits=b_bits)
    if L.device.type != "cuda":
        raise RuntimeError(f"fq_softmax_attn_matmul has no path for "
                           f"{L.device}")
    return _launch_matmul(fq_softmax_attn_matmul, _MODE_SOFTMAX, L, B,
                          a_params, b_params, a_bits, b_bits)


fq_softmax_attn_matmul.launches = 0
fq_softmax_attn_matmul.calls = 0


# ---------------------------------------------------------------------------
# Dispatch from the model forward
# ---------------------------------------------------------------------------

_ENABLED: contextvars.ContextVar = contextvars.ContextVar(
    "adalog_fq_attn_enabled", default=False)
_EXACT_INTS: contextvars.ContextVar = contextvars.ContextVar(
    "adalog_fq_attn_exact_ints", default=None)


@contextmanager
def activate(flag: bool, exact_ints: Optional[bool] = None):
    """Route supported attention sites through the kernels inside the block
    (a predictor enters it around its forward). ``exact_ints`` is the
    verdict of ``integers_exact`` on the quantizer state the forward runs
    with, taken once by the caller; with None, each fp32 K1 call reads its
    own zero points."""
    tok = _ENABLED.set(bool(flag))
    tok_exact = _EXACT_INTS.set(exact_ints)
    try:
        yield
    finally:
        _EXACT_INTS.reset(tok_exact)
        _ENABLED.reset(tok)


def enabled() -> bool:
    """On inside ``activate(True)``, and wherever the GEMM kernel's table is
    active: turning the GEMM kernels on turns these on too."""
    return _ENABLED.get() or fq_gemm.enabled()


def supports(site, mode: str) -> bool:
    """K3: a quant-mode matmul site with uniform B and uniform or AdaLog
    A."""
    if not enabled() or mode != "quant":
        return False
    Aq, Bq = site.Aq, site.Bq
    if Bq.kind != "uniform" or Bq.bits == 32 or Aq.bits == 32:
        return False
    return Aq.kind in ("uniform", "adalog")


def supports_softmax(site, mode: str) -> bool:
    """K2, the fused-softmax variant: AdaLog A at frozen scale 1.0 only."""
    if not enabled() or mode != "quant":
        return False
    Aq, Bq = site.Aq, site.Bq
    return (Aq.kind == "adalog" and Aq.bits != 32 and not Aq.shifted
            and Bq.kind == "uniform" and Bq.bits != 32)


def supports_flash(m1_site, m2_site, m1_mode: str, m2_mode: str) -> bool:
    """K1, the fully fused path: matmul1 both-uniform, matmul2 AdaLog A
    (unshifted) and uniform B, both sites in quant mode (the shipped eval
    configuration)."""
    if not enabled() or m1_mode != "quant" or m2_mode != "quant":
        return False
    if m1_site is None or m2_site is None:
        return False
    m1a, m1b = m1_site.Aq, m1_site.Bq
    if (m1a.kind != "uniform" or m1b.kind != "uniform"
            or m1a.bits == 32 or m1b.bits == 32
            or m1a.shifted or m1b.shifted):
        return False
    return supports_softmax(m2_site, m2_mode)


def _head_params(qs, H: int, device):
    """Per-head (scale-or-q, zp) rows -> (H, 2) float32; per-tensor layouts
    broadcast across heads."""
    def vec(a):
        if a is None:
            return torch.zeros((H,), dtype=torch.float32, device=device)
        flat = a.reshape(-1).to(torch.float32)
        return (flat if flat.numel() == H else flat[:1]).expand(H)

    p0 = vec(qs.log_q) if qs.kind == "adalog" else vec(qs.scale)
    return torch.stack([p0, vec(qs.zero_point)], dim=1)


def _flat_params(site, N: int, H: int, device):
    ap = _head_params(site.Aq, H, device).repeat(N, 1)
    bp = _head_params(site.Bq, H, device).repeat(N, 1)
    return ap, bp


def flash_args(m1_site, m2_site, q, kT, v):
    """The (G, ...) tensors and bit widths ``fq_flash_attn`` takes for 4D
    q, v: (N, H, S, D) and kT: (N, H, D, S) of the two attention sites."""
    N, H, S, D = q.shape
    m1a, m1b = _flat_params(m1_site, N, H, q.device)
    m2a, m2b = _flat_params(m2_site, N, H, q.device)
    args = (q.reshape(N * H, S, D), kT.reshape(N * H, D, S),
            v.reshape(N * H, S, D), m1a, m1b, m2a[:, 0], m2b)
    bits = dict(m1a_bits=m1_site.Aq.bits, m1b_bits=m1_site.Bq.bits,
                m2a_bits=m2_site.Aq.bits, m2b_bits=m2_site.Bq.bits)
    return args, bits


def run_flash(m1_site, m2_site, q, kT, v, *, logit_scale: float, bias=None):
    """Run 4D q/kT/v through the fused kernel.

    q, v: (N, H, S, D); kT: (N, H, D, S); bias: None or (P, S, S) with P
    dividing N*H. Returns (N, H, S, D) in q's dtype."""
    args, bits = flash_args(m1_site, m2_site, q, kT, v)
    out = fq_flash_attn(*args, bias, logit_scale=logit_scale,
                        exact_ints=_EXACT_INTS.get(), **bits)
    return out.reshape(q.shape).to(q.dtype)


def run(site, A, B):
    """Run a 4D (N, H, S, K) @ (N, H, K, C) attention matmul of ``site``
    through K3. Returns (N, H, S, C) in A's dtype."""
    N, H, S, K = A.shape
    C = B.shape[-1]
    ap, bp = _flat_params(site, N, H, A.device)
    out = fq_attn_matmul(
        A.reshape(N * H, S, K), B.reshape(N * H, K, C), ap, bp,
        a_kind=site.Aq.kind, a_bits=site.Aq.bits, b_bits=site.Bq.bits)
    return out.reshape(N, H, S, C).to(A.dtype)


def run_softmax(site, L, B):
    """Run 4D logits (N, H, S, K) and values (N, H, K, C) of the matmul2
    ``site`` through K2. Returns (N, H, S, C) in L's dtype."""
    N, H, S, K = L.shape
    C = B.shape[-1]
    ap, bp = _flat_params(site, N, H, L.device)
    out = fq_softmax_attn_matmul(
        L.reshape(N * H, S, K), B.reshape(N * H, K, C), ap, bp,
        a_bits=site.Aq.bits, b_bits=site.Bq.bits)
    return out.reshape(N, H, S, C).to(L.dtype)
