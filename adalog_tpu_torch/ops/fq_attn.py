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
and a per-slice table of the AdaLog values; past 256 keys (D <= 64) it
takes each row in two passes over key tiles, the long row
(``long_row``): the max and the sum first, then the codes. "fma", the
first kernel, runs exact fp32 products on the FMA pipes and takes what
"mma" does not (more than 256 AdaLog codes, fp32 operands whose integer
codes are not exact in bf16, D above 64 past 256 keys).
``fq_flash_attn(..., variant="mma" | "fma")`` forces one.

K2 and K3 have the same two variants in their one source
(``matmul_variant`` routes, ``variant=`` on either wrapper forces): "mma"
has one body a mode (K2: the row of logits in registers, as K1; K3 with
AdaLog A: A streamed through registers; K3 with uniform A: the wide output
stored in row runs), with the same code table and integer operands; "fma"
is their first kernel.

Whether the kernels serve a forward is its predictor's plan (ops/routes.py),
which also holds the verdict of ``integers_exact`` and each matmul site's
per-head parameter rows (``site_params``), flattened once; ``run_flash``,
``run`` and ``run_softmax`` take them from the plan by site name.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from adalog_tpu_torch.ops import cuda_build, routes
from adalog_tpu_torch.quantizers.logarithm import ADALOG_R

# must match fq_flash_attn.cu and fq_attn_matmul.cu
_WARPS = 12
_MAX_ROWS_PER_BLOCK = 64          # A rows of one block of fq_attn_matmul.cu
_MAX_SMEM_BYTES = 232448          # opt-in dynamic shared memory of one block
_MAX_HEAD_DIM = 128               # 4 output columns per lane
# variant "mma" of fq_flash_attn.cu
VARIANTS = ("auto", "mma", "fma")
_MMA_MAX_S = 256                  # a row of logits in registers: 32 n8 tiles
_LONG_MAX_D = 64                  # the long row past _MMA_MAX_S keys
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


def _mma_operand(x, params, bits: int, int_mode: bool):
    """One uniform-quantized (G, ., .) operand as variant "mma" of a kernel
    stages it, in bf16: the integers c - z (``int_mode``, fp32 inputs) or
    the dequantized values (c - z) * s rounded to bf16."""
    s = params[:, 0].to(torch.float32).reshape(-1, 1, 1)
    zr = torch.round(params[:, 1].to(torch.float32).reshape(-1, 1, 1))
    c = torch.clamp(torch.round(x.float() / s) + zr, 0.0, 2.0 ** bits - 1)
    return ((c - zr) if int_mode else (c - zr) * s).to(torch.bfloat16)


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
        return _mma_operand(x, params, bits, int_mode)

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


def _matmul_mma_operands(A, B, a_params, b_params, *, a_kind: str,
                         a_bits: int, b_bits: int):
    """What variant "mma" of K2 / K3 stages, in plain PyTorch: uq(B) in bf16,
    for uniform A uq(A) in bf16 (``A``), for AdaLog A the (G, 2N) code table
    (``table``), and the per-slice (G, 1, 1) scale of the output.

    bf16 inputs: operands and table hold the dequantized values, the scale
    is 1. fp32 inputs: the operands are the integers c - z (exact in bf16
    while |c - z| <= 256) and the table holds steps * 2^-shift; the output
    is scaled by s_a * s_b (uniform A) or ts * s_b (AdaLog A)."""
    int_mode = A.dtype == torch.float32
    sb = b_params[:, 0].to(torch.float32).reshape(-1, 1, 1)
    ops = dict(B=_mma_operand(B, b_params, b_bits, int_mode), A=None,
               table=None, out_scale=torch.ones_like(sb))
    if a_kind == "uniform":
        ops["A"] = _mma_operand(A, a_params, a_bits, int_mode)
        if int_mode:
            ops["out_scale"] = a_params[:, 0].to(torch.float32).reshape(
                -1, 1, 1) * sb
    else:
        ops["table"] = _adalog_table(a_params[:, 0], a_bits, int_mode)
        if int_mode:
            ts = torch.tensor(1.0 / (2 ** (a_bits + 1) - 2),
                              dtype=torch.float32, device=A.device)
            ops["out_scale"] = ts * sb
    return ops


def _attn_matmul_mma_plain(A, B, a_params, b_params, *, a_kind: str,
                           a_bits: int, b_bits: int,
                           do_softmax: bool = False):
    """Variant "mma" of K3 (and, with ``do_softmax``, of K2) step for step
    in plain PyTorch: the operands of ``_matmul_mma_operands`` multiplied in
    fp32, AdaLog values from the code table, the scale on the sum. Equal to
    the plain versions up to the rounding of the fp32 sums."""
    ops = _matmul_mma_operands(A, B, a_params, b_params, a_kind=a_kind,
                               a_bits=a_bits, b_bits=b_bits)
    if a_kind == "uniform":
        a = ops["A"]
    else:
        x = A.float()
        if do_softmax:
            m = torch.amax(x, dim=-1, keepdim=True)
            e = torch.exp(x - m)
            x = e / torch.sum(e, dim=-1, keepdim=True)
        a = _adalog_lookup(
            x, ops["table"],
            a_params[:, 0].to(torch.float32).reshape(-1, 1, 1)
        ).to(torch.bfloat16)
    return torch.matmul(a.float(), ops["B"].float()) * ops["out_scale"]


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
    needs of fp32 inputs (a predictor's plan carries it to the calls)."""
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
    if long_row(S) and D > _LONG_MAX_D:
        return (f"head dim {D} > {_LONG_MAX_D} at S={S} > {_MMA_MAX_S}: the "
                "long row holds at most 64")
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


def long_row(S: int) -> bool:
    """True where variant "mma" takes a call's rows in two passes over key
    tiles (its logits do not fit a warp's registers): S above 256."""
    return S > _MMA_MAX_S


def flash_takes(S: int, D: int, dtype, bits, exact_ints: bool) -> bool:
    """True where one variant of K1 takes a call routed "auto"."""
    try:
        flash_variant(S, D, dtype, bits, exact_ints)
    except ValueError:
        return False
    return True


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
    if variant == "mma" and long_row(S):
        fq_flash_attn.long_row_launches += 1
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
    call could take "mma", which waits for the device. A launch counts in
    ``launches`` and ``variant_launches``, and a long row of "mma"
    (``long_row``) in ``long_row_launches`` too."""
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
# the calls of "mma" that took the long row (counted under "mma" too)
fq_flash_attn.long_row_launches = 0

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
    if long_row(q.shape[1]):
        raise ValueError("flash_phase_cycles times the short row (S <= "
                         f"{_MMA_MAX_S}); S={q.shape[1]} takes the long row")
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
# the modes of fq_attn_matmul.cu, by index: K3 with uniform A, K3 with AdaLog
# A, K2 (row softmax, then AdaLog A)
MATMUL_MODES = ("uniform", "adalog", "softmax")
# variant "mma" of fq_attn_matmul.cu (must match its launch_mma_mode)
_MATMUL_MMA_MAX_K_SOFTMAX = 256   # K2: a row of logits in registers
_MATMUL_MMA_MAX_C_ADALOG = 128    # K2, K3 AdaLog A: 16 n8 tiles of output
_MATMUL_MMA_MAX_K_UNIFORM = 128   # K3 uniform A: 8 k16 steps of A operands
_MATMUL_MMA_WARPS = 4
_MATMUL_MMA_OUT_LD = 72           # floats a row of a warp's output strip
_MATMUL_MMA_CONSTS_BYTES = 1040   # code table, base, bound, output scale


@functools.lru_cache(maxsize=None)
def _matmul_library(profile: bool = False):
    """K2 and K3's library; with ``profile`` the build whose variant "mma"
    counts its warps' cycles by phase (K23_PROFILE in the source)."""
    lib = ctypes.CDLL(cuda_build.build("fq_attn_matmul", ("K23_PROFILE",))) \
        if profile else cuda_build.library("fq_attn_matmul")
    fn = lib.fq_attn_matmul_launch
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if profile:
        lib.fq_attn_matmul_profile.argtypes = [ctypes.c_void_p]
        lib.fq_attn_matmul_profile.restype = ctypes.c_int
    return lib


def matmul_tile_plan(S: int):
    """(A rows a block, warps a block) of variant "fma" of
    fq_attn_matmul.cu for S rows a slice: the rows are split evenly over
    tiles of at most _MAX_ROWS_PER_BLOCK, and a tile's rows evenly over at
    most _WARPS warps (one warp a row), so S=49 runs 10 warps for 5 rounds
    and S=197 4 tiles of 50 rows, 10 warps."""
    tiles = -(-S // _MAX_ROWS_PER_BLOCK)
    rows = -(-S // tiles)
    rounds = -(-rows // _WARPS)
    return rows, -(-rows // rounds)


def _matmul_smem_bytes(S: int, K: int, C: int) -> int:
    """Dynamic shared memory of one block of variant "fma": uq(B) of the
    slice plus one A row per warp, all fp32."""
    return (K * C + matmul_tile_plan(S)[1] * K) * 4


def check_matmul_kernel_shape(G: int, S: int, K: int, C: int):
    """Raise for shapes variant "fma" of K2/K3's kernel does not take: the
    staged uq(B) of one slice, (K, C) in fp32, plus the warps' A rows must
    fit in one block's shared memory, and G * tiles must fit the grid's x
    dimension. Variant "mma" has its own limits (``matmul_mma_refusal``)."""
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


def _pad_pow2_steps(n: int) -> int:
    """n rounded up to the 32, 64 or 128 columns of the kernel's templates."""
    return 32 if n <= 32 else 64 if n <= 64 else 128


def _matmul_mma_smem_bytes(mode: str, K: int, C: int) -> int:
    """Dynamic shared memory of one block of variant "mma": uq(B) of the
    slice in bf16, rows padded by 8 elements; behind it the slice's code
    table (AdaLog A) or, for uniform A, a 16-row tile of uq(A) and a
    16 x 64 fp32 output strip for each of the 4 warps."""
    if mode == "uniform":
        k_pad, c_pad = _pad_pow2_steps(K), 16 * -(-C // 16)
        return k_pad * (c_pad + 8) * 2 + _MATMUL_MMA_WARPS * (
            16 * (k_pad + 8) * 2 + 16 * _MATMUL_MMA_OUT_LD * 4)
    k_pad = 16 * -(-K // 16)
    if mode == "softmax":       # 7, 16, 25 or 32 n8 tiles of logits
        k_pad = 64 if K <= 56 else 128 if K <= 128 else 208 if K <= 200 \
            else 256
    return k_pad * (_pad_pow2_steps(C) + 8) * 2 + _MATMUL_MMA_CONSTS_BYTES


def matmul_mma_refusal(mode: str, G: int, S: int, K: int, C: int, dtype,
                       a_bits: int, b_bits: int,
                       exact_ints: bool) -> Optional[str]:
    """Why variant "mma" of K2 / K3 does not take a call, or None when it
    does. ``mode`` is one of MATMUL_MODES; ``exact_ints`` the verdict on the
    zero points of fp32 inputs (ignored for bf16)."""
    if mode not in MATMUL_MODES:
        raise ValueError(f"mode {mode!r}: want one of {MATMUL_MODES}")
    if G >= 2 ** 31:
        return f"G={G} slices do not fit the grid's x dimension"
    if mode == "uniform":
        if K > _MATMUL_MMA_MAX_K_UNIFORM:
            return (f"K={K} > {_MATMUL_MMA_MAX_K_UNIFORM}: the A operands "
                    "of a row tile do not fit registers")
    else:
        if mode == "softmax" and K > _MATMUL_MMA_MAX_K_SOFTMAX:
            return (f"K={K} > {_MATMUL_MMA_MAX_K_SOFTMAX}: a row of logits "
                    "does not fit registers")
        if C > _MATMUL_MMA_MAX_C_ADALOG:
            return (f"C={C} > {_MATMUL_MMA_MAX_C_ADALOG}: a row tile of "
                    "output does not fit registers")
        if a_bits > _MMA_MAX_CODE_BITS:
            return (f"a_bits={a_bits} > {_MMA_MAX_CODE_BITS}: the code table "
                    "holds 256 values")
    need = _matmul_mma_smem_bytes(mode, K, C)
    if need > _MAX_SMEM_BYTES:
        return (f"K={K}, C={C} needs {need} bytes of shared memory per "
                f"block, above {_MAX_SMEM_BYTES}")
    if dtype == torch.float32:
        uniform_bits = max(a_bits, b_bits) if mode == "uniform" else b_bits
        if uniform_bits > _MMA_INT_BITS:
            return (f"fp32 operands of {uniform_bits} bits: codes past "
                    f"{_MMA_INT_BITS} bits are not exact in bf16")
        if mode != "uniform" and a_bits > _MMA_INT_CODE_BITS:
            return (f"fp32 probabilities of {a_bits} bits: 4N - 2 mantissa "
                    "steps are not exact in bf16")
        if not exact_ints:
            return ("a zero point of the fp32 operands is out of range: "
                    f"|c - z| > {_MMA_INT_MAX} is not exact in bf16")
    return None


def matmul_variant(mode: str, G: int, S: int, K: int, C: int, dtype,
                   a_bits: int, b_bits: int, exact_ints: bool,
                   variant: str = "auto") -> str:
    """Which hand-written variant of K2 / K3 a call takes, from its mode,
    shapes, dtype, bit widths and the verdict on its zero points: "mma"
    where it applies, else "fma". A forced variant that does not take the
    call raises; so does a call neither takes."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: want one of {VARIANTS}")
    why = matmul_mma_refusal(mode, G, S, K, C, dtype, a_bits, b_bits,
                             exact_ints)
    if variant == "mma" and why is not None:
        raise ValueError(f"attention matmul ({mode} A) variant 'mma' "
                         f"refused: {why}")
    if variant == "mma" or (variant == "auto" and why is None):
        return "mma"
    check_matmul_kernel_shape(G, S, K, C)
    return "fma"


def _check_matmul(name, A, B, a_params, b_params, a_kind, a_bits, b_bits,
                  periodic=False):
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
        ok = a.dim() == 2 and a.shape[1] == 2 and a.shape[0] >= 1 and (
            G % a.shape[0] == 0 if periodic else a.shape[0] == G)
        if not ok:
            raise ValueError(
                f"{nm} must be ({G}, 2)" + (" or (P, 2) with P dividing G"
                                            if periodic else "")
                + f", got {tuple(a.shape)}")
    if a_kind not in A_KINDS:
        raise ValueError(f"a_kind {a_kind!r}: want one of {A_KINDS}")
    for b in (a_bits, b_bits):
        if not 1 <= b <= 16:
            raise ValueError(f"bit width {b} outside 1..16")


def _launch_matmul(wrapper, mode, A, B, ap, bp, a_bits, b_bits, variant,
                   profile=False):
    """One launch on the current stream of A's device, which the C call
    makes current where it is not. ap and bp are (P, 2): slice g reads row
    g % P."""
    G, S, K = A.shape
    C = B.shape[2]
    dev = A.device
    if B.device != dev or ap.device != dev or bp.device != dev:
        raise ValueError(f"all {wrapper.__name__} inputs must be on {dev}")
    if not A.is_contiguous():
        A = A.contiguous()
    if not B.is_contiguous():
        B = B.contiguous()
    if ap.dtype != torch.float32 or not ap.is_contiguous():
        ap = ap.to(torch.float32).contiguous()
    if bp.dtype != torch.float32 or not bp.is_contiguous():
        bp = bp.to(torch.float32).contiguous()
    out = torch.empty((G, S, C), dtype=torch.float32, device=dev)
    rows, warps = matmul_tile_plan(S)
    err = _matmul_library(profile).fq_attn_matmul_launch(
        1 if variant == "mma" else 0, 1 if A.dtype == torch.bfloat16 else 0,
        MATMUL_MODES.index(mode), A.data_ptr(), B.data_ptr(), ap.data_ptr(),
        bp.data_ptr(), out.data_ptr(), G, S, K, C, ap.shape[0], bp.shape[0],
        rows, warps, a_bits, b_bits, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel ({variant}) launch "
                           f"failed: CUDA error {err}")
    wrapper.launches += 1
    wrapper.variant_launches[variant] += 1
    return out


def _attn_matmul(wrapper, mode, A, B, a_params, b_params, a_bits, b_bits,
                 variant, exact_ints):
    """What both wrappers and the dispatch do once the arguments are
    checked: count the call, route, then the plain version for CPU tensors
    or a launch for CUDA tensors. a_params and b_params are (P, 2) with P
    dividing G (the dispatch hands a site's per-head rows over as they are;
    the kernel reads row g % P)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: want one of {VARIANTS}")
    wrapper.calls += 1
    cpu = A.device.type == "cpu"
    if not cpu and A.device.type != "cuda":
        raise RuntimeError(f"{wrapper.__name__} has no path for {A.device}")
    G, S, K = A.shape
    C = B.shape[2]
    if not cpu or variant != "auto":
        if exact_ints is None:
            # asked only where the answer decides: an fp32 call that "mma"
            # would otherwise take (reading the zero points waits for the
            # device)
            exact_ints = variant != "fma" and A.dtype == torch.float32 \
                and matmul_mma_refusal(mode, G, S, K, C, A.dtype, a_bits,
                                       b_bits, True) is None \
                and (mode != "uniform"
                     or zero_points_exact(a_params, a_bits)) \
                and zero_points_exact(b_params, b_bits)
        variant = matmul_variant(mode, G, S, K, C, A.dtype, a_bits, b_bits,
                                 bool(exact_ints), variant)
    if cpu:
        if a_params.shape[0] != G:
            a_params = a_params.repeat(G // a_params.shape[0], 1)
        if b_params.shape[0] != G:
            b_params = b_params.repeat(G // b_params.shape[0], 1)
        return _attn_matmul_plain(
            A, B, a_params, b_params,
            "uniform" if mode == "uniform" else "adalog", a_bits, b_bits,
            mode == "softmax")
    return _launch_matmul(wrapper, mode, A, B, a_params, b_params, a_bits,
                          b_bits, variant)


def fq_attn_matmul(A, B, a_params, b_params, *, a_kind: str, a_bits: int,
                   b_bits: int, variant: str = "auto",
                   exact_ints: Optional[bool] = None):
    """Fused fake-quant batched matmul for attention sites (K3).

    A: (G, S, K); B: (G, K, C) with G = batch*heads flattened, float32 or
    bfloat16 (the compute dtype). a_params: (G, 2) [scale-or-q, zp];
    b_params: (G, 2) [scale, zp]. For a_kind='adalog', a_params[:, 0] holds
    the log base q (scale is 1.0, A in [0, 1]). Returns (G, S, C) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel; any
    other device raises. ``variant`` picks the kernel: "auto" routes by
    ``matmul_variant``, "mma" or "fma" force one (and raise where it does
    not take the call; a CPU call checks that too). ``exact_ints`` is the
    caller's verdict on the zero points (``integers_exact``); None has the
    wrapper read them itself when an fp32 call could take "mma", which
    waits for the device."""
    _check_matmul("fq_attn_matmul", A, B, a_params, b_params, a_kind, a_bits,
                  b_bits)
    return _attn_matmul(fq_attn_matmul, a_kind, A, B, a_params, b_params,
                        a_bits, b_bits, variant, exact_ints)


fq_attn_matmul.launches = 0
fq_attn_matmul.calls = 0
fq_attn_matmul.variant_launches = {"mma": 0, "fma": 0}


def fq_softmax_attn_matmul(L, B, a_params, b_params, *, a_bits: int,
                           b_bits: int, variant: str = "auto",
                           exact_ints: Optional[bool] = None):
    """softmax(L) -> AdaLog fake-quant -> @ fake-quant(B), all fused (K2).

    L: (G, S, K) pre-softmax attention logits (scale, bias and mask already
    applied); the row softmax runs in the kernel, so the probabilities never
    reach device memory. a_params: (G, 2) with the AdaLog base in column 0;
    b_params: (G, 2) [scale, zp]. Returns (G, S, C) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel; any
    other device raises. ``variant`` and ``exact_ints`` as for
    ``fq_attn_matmul``."""
    _check_matmul("fq_softmax_attn_matmul", L, B, a_params, b_params,
                  "adalog", a_bits, b_bits)
    return _attn_matmul(fq_softmax_attn_matmul, "softmax", L, B, a_params,
                        b_params, a_bits, b_bits, variant, exact_ints)


fq_softmax_attn_matmul.launches = 0
fq_softmax_attn_matmul.calls = 0
fq_softmax_attn_matmul.variant_launches = {"mma": 0, "fma": 0}

# the phases variant "mma" of K2 / K3 counts its cycles by, in the kernels'
# order (a body counts those it has)
MATMUL_PHASES = ("stage uq(B), code table", "loads of A", "mask, row max",
                 "exp, row sum", "AdaLog codes and values", "products",
                 "store")


def matmul_phase_cycles(mode: str, A, B, a_params, b_params, *, a_bits: int,
                        b_bits: int):
    """Where the cycles of one call of variant "mma" of K2 (``mode``
    "softmax") or K3 ("uniform", "adalog") go: {phase: cycles summed over
    the call's warps}, read with clock64 by a second build of the kernels
    (K23_PROFILE; the timers cost it some registers and time, so the shares
    are the result, not the sum; a load's wait is counted where its value is
    first used). CUDA tensors only; waits for the device."""
    wrapper = fq_softmax_attn_matmul if mode == "softmax" else fq_attn_matmul
    _check_matmul(wrapper.__name__, A, B, a_params, b_params,
                  "uniform" if mode == "uniform" else "adalog", a_bits,
                  b_bits)
    if A.device.type != "cuda":
        raise RuntimeError("matmul_phase_cycles times the kernel on a GPU")
    exact = A.dtype != torch.float32 or (
        zero_points_exact(b_params, b_bits)
        and (mode != "uniform" or zero_points_exact(a_params, a_bits)))
    G, S, K = A.shape
    matmul_variant(mode, G, S, K, B.shape[2], A.dtype, a_bits, b_bits, exact,
                   "mma")
    lib = _matmul_library(True)
    cycles = (ctypes.c_ulonglong * 8)()
    with torch.cuda.device(A.device):
        torch.cuda.synchronize()
        err = lib.fq_attn_matmul_profile(cycles)       # reads, then zeroes
        _launch_matmul(wrapper, mode, A, B, a_params, b_params, a_bits,
                       b_bits, "mma", profile=True)
        torch.cuda.synchronize()
        err = err or lib.fq_attn_matmul_profile(cycles)
    if err != 0:
        raise RuntimeError(f"fq_attn_matmul profile read failed: CUDA error "
                           f"{err}")
    return dict(zip(MATMUL_PHASES, cycles[:len(MATMUL_PHASES)]))


# ---------------------------------------------------------------------------
# Dispatch from the model forward
# ---------------------------------------------------------------------------

def supports(site, mode: str) -> bool:
    """K3: a quant-mode matmul site with uniform B and uniform or AdaLog
    A. (Whether the kernels are on is the predictor's plan.)"""
    if mode != "quant":
        return False
    Aq, Bq = site.Aq, site.Bq
    if Bq.kind != "uniform" or Bq.bits == 32 or Aq.bits == 32:
        return False
    return Aq.kind in A_KINDS


def supports_softmax(site, mode: str) -> bool:
    """K2, the fused-softmax variant: AdaLog A at frozen scale 1.0 only."""
    if mode != "quant":
        return False
    Aq, Bq = site.Aq, site.Bq
    return (Aq.kind == "adalog" and Aq.bits != 32 and not Aq.shifted
            and Bq.kind == "uniform" and Bq.bits != 32)


def supports_flash(m1_site, m2_site, m1_mode: str, m2_mode: str,
                   shape, dtype, exact_ints: Optional[bool] = None) -> bool:
    """K1, the fully fused path: matmul1 both-uniform, matmul2 AdaLog A
    (unshifted) and uniform B, both sites in quant mode (the shipped eval
    configuration), and a variant of the kernel that takes the call's
    ``shape`` (S, D) and ``dtype`` on a card (``flash_takes``), so that a
    forward takes the unfused path where neither does. ``exact_ints`` is
    the plan's verdict on the zero points; None reads it from the two
    sites."""
    if m1_mode != "quant" or m2_mode != "quant":
        return False
    if m1_site is None or m2_site is None:
        return False
    m1a, m1b = m1_site.Aq, m1_site.Bq
    if (m1a.kind != "uniform" or m1b.kind != "uniform"
            or m1a.bits == 32 or m1b.bits == 32
            or m1a.shifted or m1b.shifted):
        return False
    if not supports_softmax(m2_site, m2_mode):
        return False
    if exact_ints is None and dtype == torch.float32:
        exact_ints = integers_exact({"m1": m1_site, "m2": m2_site})
    bits = (m1a.bits, m1b.bits, m2_site.Aq.bits, m2_site.Bq.bits)
    return flash_takes(shape[0], shape[1], dtype, bits, bool(exact_ints))


def _period_params(qs):
    """(P, 2) float32 [scale-or-q, zp] of one quantizer, P its number of
    per-head rows (1 for a per-tensor layout): slice g = n * H + h of a
    flattened batch reads row g % P."""
    p0 = qs.log_q if qs.kind == "adalog" else qs.scale
    p0 = p0.reshape(-1).to(torch.float32)
    z = torch.zeros_like(p0[:1]) if qs.zero_point is None \
        else qs.zero_point.reshape(-1).to(torch.float32)
    P = max(p0.numel(), z.numel())
    return torch.stack([a if a.numel() == P else a[:1].expand(P)
                        for a in (p0, z)], dim=1).contiguous()


def site_params(site):
    """The (P, 2) parameter rows of a matmul site's A and B quantizers as
    K2 / K3 take them."""
    return _period_params(site.Aq), _period_params(site.Bq)


def _exact_ints():
    """The active plan's verdict on the zero points; None (each wrapper
    reads its own) without a plan."""
    plan = routes.current()
    return None if plan is None else plan.exact_ints


def _site_params(site, G: int, name):
    """A call's (A rows, B rows) of ``site``: the active plan's for
    ``name``, where it holds them, else flattened here."""
    plan = routes.current()
    rows = None if plan is None else plan.attn_rows(name, site)
    ap, bp = site_params(site) if rows is None else rows
    if G % ap.shape[0] or G % bp.shape[0]:
        raise ValueError(
            f"a site with {ap.shape[0]} and {bp.shape[0]} parameter rows "
            f"does not tile {G} slices")
    return ap, bp


def _flat_params(site, N: int, H: int, name):
    """A site's parameter rows repeated over the batch, (N * H, 2) each, as
    ``fq_flash_attn`` takes them; per-tensor layouts broadcast across
    heads."""
    return tuple(p.expand(H, 2).repeat(N, 1)
                 for p in _site_params(site, N * H, name))


def flash_args(m1_site, m2_site, q, kT, v, names=(None, None)):
    """The (G, ...) tensors and bit widths ``fq_flash_attn`` takes for 4D
    q, v: (N, H, S, D) and kT: (N, H, D, S) of the two attention sites
    (``names`` in the active plan)."""
    N, H, S, D = q.shape
    m1a, m1b = _flat_params(m1_site, N, H, names[0])
    m2a, m2b = _flat_params(m2_site, N, H, names[1])
    args = (q.reshape(N * H, S, D), kT.reshape(N * H, D, S),
            v.reshape(N * H, S, D), m1a, m1b, m2a[:, 0], m2b)
    bits = dict(m1a_bits=m1_site.Aq.bits, m1b_bits=m1_site.Bq.bits,
                m2a_bits=m2_site.Aq.bits, m2b_bits=m2_site.Bq.bits)
    return args, bits


def run_flash(m1_site, m2_site, q, kT, v, *, logit_scale: float, bias=None,
              names=(None, None)):
    """Run 4D q/kT/v through the fused kernel.

    q, v: (N, H, S, D); kT: (N, H, D, S); bias: None or (P, S, S) with P
    dividing N*H; ``names`` the two sites' names in the active plan. Returns
    (N, H, S, D) in q's dtype."""
    args, bits = flash_args(m1_site, m2_site, q, kT, v, names)
    out = fq_flash_attn(*args, bias, logit_scale=logit_scale,
                        exact_ints=_exact_ints(), **bits)
    return out.reshape(q.shape).to(q.dtype)


def run(site, A, B, *, name=None):
    """Run a 4D (N, H, S, K) @ (N, H, K, C) attention matmul of ``site``
    (``name`` in the active plan) through K3. Returns (N, H, S, C) in A's
    dtype."""
    N, H, S, K = A.shape
    C = B.shape[-1]
    ap, bp = _site_params(site, N * H, name)
    A3, B3 = A.reshape(N * H, S, K), B.reshape(N * H, K, C)
    _check_matmul("fq_attn_matmul", A3, B3, ap, bp, site.Aq.kind,
                  site.Aq.bits, site.Bq.bits, periodic=True)
    out = _attn_matmul(fq_attn_matmul, site.Aq.kind, A3, B3, ap, bp,
                       site.Aq.bits, site.Bq.bits, "auto", _exact_ints())
    return out.reshape(N, H, S, C).to(A.dtype)


def run_softmax(site, L, B, *, name=None):
    """Run 4D logits (N, H, S, K) and values (N, H, K, C) of the matmul2
    ``site`` (``name`` in the active plan) through K2. Returns (N, H, S, C)
    in L's dtype."""
    N, H, S, K = L.shape
    C = B.shape[-1]
    ap, bp = _site_params(site, N * H, name)
    L3, B3 = L.reshape(N * H, S, K), B.reshape(N * H, K, C)
    _check_matmul("fq_softmax_attn_matmul", L3, B3, ap, bp, "adalog",
                  site.Aq.bits, site.Bq.bits, periodic=True)
    out = _attn_matmul(fq_softmax_attn_matmul, "softmax", L3, B3, ap, bp,
                       site.Aq.bits, site.Bq.bits, "auto", _exact_ints())
    return out.reshape(N, H, S, C).to(L.dtype)
