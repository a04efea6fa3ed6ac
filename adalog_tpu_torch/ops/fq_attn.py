"""Fused fake-quant attention (kernel K1): the whole quantized attention of a
ViT block in one CUDA kernel.

    uq(q) @ uq(kT) -> * logit_scale -> (+ bias) -> row softmax
      -> AdaLog fake-quant at scale 1 -> @ uq(v)

uq is the per-slice asymmetric uniform quantizer of the matmul sites; the
AdaLog quantizer of the post-softmax site runs at its frozen scale 1.0 with
the searched base q. The counterpart of ``adalog_tpu.ops.fq_attn``'s flash
path (``fq_flash_attn``, dispatched by ``run_flash``).

``fq_flash_attn`` is the wrapper: for CPU tensors it runs
``fq_flash_attn_plain``, the same math in plain PyTorch; for CUDA tensors it
launches the kernel in ``csrc/fq_flash_attn.cu``, built with nvcc the first
time it is needed, or raises. ``fq_flash_attn.launches`` counts launches.
"""

from __future__ import annotations

import contextvars
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from contextlib import contextmanager

import torch

from adalog_tpu_torch.quantizers.logarithm import ADALOG_R

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_SOURCE = os.path.join(_CSRC, "fq_flash_attn.cu")
_BUILD_DIR = os.path.join(_CSRC, "build")

# must match fq_flash_attn.cu
_WARPS = 12
_MAX_SMEM_BYTES = 232448          # opt-in dynamic shared memory of one block
_MAX_HEAD_DIM = 128               # 4 output columns per lane


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


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME): the fq_flash_attn "
                       "kernel is built from csrc/ at first use")


def build() -> str:
    """Compile csrc/fq_flash_attn.cu into csrc/build/ (keyed by the source's
    hash) unless that library exists; returns its path. The compiler's
    report (registers, shared memory, spills) goes to ``<path>.log``."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(_BUILD_DIR, f"libfq_flash_attn_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, _SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    with open(f"{lib}.log", "w") as f:
        f.write(res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build())
    fn = lib.fq_flash_attn_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _smem_bytes(S: int, D: int) -> int:
    """Dynamic shared memory of one block: uq(kT) and uq(v) of the slice
    plus one q row and one probability row per warp, all fp32."""
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
    """Raise for shapes the kernel does not take: the staged uq(kT) and uq(v)
    of one slice must fit in one block's shared memory (fp32 at S=577,
    D=64 does not), and the head dim is at most 128."""
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {_MAX_HEAD_DIM}")
    if _smem_bytes(S, D) > _MAX_SMEM_BYTES:
        raise ValueError(
            f"S={S}, D={D} needs {_smem_bytes(S, D)} bytes of shared memory "
            f"per block, above {_MAX_SMEM_BYTES}")


def _launch(q, kT, v, m1a_params, m1b_params, m2q, m2b_params, bias,
            bits, logit_scale):
    check_kernel_shape(q.shape[1], q.shape[2])
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
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fq_flash_attn_launch(
            1 if q.dtype == torch.bfloat16 else 0,
            q.data_ptr(), kT.data_ptr(), v.data_ptr(),
            prm[0].data_ptr(), prm[1].data_ptr(), prm[2].data_ptr(),
            prm[3].data_ptr(),
            None if bias_f is None else bias_f.data_ptr(), out.data_ptr(),
            0 if bias_f is None else bias_f.shape[0], G, S, D, *bits,
            float(logit_scale), stream)
    if err != 0:
        raise RuntimeError(f"fq_flash_attn kernel launch failed: CUDA error "
                           f"{err}")
    fq_flash_attn.launches += 1
    return out


def fq_flash_attn(q, kT, v, m1a_params, m1b_params, m2q, m2b_params,
                  bias=None, *, m1a_bits: int, m1b_bits: int, m2a_bits: int,
                  m2b_bits: int, logit_scale: float):
    """Fully fused fake-quant attention.

    q: (G, S, D); kT: (G, D, S); v: (G, S, D), float32 or bfloat16 (the
    compute dtype). m1a/m1b/m2b_params: (G, 2) [scale, zp] of q, kT and v;
    m2q: (G,) AdaLog base of the probabilities (scale frozen at 1.0).
    bias: None or (P, S, S) additive logit bias, P dividing G; slice g reads
    bias[g % P]. Returns (G, S, D) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel; any
    other device raises."""
    bits = (m1a_bits, m1b_bits, m2a_bits, m2b_bits)
    _check(q, kT, v, m1a_params, m1b_params, m2q, m2b_params, bias, bits)
    if q.device.type == "cpu":
        return fq_flash_attn_plain(
            q, kT, v, m1a_params, m1b_params, m2q, m2b_params, bias,
            m1a_bits=m1a_bits, m1b_bits=m1b_bits, m2a_bits=m2a_bits,
            m2b_bits=m2b_bits, logit_scale=logit_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"fq_flash_attn has no path for {q.device}")
    return _launch(q, kT, v, m1a_params, m1b_params, m2q, m2b_params, bias,
                   bits, logit_scale)


fq_flash_attn.launches = 0


# ---------------------------------------------------------------------------
# Dispatch from the model forward
# ---------------------------------------------------------------------------

_ENABLED: contextvars.ContextVar = contextvars.ContextVar(
    "adalog_fq_attn_enabled", default=False)


@contextmanager
def activate(flag: bool):
    """Route supported attention sites through ``fq_flash_attn`` inside the
    block (a predictor enters it around its forward)."""
    tok = _ENABLED.set(bool(flag))
    try:
        yield
    finally:
        _ENABLED.reset(tok)


def enabled() -> bool:
    return _ENABLED.get()


def supports_flash(m1_site, m2_site, m1_mode: str, m2_mode: str) -> bool:
    """Fused path: matmul1 both-uniform, matmul2 AdaLog A (unshifted) and
    uniform B, both sites in quant mode (the shipped eval configuration)."""
    if not enabled() or m1_mode != "quant" or m2_mode != "quant":
        return False
    if m1_site is None or m2_site is None:
        return False
    m1a, m1b = m1_site.Aq, m1_site.Bq
    if (m1a.kind != "uniform" or m1b.kind != "uniform"
            or m1a.bits == 32 or m1b.bits == 32
            or m1a.shifted or m1b.shifted):
        return False
    Aq, Bq = m2_site.Aq, m2_site.Bq
    return (Aq.kind == "adalog" and Aq.bits != 32 and not Aq.shifted
            and Bq.kind == "uniform" and Bq.bits != 32)


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
    out = fq_flash_attn(*args, bias, logit_scale=logit_scale, **bits)
    return out.reshape(q.shape).to(q.dtype)
