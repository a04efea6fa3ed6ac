"""LayerNorm in one pass over device memory (kernel K7).

``models.layers.layer_norm`` computes LayerNorm over the last dimension
with ``layer_norm_plain``: mean, x - mu, square, mean, + eps, rsqrt,
* weight, + bias, which PyTorch runs eagerly as about nine launches that
read the row about seven times and write it about five. K7
(``csrc/layer_norm.cu``) is the same formula in one launch that reads each
row once into registers and writes the result once. It replaces no TPU
kernel: the JAX package leaves LayerNorm to XLA's fusion.

``layer_norm_rows`` is the wrapper: for a CPU tensor it runs the plain
version; for a CUDA tensor it launches the kernel or raises.
``layer_norm_rows.launches`` counts kernel launches,
``layer_norm_rows.variant_launches`` the same by layout ("warp": a row
within one warp, at D <= 1024; "block": several warps a row), and
``layer_norm_rows.calls`` every call on either device.

Which LayerNorms take it is decided once per predictor: ``plan_norms``
names the modules of a model that K7 takes (``supports``), and
``ops.routes.build`` puts them into the plan of a predictor on a CUDA
device. Calibration, BRECQ and training enter no plan, so they run the
plain version, as does every LayerNorm on the CPU. Numerics: in float32 the
kernel differs from the plain version only in the order of its two sums;
in bfloat16 it computes in float32 and rounds once, where the plain
version rounds every step to bfloat16.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from adalog_tpu_torch.ops import cuda_build
from adalog_tpu_torch.ops.fq_act import row_layout as strided_rows

MAX_VALS = 32          # values a thread of K7 holds in registers
THREADS_PER_ROW = (4, 8, 16, 32, 128, 512)
MAX_D = MAX_VALS * THREADS_PER_ROW[-1]
LAYOUTS = ("warp", "block")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the device types whose predictors route LayerNorms to K7
DEVICES = ("cuda",)
# the names of per-head LayerNorms (vit.py's q_norm / k_norm): they act on
# q and k permuted to (B, H, N, head_dim), whose rows fold into no single
# stride, so they stay on the plain version
_PER_HEAD = ("q_norm", "k_norm")


def layer_norm_plain(x, weight, bias, eps):
    """LayerNorm of x over its last dimension, as eager PyTorch: the plain
    version, which every LayerNorm outside a predictor's plan runs."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * weight + bias


def supports(norm) -> bool:
    """Whether K7 takes LayerNorm module ``norm``: an affine LayerNorm over
    the last dimension, of 1 to MAX_D values, with a weight and a bias of
    one float32 or bfloat16 dtype."""
    w, b = norm.weight, norm.bias
    return (isinstance(norm, torch.nn.LayerNorm) and w is not None
            and b is not None and w.dim() == 1 and b.shape == w.shape
            and 1 <= w.numel() <= MAX_D and w.dtype in _DTYPE_CODE
            and b.dtype == w.dtype)


def plan_norms(model) -> frozenset:
    """The LayerNorm modules of ``model`` that K7 takes, on a device of
    DEVICES (per-head ones aside): what a predictor's plan routes to K7."""
    return frozenset(
        m for name, m in model.named_modules()
        if isinstance(m, torch.nn.LayerNorm)
        and name.rsplit(".", 1)[-1] not in _PER_HEAD
        and m.weight is not None and m.weight.device.type in DEVICES
        and supports(m))


def threads_per_row(D: int) -> int:
    """Threads that take a row of D values: the fewest of THREADS_PER_ROW
    that hold it at MAX_VALS a thread (a thread's values are its loads in
    flight); within a warp to 1024, then 128 or 512."""
    for t in THREADS_PER_ROW:
        if D <= MAX_VALS * t:
            return t
    raise ValueError(f"K7 takes rows of at most {MAX_D} values, not {D}")


def unit_bytes(itemsize: int, D: int, rows: int, lda: int, *ptrs) -> int:
    """The widest load K7 can use (16, 8, 4, or 2 for bfloat16): a row of
    D values, every pointer of ``ptrs`` (x, out, weight, bias) and, for
    more than one row, x's row stride ``lda`` multiples of it."""
    for unit in (16, 8, 4, 2):
        if unit < itemsize:
            break
        if D * itemsize % unit == 0 and all(p % unit == 0 for p in ptrs) \
                and (rows == 1 or lda * itemsize % unit == 0):
            return unit
    return itemsize


def rows_of(x):
    """(rows, D, row stride) of x read as rows of its last dimension: the
    leading dimensions must fold into one row stride and the last be
    contiguous; None where they do not."""
    D = x.shape[-1]
    if x.is_contiguous():
        return x.numel() // D, D, D
    return strided_rows(x)


# ---------------------------------------------------------------------------
# CUDA kernel: load, launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.library("layer_norm")
    fn = lib.layer_norm_rows_launch
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def layer_norm_rows(norm, x):
    """LayerNorm module ``norm`` applied to x over its last dimension, a new
    contiguous tensor of x's shape and dtype. A CPU tensor runs the plain
    version; a CUDA tensor launches K7 on the current stream, or raises
    where K7 cannot take the call: a module ``supports`` refuses, x of
    another width, dtype or device than the module's, rows that fold into
    no single stride, or a call autograd would record (K7 has no
    backward)."""
    layer_norm_rows.calls += 1
    w, b = norm.weight, norm.bias
    if x.device.type == "cpu":
        return layer_norm_plain(x, w, b, norm.eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"layer_norm_rows has no path for {x.device}")
    if not supports(norm):
        raise ValueError(f"layer_norm_rows: K7 does not take {norm}")
    D = w.numel()
    if x.dtype != w.dtype or x.device != w.device or x.shape[-1] != D:
        raise ValueError(
            f"layer_norm_rows: x {tuple(x.shape)} {x.dtype} on {x.device} "
            f"against a LayerNorm of {D} {w.dtype} values on {w.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        raise RuntimeError("layer_norm_rows: K7 has no backward; run a "
                           "call that autograd records outside a plan")
    layout = rows_of(x)
    if layout is None:
        raise ValueError(f"layer_norm_rows: the rows of x {tuple(x.shape)} "
                         f"(strides {x.stride()}) are not evenly strided")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    rows, _, lda = layout
    tpr = threads_per_row(D)
    unit = unit_bytes(x.element_size(), D, rows, lda, x.data_ptr(),
                      out.data_ptr(), w.data_ptr(), b.data_ptr())
    err = _library().layer_norm_rows_launch(
        _DTYPE_CODE[x.dtype], unit, tpr, x.data_ptr(), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), rows, D, lda, norm.eps,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm_rows kernel launch failed: CUDA "
                           f"error {err}")
    layer_norm_rows.launches += 1
    layer_norm_rows.variant_launches["warp" if tpr <= 32 else "block"] += 1
    return out


layer_norm_rows.launches = 0
layer_norm_rows.calls = 0
layer_norm_rows.variant_launches = {k: 0 for k in LAYOUTS}
