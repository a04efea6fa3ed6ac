"""Logarithmic fake quantization: log2, log-sqrt2, and the AdaLog quantizer.

All log quantizers share the front end:
    scaled = clamp(x/scale, 1e-15, 1.0); code = round(-log2(scaled) * k)
    codes >= 2N underflow to zero;       codes clamped to [0, 2N-1]
with N = 2**(bits-1) and k the base factor (1 for log2, 2 for log-sqrt2,
r/q for AdaLog).

AdaLog quantizes with base 2**(q/r), r fixed at 37 and integer q searched
during calibration. Its inference dequant splits 2**(-code*q/r) into a right
shift and a fixed-point mantissa:
    table1[i] = floor(i*q/r)                                   (shift amount)
    table2[i] = round(2**(-((q*i) mod r)/r) * (4N-2)) / (4N-2) (mantissa)
    dq = 2**(-table1[code]) * table2[code] * scale
evaluated here in closed form on the integer products (floor and mod of
integer-valued floats are exact), with ``make_adalog_tables`` materializing
the lookup tables for checkpoints.

``torch.log2`` may differ from XLA's by an ulp, so a value within an ulp of
a .5 code boundary can round to the neighbouring code in the two packages.
"""

import math

import numpy as np
import torch

from adalog_tpu_torch.quantizers.ste import round_ste

ADALOG_R = 37.0
_EPS = 1e-15


def _log_codes(x, scale, k, bits: int, training: bool):
    """Codes clamped to [0, 2N-1] and the keep mask of in-range codes."""
    N = 2 ** (bits - 1)
    scaled = torch.clamp(x / scale, _EPS, 1.0)
    rnd = round_ste if training else torch.round
    code = rnd(-torch.log2(scaled) * k)
    keep = code < 2 * N   # codes beyond the last level dequantize to exactly 0
    code = torch.clamp(code, 0, 2 * N - 1)
    return code, keep


def log2_quant(x, scale, *, bits: int, training: bool = False):
    """Power-of-two quantizer: dq = 2**(-code) * scale."""
    if bits == 32:
        return x
    code, keep = _log_codes(x, scale, 1.0, bits, training)
    return torch.exp2(-code) * scale * keep


def logsqrt2_quant(x, scale, *, bits: int, training: bool = False):
    """Base-sqrt(2) quantizer. Inference splits 2**(-code/2) into a shift of
    ceil(code/2) times (sqrt(2)-1)+1 for odd codes."""
    if bits == 32:
        return x
    code, keep = _log_codes(x, scale, 2.0, bits, training)
    if training:
        dq = torch.exp2(-code / 2.0) * scale
    else:
        odd = (code % 2) * (math.sqrt(2.0) - 1.0) + 1.0
        dq = torch.exp2(-torch.ceil(code / 2.0)) * odd * scale
    return dq * keep


def adalog_mantissa(frac_codes, bits: int, r: float = ADALOG_R):
    """Fixed-point mantissa round(2**(-j/r) * (4N-2)) / (4N-2) for integer j."""
    ts = 1.0 / (4 * 2 ** (bits - 1) - 2)
    return torch.round(torch.exp2(-frac_codes / r) / ts) * ts


def adalog_dequant_code(code, q, *, bits: int, r: float = ADALOG_R):
    """Shift-and-mantissa dequant of integer codes."""
    prod = code * q
    shift = torch.floor(prod / r)
    frac = torch.round(torch.remainder(prod, r))
    return torch.exp2(-shift) * adalog_mantissa(frac, bits, r)


def adalog_quant(x, scale, q, *, bits: int, r: float = ADALOG_R,
                 training: bool = False):
    """AdaLog fake quantization with log base 2**(q/r); q is a tensor or a
    number. Training uses the continuous 2**(-code*q/r) with straight-through
    rounding; inference the exact shift-and-mantissa form."""
    if bits == 32:
        return x
    code, keep = _log_codes(x, scale, r / q, bits, training)
    if training:
        dq = torch.exp2(-code * q / r) * scale
    else:
        dq = adalog_dequant_code(code, q, bits=bits, r=r) * scale
    return dq * keep


def make_adalog_tables(q: int, bits: int, r: float = ADALOG_R):
    """Reference-format lookup tables (table1 shifts, table2 mantissas) for
    codes [0, 2N), computed in float64 and cast to float32."""
    N = 2 ** (bits - 1)
    i = np.arange(2 * N, dtype=np.float64)
    q = float(q)
    table1 = np.floor(i * q / r)
    ts = 1.0 / (4 * N - 2)
    table2 = np.round(np.exp2(-np.mod(q * i, r) / r) / ts) * ts
    return (torch.from_numpy(table1.astype(np.float32)),
            torch.from_numpy(table2.astype(np.float32)))


def make_mantissa_table(bits: int, r: float = ADALOG_R, size: int = 120):
    """The fixed 120-entry mantissa table round(2**(-j/r)/ts)*ts that the
    calibration searches gather from. Depends only on bits and r."""
    j = np.arange(size, dtype=np.float64)
    ts = 1.0 / (4 * 2 ** (bits - 1) - 2)
    return torch.from_numpy(
        (np.round(np.exp2(-j / r) / ts) * ts).astype(np.float32))
