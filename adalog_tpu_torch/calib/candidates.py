"""Candidate generation for the calibration search, the counterpart of
``adalog_tpu.calib.candidates``.

Percentile-derived scale grids crossed with an integer zero-point grid:
  weights      per row group, num_zp = min(16, N)
  activations  per tensor or channel, num_zp = min(16, 2N)
  matmul       per head
  post-GeLU    percentile over the positive values only
Candidate e decomposes as (zp_index, scale_index) with the scale varying
fastest: the FPCS delta (the step between adjacent scale candidates) relies
on this layout.

Quantiles are exact, by a full sort (``quantile``), and equal
``jnp.quantile``'s bit for bit: ``torch.quantile`` refuses inputs past 2^24
elements and need not round its interpolation as numpy's "linear" formula
does. The activation and matmul grids take quantiles along a token or image
axis that may be dp-sharded: under ``parallel.mesh.dp_context`` they select
the order statistics across the ranks (``parallel.mesh.dp_order_stats``),
bit for bit as one device would.
"""

from __future__ import annotations

import torch

from adalog_tpu_torch.ops.scoring import tdiv
from adalog_tpu_torch.parallel.mesh import (
    dp_count, dp_mesh, dp_order_stats, dp_sum, from_order_key, order_key,
)


def _order_stats(x, idx, mesh):
    """(..., len(idx)): the idx-th smallest of x along its last dim in the
    floats' total order (-0.0 before +0.0), that dim sharded over
    ``mesh``'s dp group when it is not None."""
    keys = torch.sort(order_key(x), dim=-1).values
    return from_order_key(dp_order_stats(keys, idx, mesh))


def quantile(x, qs, dim=None, mesh=None):
    """``jnp.quantile(x, qs, axis=dim)`` (method 'linear') for a float32
    tensor x and a 1-D float32 tensor qs, bit for bit: the values sorted
    along ``dim`` (all of x when None); t = qs * (n - 1) in float32, lo =
    floor(t), hi = ceil(t), w = t - lo, each index clamped to n - 1 in
    float32 (past 2^24 elements that may round up, and then reads the last
    value, as XLA's gather clamps); then v[lo] * (1 - w) + v[hi] * w with
    one of the two products fused into the add, as XLA's CPU code does: the
    hi product for a full reduction (a 1-D result), the lo product along an
    axis (an exact float64 product and sum stand for the fused
    multiply-add). The sort puts -0.0 before +0.0 where jnp.quantile's
    keeps the two in input order, so the results can differ in the sign of
    a zero only. With ``mesh``, ``dim`` (all of x when None) is sharded
    over its dp group and n is its global size.
    Returns (len(qs), *x.shape without dim)."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    xl = x.movedim(dim, -1)
    n = dp_count(xl.shape[-1], mesh)
    qs = qs.to(device=x.device, dtype=torch.float32)
    last = torch.tensor(n, dtype=torch.float32, device=x.device) - 1
    t = qs * last
    lo, hi = torch.floor(t), torch.ceil(t)
    w_hi = t - lo
    w_lo = 1 - w_hi

    def index(i):
        i = torch.minimum(torch.clamp(i, min=0), last).to(torch.int64)
        return torch.clamp(i, max=n - 1)

    k = len(qs)
    v = _order_stats(xl, torch.cat([index(lo), index(hi)]), mesh)
    v_lo = v[..., :k].movedim(-1, 0)               # (len(qs), *rest)
    v_hi = v[..., k:].movedim(-1, 0)
    shape = (-1,) + (1,) * (v_lo.dim() - 1)
    lo_term = (v_lo.double(), w_lo.reshape(shape).double())
    hi_term = (v_hi.double(), w_hi.reshape(shape).double())
    fused, other = (hi_term, lo_term) if v_lo.dim() == 1 else \
        (lo_term, hi_term)
    rounded = (other[0] * other[1]).float().double()
    return (fused[0] * fused[1] + rounded).float()


def _upper_lower(x, pct, dim=None, mesh=None):
    """(quantiles at pct, at 1 - pct) of one selection: each entry of qs is
    its own element-wise computation, so this equals two calls."""
    q = quantile(x, torch.cat([pct, 1.0 - pct]), dim=dim, mesh=mesh)
    return q[:len(pct)], q[len(pct):]


def _pct(l, r, device):
    return torch.tensor([l, r], dtype=torch.float32, device=device)


def _linspace01(n, device):
    """``jnp.linspace(0, 1, n)`` bit for bit: i * (1 / (n - 1)) for
    i < n - 1 (XLA multiplies by the reciprocal of the constant), then 1."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    i = torch.arange(n - 1, dtype=torch.float32, device=device)
    step = tdiv(torch.ones((), dtype=torch.float32, device=device), n - 1)
    return torch.cat([i * step, torch.ones(1, dtype=torch.float32,
                                           device=device)])


def _zp_grid(bits: int, num_zp: int, device) -> torch.Tensor:
    N = 2 ** (bits - 1)
    return torch.arange(N - num_zp // 2, N + num_zp // 2, dtype=torch.float32,
                        device=device)


def _grid(delta_min, delta_max, bits, num_zp, num_scale, clip=False):
    """(scales2d, zps2d) of shape (num_zp * num_scale, U) from the (1, U)
    percentile ranges."""
    N = 2 ** (bits - 1)
    dev = delta_min.device
    splits = _linspace01(num_scale, dev)[:, None] * (delta_max - delta_min)
    scales = tdiv(delta_min + splits, 2 * N - 1).repeat(num_zp, 1)
    if clip:
        scales = torch.clamp(scales, min=1e-4)
    zps = torch.repeat_interleave(_zp_grid(bits, num_zp, dev),
                                  num_scale)[:, None]
    return scales, zps.expand(scales.shape)


def weight_candidates(w_v, bits: int, eq_n: int, l=0.9, r=1.0):
    """w_v: (V, R, I) -> scales2d/zps2d (eq_n, V*R) canonical unit layout."""
    N = 2 ** (bits - 1)
    num_zp = min(16, N, eq_n)
    num_scale = eq_n // num_zp
    V, R, _ = w_v.shape
    pct = _pct(l, r, w_v.device)
    uppers, lowers = _upper_lower(w_v, pct, dim=-1)   # (2, V, R) each
    delta_min = (uppers[0] - lowers[0]).reshape(1, V * R)
    delta_max = (uppers[1] - lowers[1]).reshape(1, V * R)
    return _grid(delta_min, delta_max, bits, num_zp, num_scale)


def act_candidates(x2d, bits: int, eq_n: int, *, channel_wise: bool,
                   l=0.9, r=1.0):
    """x2d: (T, I) -> scales2d/zps2d of shape (eq_n, 1) or (eq_n, I). T
    may be dp-sharded (``dp_context``)."""
    N = 2 ** (bits - 1)
    num_zp = min(16, 2 * N, eq_n)
    num_scale = eq_n // num_zp
    pct = _pct(l, r, x2d.device)
    if channel_wise:                                  # (2, I) each
        uppers, lowers = _upper_lower(x2d, pct, dim=0, mesh=dp_mesh())
    else:                                             # (2, 1) each
        uppers, lowers = (q[:, None] for q in _upper_lower(
            x2d, pct, mesh=dp_mesh()))
    delta_min = (uppers[0] - lowers[0])[None, :]
    delta_max = (uppers[1] - lowers[1])[None, :]
    return _grid(delta_min, delta_max, bits, num_zp, num_scale, clip=True)


def matmul_candidates(op, bits: int, eq_n: int, *, head_channel_wise: bool,
                      l=0.9, r=1.0):
    """op: (N, H, S, C) -> scales2d/zps2d (eq_n, H) or (eq_n, 1); N may be
    dp-sharded (``dp_context``).

    num_zp follows the B-operand bit width for both operands; callers pass
    the B bits here."""
    N = 2 ** (bits - 1)
    num_zp = min(16, N, eq_n)
    num_scale = eq_n // num_zp
    pct = _pct(l, r, op.device)
    if head_channel_wise:
        H = op.shape[1]
        per_head = op.movedim(1, 0).reshape(H, -1)
        uppers, lowers = _upper_lower(per_head, pct, dim=-1,  # (2, H)
                                      mesh=dp_mesh())
    else:
        uppers, lowers = (q[:, None] for q in _upper_lower(
            op, pct, mesh=dp_mesh()))
    delta_min = (uppers[0] - lowers[0])[None, :]
    delta_max = (uppers[1] - lowers[1])[None, :]
    return _grid(delta_min, delta_max, bits, num_zp, num_scale)


def positive_percentile(flat, qs, mesh=None):
    """Percentile over the strictly positive values of flat (M,): rank =
    clip(ceil(count * q) - 1, 0) over the ascending-sorted positives; 0 where
    there are none. With ``mesh``, flat is sharded over its dp group and
    count and M are global."""
    pos = flat > 0
    count = dp_sum(torch.sum(pos), mesh).to(torch.float32)
    ranks = torch.clamp(torch.ceil(count * qs).to(torch.int32) - 1, 0,
                        dp_count(flat.numel(), mesh) - 1).to(torch.int64)
    # non-positives sort to the end as +inf
    vals = _order_stats(torch.where(pos, flat, torch.inf), ranks, mesh)
    return torch.where(count > 0, vals, torch.zeros_like(vals))


def postgelu_scale_candidates(x2d, shift, eq_n: int, l=0.9, r=1.0):
    """The post-GeLU scale grid: eq_n points interpolated between the l and
    r positive percentiles of x, plus ``shift``; x's tokens may be
    dp-sharded (``dp_context``). Returns (ud (2,), scales2d (eq_n, 1))."""
    ud = positive_percentile(x2d.reshape(-1), _pct(l, r, x2d.device),
                             dp_mesh())
    ud = ud + shift
    t = tdiv(torch.arange(eq_n, dtype=torch.float32, device=x2d.device),
             eq_n - 1)
    return ud, (ud[0] + (ud[1] - ud[0]) * t)[:, None]
