"""FPCS hyperparameter search, per quant-site family: the counterpart of
``adalog_tpu.calib.search``.

FPCS (Fast Progressive Combining Search): score a percentile-derived
candidate grid, keep the top-k, re-grid around each survivor with a
shrinking delta, and repeat ``steps`` times, the last step keeping the
top-1. The candidate count is always eq_n. Canonical layout: scales and
zero points as (E, U) with U independent units (row groups, channels, heads,
or 1), the scale index varying fastest.

Each family has a single-site function and a ``_batched`` form that searches
L same-shape sites together: ``torch.func.vmap`` of the single-site function
over a leading site axis, with the scoring memory budget divided by L. The
JAX package's ``lax.scan`` loops (FPCS steps, search rounds) are Python
loops here. Ties among candidate scores keep the lower index first, as
``jax.lax.top_k`` and ``jnp.argmax`` do.

Inside ``parallel.mesh.dp_context`` the token (or image) axis of every
input but the weights is this rank's dp slice: the scores and candidate
grids reduce over the dp group (ops/scoring.py, calib/candidates.py), so
every rank ranks the same scores and picks the same candidates. The
batched forms keep their vmap there: the collectives' vmap rule reduces the
stacked sites at once.
"""

from __future__ import annotations

import logging

import torch

from adalog_tpu_torch.calib import candidates as C
from adalog_tpu_torch.ops import scoring as S
from adalog_tpu_torch.ops.scoring import tdiv
from adalog_tpu_torch.parallel.mesh import dp_max, dp_mesh

log = logging.getLogger("adalog_tpu_torch")


# ---------------------------------------------------------------------------
# Generic FPCS over canonical (E, U) candidates
# ---------------------------------------------------------------------------

def top_k_indices(sims, k: int):
    """The indices of the k largest entries of sims along dim 0, largest
    first, equal scores in ascending index order (``jax.lax.top_k``'s
    order; ``torch.topk`` promises none for ties)."""
    return torch.sort(sims, dim=0, descending=True, stable=True).indices[:k]


def _topk_gather(sims, scales, zps, k):
    """sims/scales/zps: (E, U) -> the top-k per unit: (k, U) each."""
    idx = top_k_indices(sims, k)
    return torch.gather(scales, 0, idx), torch.gather(zps, 0, idx)


def fpcs(score2d, scales, zps, *, eq_n: int, steps: int, width: int = 16,
         clamp_min=None, delta=None):
    """Run the FPCS schedule; returns (best_scale (U,), best_zp (U,)).

    steps=1 is a single scoring pass over the initial grid (the reference's
    fpcs=False path). Refine grid: offsets (linspace(0, 1, cnt) - 0.5) times
    the current delta, the delta shrinking by (cnt - 0.5) each step. The
    first delta is scales[1] - scales[0] unless the caller gives it
    (``candidates._grid``'s ``self_delta``)."""
    if delta is None:
        delta = scales[1] - scales[0]             # (U,) adjacent-scale step
    cnt = eq_n // width
    if steps > 1 and cnt < 2:
        # faithful to the reference, but degenerate: with one child per
        # survivor the refine step is a fixed -0.5*delta shift and the delta
        # DOUBLES each step (delta /= cnt-0.5 = 0.5), a noise-sensitive
        # random walk instead of a contraction (the width-32 joint FPCS when
        # eq_n < 64). The shipped configs (eq_n=128) never hit this.
        log.warning(
            "fpcs: eq_n=%d with width=%d gives refine count 1 — the "
            "refinement degenerates to a diverging scale walk (use eq_n >= "
            "%d)", eq_n, width, 2 * width)
    sims = score2d(scales, zps)
    if steps == 1:
        best_s, best_z = _topk_gather(sims, scales, zps, 1)
        return best_s[0], best_z[0]
    k_s, k_z = _topk_gather(sims, scales, zps, width)
    offs = (C._linspace01(cnt, scales.device) - 0.5)[None, :, None]
    for _ in range(steps - 1):
        # k + offs * delta and delta / (cnt - 0.5) in the JAX package's
        # arithmetic (candidates.xla_fma, xla_div)
        cands_s = C.xla_fma(offs, delta, k_s[:, None, :]).reshape(eq_n, -1)
        if clamp_min is not None:
            cands_s = torch.clamp(cands_s, min=clamp_min)
        cands_z = torch.repeat_interleave(k_z, cnt, dim=0)
        sims = score2d(cands_s, cands_z)
        k_s, k_z = _topk_gather(sims, cands_s, cands_z, width)
        best_s, best_z = _topk_gather(sims, cands_s, cands_z, 1)
        delta = C.xla_div(delta, cnt - 0.5)
    return best_s[0], best_z[0]


def _steps(fpcs_on: bool, steps: int) -> int:
    return steps if fpcs_on else 1


def _vmap(one, *args):
    """``one`` over the leading site axis of every tensor in args."""
    return torch.func.vmap(one)(*args)


# ---------------------------------------------------------------------------
# Linear family
# ---------------------------------------------------------------------------

def _wq(w_v, scale_u, zp_u, bits):
    """Quantize the viewed weight with per-unit (V*R) params."""
    V, R, _ = w_v.shape
    return S.uq_asym(w_v, scale_u.reshape(V, R, 1), zp_u.reshape(V, R, 1),
                     bits)


def _per_tensor(s2d):
    """(E, 1) candidates -> (E, 1, 1), broadcast per candidate against a
    (T, I) tensor."""
    return s2d[:, :, None]


def _weight_search(w_v, w_bits, eq_n, st, mem_scale):
    """The weight self-FPCS shared by the Linear families: (candidate
    grid, its expand to (E, V, R, 1), best scale and zero point)."""
    V, R, _ = w_v.shape

    def exp_w(s2d, z2d):
        return s2d.reshape(-1, V, R, 1), z2d.reshape(-1, V, R, 1)

    ws0, wz0, delta = C.weight_candidates(w_v, w_bits, eq_n, self_delta=True)
    w_s, w_z = fpcs(
        lambda s, z: S.score_weight_self(w_v, *exp_w(s, z), w_bits,
                                         mem_scale).reshape(eq_n, V * R),
        ws0, wz0, eq_n=eq_n, steps=st, delta=delta)
    return ws0, wz0, exp_w, w_s, w_z


def _w_out_fpcs(x_q, tgt, w_v, ws0, wz0, exp_w, w_bits, eq_n, st, gram,
                mem_scale):
    """Weight output-MSE FPCS against the quantized input x_q."""
    V, R, _ = w_v.shape
    if gram:
        G, Cm = S.gram_stats(x_q, tgt)

        def w_score(s, z):
            return S.score_linear_w_out_gram(G, Cm, w_v, *exp_w(s, z),
                                             w_bits, mem_scale
                                             ).reshape(eq_n, V * R)
    else:
        def w_score(s, z):
            return S.score_linear_w_out(x_q, tgt, w_v, *exp_w(s, z), w_bits,
                                        mem_scale).reshape(eq_n, V * R)
    return fpcs(w_score, ws0, wz0, eq_n=eq_n, steps=st)


def _linear_default_impl(x, y, w, b, *, w_bits: int, a_bits: int, n_V: int,
                         eq_n: int, steps: int, rounds: int, use_fpcs: bool,
                         gram: bool = False, a_gram: bool = False,
                         mem_scale: int = 1):
    """The default asymmetric Linear search.

    x: (T, I) flattened input; y: (T, O) raw output; w: (O, I); b: (O,).
    Weight self-FPCS, activation self-FPCS, then ``rounds`` alternating
    output-MSE FPCS passes over weights and activations. Returns
    (w_scale (V,R,1), w_zp, a_scale (1,), a_zp (1,))."""
    O, I = w.shape
    V, R = n_V, O // n_V
    w_v = w.reshape(V, R, I)
    tgt = y - b if b is not None else y
    st = _steps(use_fpcs, steps)

    ws0, wz0, exp_w, w_s, w_z = _weight_search(w_v, w_bits, eq_n, st,
                                               mem_scale)
    as0, az0 = C.act_candidates(x, a_bits, eq_n, channel_wise=False)
    a_s, a_z = fpcs(
        lambda s, z: S.score_act_self(x, _per_tensor(s), _per_tensor(z),
                                      a_bits, channel_wise=False, n_batch=1,
                                      mem_scale=mem_scale).reshape(eq_n, 1),
        as0, az0, eq_n=eq_n, steps=st, clamp_min=1e-4)

    # the percentile grids do not depend on the round: made once, reused
    for _ in range(rounds):
        x_q = S.uq_asym(x, a_s, a_z, a_bits)
        w_s, w_z = _w_out_fpcs(x_q, tgt, w_v, ws0, wz0, exp_w, w_bits, eq_n,
                               st, gram, mem_scale)
        w_q2 = _wq(w_v, w_s, w_z, w_bits).reshape(O, I)
        if a_gram and O > I:
            # the Gram form pays off only where out_features > in_features
            # (qkv, fc1, head)
            Mw, Gw = S.act_gram_stats(tgt, w_q2)

            def a_score(s, z):
                return S.score_linear_a_out_gram(
                    x, Mw, Gw, _per_tensor(s), _per_tensor(z), a_bits,
                    mem_scale)[:, None]
        else:
            def a_score(s, z):
                return S.score_linear_a_out(
                    x, tgt, w_q2, _per_tensor(s), _per_tensor(z), a_bits,
                    mem_scale)[:, None]
        a_s, a_z = fpcs(a_score, as0, az0, eq_n=eq_n, steps=st,
                        clamp_min=1e-4)
    return w_s.reshape(V, R, 1), w_z.reshape(V, R, 1), a_s, a_z


def search_linear_default(x, y, w, b, *, w_bits: int, a_bits: int, n_V: int,
                          eq_n: int, steps: int, rounds: int, use_fpcs: bool,
                          gram: bool = False, a_gram: bool = False):
    return _linear_default_impl(x, y, w, b, w_bits=w_bits, a_bits=a_bits,
                                n_V=n_V, eq_n=eq_n, steps=steps, rounds=rounds,
                                use_fpcs=use_fpcs, gram=gram, a_gram=a_gram)


def search_linear_default_batched(xs, ys, ws, bs, *, w_bits: int, a_bits: int,
                                  n_V: int, eq_n: int, steps: int, rounds: int,
                                  use_fpcs: bool, gram: bool = False,
                                  a_gram: bool = False):
    """All L same-shape default Linear sites (every block's proj, say) in
    one search. xs: (L, T, I); ys: (L, T, O); ws: (L, O, I); bs: (L, O).
    Returns stacked (w_scale (L,V,R,1), w_zp, a_scale (L,1), a_zp (L,1))."""
    L = xs.shape[0]

    def one(x, y, w, b):
        return _linear_default_impl(x, y, w, b, w_bits=w_bits, a_bits=a_bits,
                                    n_V=n_V, eq_n=eq_n, steps=steps,
                                    rounds=rounds, use_fpcs=use_fpcs,
                                    gram=gram, a_gram=a_gram, mem_scale=L)

    return _vmap(one, xs, ys, ws, bs)


def _act_channelwise_impl(x, *, a_bits: int, eq_n: int, steps: int,
                          use_fpcs: bool, mem_scale: int = 1):
    as0, az0 = C.act_candidates(x, a_bits, eq_n, channel_wise=True)
    return fpcs(
        lambda s, z: S.score_act_self(x, s[:, None, :], z[:, None, :], a_bits,
                                      channel_wise=True, n_batch=1,
                                      mem_scale=mem_scale),
        as0, az0, eq_n=eq_n, steps=_steps(use_fpcs, steps), clamp_min=1e-4)


def search_act_channelwise(x, *, a_bits: int, eq_n: int, steps: int,
                           use_fpcs: bool):
    """Per-input-channel activation self-search: the pre-reparam stage of a
    channel-wise Linear. Returns (scale (I,), zp (I,))."""
    return _act_channelwise_impl(x, a_bits=a_bits, eq_n=eq_n, steps=steps,
                                 use_fpcs=use_fpcs)


def search_act_channelwise_batched(xs, *, a_bits: int, eq_n: int, steps: int,
                                   use_fpcs: bool):
    """Every same-shape reparam site's channel-wise FPCS in one search (qkv
    and fc1 inputs share (T, d_model)). xs: (L, T, I) -> (scale (L, I),
    zp (L, I))."""
    L = xs.shape[0]

    def one(x):
        return _act_channelwise_impl(x, a_bits=a_bits, eq_n=eq_n, steps=steps,
                                     use_fpcs=use_fpcs, mem_scale=L)

    return _vmap(one, xs)


def _postgelu_adalog_impl(x, y, w, b, shift, *, w_bits: int,
                          a_bits: int, n_V: int, eq_n: int, steps: int,
                          rounds: int, use_fpcs: bool,
                          gram: bool = False, mem_scale: int = 1):
    """The post-GeLU AdaLog fc2 search.

    Weight self-FPCS; the scale starts at the second-to-last percentile
    point; then rounds of [log-base top-8 x 16-scale joint FPCS (width 32),
    then weight output-MSE FPCS]. Returns (w_scale, w_zp, a_scale (1,),
    q (scalar))."""
    O, I = w.shape
    V, R = n_V, O // n_V
    w_v = w.reshape(V, R, I)
    tgt = y - b if b is not None else y
    st = _steps(use_fpcs, steps)
    dev = x.device

    ws0, wz0, exp_w, w_s, w_z = _weight_search(w_v, w_bits, eq_n, st,
                                               mem_scale)
    ud, scale_grid = C.postgelu_scale_candidates(x, shift, eq_n)
    a_s = scale_grid[-2]                                    # (1,)
    q = torch.tensor(37.0, device=dev)
    q_grid = torch.arange(10, 10 + eq_n, dtype=torch.float32, device=dev)
    scale16 = C.interpolate(ud, 16)

    def score(s, qq, ms=mem_scale):
        return S.score_linear_a_out_adalog(x, tgt, w_q2, shift, s, qq, a_bits,
                                           ms)

    for _ in range(rounds):
        w_q2 = _wq(w_v, w_s, w_z, w_bits).reshape(O, I)
        if use_fpcs:
            # stage 1: the top base_num=8 log bases at the current scale
            sims_q = score(a_s.expand(eq_n, 1)[:, :, None],
                           q_grid[:, None, None])
            q_idx = top_k_indices(sims_q, 8)
            # stage 2: joint (scale, q): 16 scales x 8 bases, width-32 FPCS
            joint_s = scale16.repeat(8)[:, None]                  # (128, 1)
            joint_q = torch.repeat_interleave(q_grid[q_idx], 16)[:, None]
            a_s, qv = fpcs(
                lambda s, z: score(_per_tensor(s), _per_tensor(z))[:, None],
                joint_s, joint_q, eq_n=eq_n, steps=st, width=32)
            q = qv[0]
        else:
            # independent base, then scale argmax (no budget split, as the
            # JAX package has it)
            sims_q = score(a_s.expand(eq_n, 1)[:, :, None],
                           q_grid[:, None, None], 1)
            q = q_grid[torch.argmax(sims_q)]
            sims_s = score(scale_grid[:, :, None],
                           q.expand(eq_n, 1)[:, :, None], 1)
            a_s = scale_grid[torch.argmax(sims_s)]
        # weight output-MSE with the AdaLog-quantized input
        x_q = S.adalog_fq_search(x + shift, a_s, q, a_bits) - shift
        w_s, w_z = _w_out_fpcs(x_q, tgt, w_v, ws0, wz0, exp_w, w_bits, eq_n,
                               st, gram, mem_scale)
        a_s = a_s.reshape(1)
    return w_s.reshape(V, R, 1), w_z.reshape(V, R, 1), a_s.reshape(1), q


def search_linear_postgelu_adalog(x, y, w, b, shift, *, w_bits: int,
                                  a_bits: int, n_V: int, eq_n: int, steps: int,
                                  rounds: int, use_fpcs: bool,
                                  gram: bool = False):
    return _postgelu_adalog_impl(x, y, w, b, shift, w_bits=w_bits,
                                 a_bits=a_bits, n_V=n_V, eq_n=eq_n,
                                 steps=steps, rounds=rounds,
                                 use_fpcs=use_fpcs, gram=gram)


def search_linear_postgelu_adalog_batched(xs, ys, ws, bs, shift, *,
                                          w_bits: int, a_bits: int, n_V: int,
                                          eq_n: int, steps: int, rounds: int,
                                          use_fpcs: bool, gram: bool = False):
    """All L same-shape post-GeLU fc2 sites in one search (see
    search_linear_default_batched)."""
    L = xs.shape[0]

    def one(x, y, w, b):
        return _postgelu_adalog_impl(x, y, w, b, shift, w_bits=w_bits,
                                     a_bits=a_bits, n_V=n_V, eq_n=eq_n,
                                     steps=steps, rounds=rounds,
                                     use_fpcs=use_fpcs, gram=gram,
                                     mem_scale=L)

    return _vmap(one, xs, ys, ws, bs)


def _postgelu_twin_impl(x, y, w, b, *, w_bits: int, a_bits: int, n_V: int,
                        eq_n: int, steps: int, rounds: int, use_fpcs: bool,
                        mem_scale: int = 1):
    """The PTQ4ViT twin-uniform fc2 search. The negative scale is fixed at
    GELU_MIN/N; the positive scale is searched over 2^i * neg_scale, i in
    [-5, 24). Returns (w_scale, w_zp, scale_pos (1,), scale_neg (1,))."""
    from adalog_tpu_torch.quantizers.state import GELU_MIN

    O, I = w.shape
    V, R = n_V, O // n_V
    N = 2 ** (a_bits - 1)
    w_v = w.reshape(V, R, I)
    tgt = y - b if b is not None else y
    st = _steps(use_fpcs, steps)
    dev = x.device

    ws0, wz0, exp_w, w_s, w_z = _weight_search(w_v, w_bits, eq_n, st,
                                               mem_scale)
    s_neg = torch.tensor([GELU_MIN / N], dtype=torch.float32, device=dev)
    # |x| max over the tokens (a 0 joins, so that an empty slice has one)
    x_max = dp_max(torch.cat([torch.abs(x).reshape(-1), x.new_zeros(1)]
                             ).max(), dp_mesh())
    s_pos = tdiv(x_max.reshape(1), N - 0.5)
    # 29 evaluated candidates, 2^-5..2^23 times s_neg (exact powers of two)
    pos_grid = (torch.tensor([2.0 ** i for i in range(-5, 24)],
                             dtype=torch.float32, device=dev) * s_neg)[:, None]
    for _ in range(rounds):
        w_q2 = _wq(w_v, w_s, w_z, w_bits).reshape(O, I)
        sims = S.score_linear_a_out_twin(x, tgt, w_q2, pos_grid[:, :, None],
                                         s_neg, a_bits, mem_scale)
        s_pos = pos_grid[torch.argmax(sims)]
        x_pos = torch.clamp(torch.round(x / s_pos), 0, N - 1) * s_pos
        x_neg = torch.clamp(torch.round(x / s_neg), -N, 0) * s_neg
        w_s, w_z = _w_out_fpcs(x_pos + x_neg, tgt, w_v, ws0, wz0, exp_w,
                               w_bits, eq_n, st, False, mem_scale)
    return w_s.reshape(V, R, 1), w_z.reshape(V, R, 1), s_pos, s_neg


def search_linear_postgelu_twin(x, y, w, b, *, w_bits: int, a_bits: int,
                                n_V: int, eq_n: int, steps: int, rounds: int,
                                use_fpcs: bool):
    return _postgelu_twin_impl(x, y, w, b, w_bits=w_bits, a_bits=a_bits,
                               n_V=n_V, eq_n=eq_n, steps=steps, rounds=rounds,
                               use_fpcs=use_fpcs)


def search_linear_postgelu_twin_batched(xs, ys, ws, bs, *, w_bits: int,
                                        a_bits: int, n_V: int, eq_n: int,
                                        steps: int, rounds: int,
                                        use_fpcs: bool):
    """All L same-shape twin fc2 sites (post_gelu_quantizer='ptq4vit') in
    one search (see search_linear_default_batched)."""
    L = xs.shape[0]

    def one(x, y, w, b):
        return _postgelu_twin_impl(x, y, w, b, w_bits=w_bits, a_bits=a_bits,
                                   n_V=n_V, eq_n=eq_n, steps=steps,
                                   rounds=rounds, use_fpcs=use_fpcs,
                                   mem_scale=L)

    return _vmap(one, xs, ys, ws, bs)


# ---------------------------------------------------------------------------
# MatMul family
# ---------------------------------------------------------------------------

def _mm_expand(s2d, z2d, H, head_cw):
    """(E, U) -> (E, 1, H|1, 1, 1), broadcast per candidate against an
    (N, H, S, C) operand."""
    U = H if head_cw else 1
    return s2d.reshape(-1, 1, U, 1, 1), z2d.reshape(-1, 1, U, 1, 1)


def _matmul_impl(A, B, y, *, A_bits: int, B_bits: int, eq_n: int, steps: int,
                 rounds: int, use_fpcs: bool, head_cw: bool,
                 gram: bool = False, mem_scale: int = 1):
    """The q@kT matmul search. A: (N, H, S, C); B: (N, H, C, S2); y:
    (N, H, S, S2) the raw product. Both operands start at the second-to-last
    percentile candidate, then ``rounds`` of alternating A/B output-MSE
    FPCS. With ``gram`` an operand is scored in the Gram form where the
    contraction C is smaller than the dropped output dim."""
    H = A.shape[1]
    s_dim, c_dim, s2_dim = A.shape[2], A.shape[3], B.shape[3]
    U = H if head_cw else 1
    a_gram = gram and s2_dim > c_dim
    b_gram = gram and s_dim > c_dim

    As0, Az0 = C.matmul_candidates(A, B_bits, eq_n, head_channel_wise=head_cw)
    Bs0, Bz0 = C.matmul_candidates(B, B_bits, eq_n, head_channel_wise=head_cw)
    A_s, A_z = As0[-2], Az0[-2]
    B_s, B_z = Bs0[-2], Bz0[-2]
    st = _steps(use_fpcs, steps)

    def nat(u):
        return u.reshape(1, U, 1, 1)

    for _ in range(rounds):
        B_q = S.uq_asym(B, nat(B_s), nat(B_z), B_bits)
        if a_gram:
            G_B, M = S.matmul_gram_stats_opA(B_q, y)

            def a_score(s, z):
                return S.score_matmul_opA_gram(
                    A, G_B, M, s2_dim, *_mm_expand(s, z, H, head_cw), A_bits,
                    head_channel_wise=head_cw, mem_scale=mem_scale
                ).reshape(eq_n, U)
        else:
            def a_score(s, z):
                return S.score_matmul_opA(
                    A, B_q, y, *_mm_expand(s, z, H, head_cw), A_bits,
                    head_channel_wise=head_cw, mem_scale=mem_scale
                ).reshape(eq_n, U)
        A_s, A_z = fpcs(a_score, As0, Az0, eq_n=eq_n, steps=st)
        A_q = S.uq_asym(A, nat(A_s), nat(A_z), A_bits)
        if b_gram:
            G_A, M2 = S.matmul_gram_stats_opB(A_q, y)

            def b_score(s, z):
                return S.score_matmul_opB_gram(
                    B, G_A, M2, s_dim, *_mm_expand(s, z, H, head_cw), B_bits,
                    head_channel_wise=head_cw, mem_scale=mem_scale
                ).reshape(eq_n, U)
        else:
            def b_score(s, z):
                return S.score_matmul_opB(
                    A_q, B, y, *_mm_expand(s, z, H, head_cw), B_bits,
                    head_channel_wise=head_cw, mem_scale=mem_scale
                ).reshape(eq_n, U)
        B_s, B_z = fpcs(b_score, Bs0, Bz0, eq_n=eq_n, steps=st)
    return nat(A_s), nat(A_z), nat(B_s), nat(B_z)


def search_matmul(A, B, y, *, A_bits: int, B_bits: int, eq_n: int, steps: int,
                  rounds: int, use_fpcs: bool, head_cw: bool,
                  gram: bool = False):
    return _matmul_impl(A, B, y, A_bits=A_bits, B_bits=B_bits, eq_n=eq_n,
                        steps=steps, rounds=rounds, use_fpcs=use_fpcs,
                        head_cw=head_cw, gram=gram)


def search_matmul_batched(As, Bs, ys, *, A_bits: int, B_bits: int, eq_n: int,
                          steps: int, rounds: int, use_fpcs: bool,
                          head_cw: bool, gram: bool = False):
    """All L same-shape q@kT sites in one search."""
    L = As.shape[0]

    def one(A, B, y):
        return _matmul_impl(A, B, y, A_bits=A_bits, B_bits=B_bits, eq_n=eq_n,
                            steps=steps, rounds=rounds, use_fpcs=use_fpcs,
                            head_cw=head_cw, gram=gram, mem_scale=L)

    return _vmap(one, As, Bs, ys)


def _matmul_postsoftmax_impl(A, B, y, *, A_bits: int, B_bits: int, eq_n: int,
                             steps: int, rounds: int, use_fpcs: bool,
                             head_cw: bool, a_kind: str, mem_scale: int = 1):
    """The softmax@v matmul search. A (post-softmax) gets a log quantizer
    (``a_kind``) with the scale frozen at 1; for AdaLog the integer base q
    is argmax-searched each round, alternating with B-scale FPCS; log2 and
    logsqrt2 run a single B round. Returns (q (scalar), B_scale, B_zp)."""
    from adalog_tpu_torch.quantizers.logarithm import (
        log2_quant, logsqrt2_quant,
    )

    H = A.shape[1]
    U = H if head_cw else 1
    dev = A.device
    Bs0, Bz0 = C.matmul_candidates(B, B_bits, eq_n, head_channel_wise=head_cw)
    B_s, B_z = Bs0[-2], Bz0[-2]
    q = torch.tensor(37.0, device=dev)
    q_grid = torch.arange(10, 10 + eq_n, dtype=torch.float32, device=dev)
    st = _steps(use_fpcs, steps)

    def nat(u):
        return u.reshape(1, U, 1, 1)

    def b_fpcs(A_q):
        return fpcs(
            lambda s, z: S.score_matmul_opB(
                A_q, B, y, *_mm_expand(s, z, H, head_cw), B_bits,
                head_channel_wise=head_cw, mem_scale=mem_scale
            ).reshape(eq_n, U),
            Bs0, Bz0, eq_n=eq_n, steps=st)

    if a_kind == "adalog":
        for _ in range(rounds):
            B_q = S.uq_asym(B, nat(B_s), nat(B_z), B_bits)
            sims = S.score_postsoftmax_base(A, B_q, y, q_grid, A_bits,
                                            mem_scale=mem_scale)
            q = q_grid[torch.argmax(sims)]
            A_q = S.adalog_fq_search(A, None, q, A_bits, clamp_upper=False)
            B_s, B_z = b_fpcs(A_q)
    else:
        one = torch.ones((), dtype=torch.float32, device=dev)
        A_q = (log2_quant if a_kind == "log2" else logsqrt2_quant)(
            A, one, bits=A_bits)
        B_s, B_z = b_fpcs(A_q)
    return q, nat(B_s), nat(B_z)


def search_matmul_postsoftmax(A, B, y, *, A_bits: int, B_bits: int, eq_n: int,
                              steps: int, rounds: int, use_fpcs: bool,
                              head_cw: bool, a_kind: str):
    return _matmul_postsoftmax_impl(A, B, y, A_bits=A_bits, B_bits=B_bits,
                                    eq_n=eq_n, steps=steps, rounds=rounds,
                                    use_fpcs=use_fpcs, head_cw=head_cw,
                                    a_kind=a_kind)


def search_matmul_postsoftmax_batched(As, Bs, ys, *, A_bits: int, B_bits: int,
                                      eq_n: int, steps: int, rounds: int,
                                      use_fpcs: bool, head_cw: bool,
                                      a_kind: str):
    """All L same-shape post-softmax sites in one search."""
    L = As.shape[0]

    def one(A, B, y):
        return _matmul_postsoftmax_impl(A, B, y, A_bits=A_bits, B_bits=B_bits,
                                        eq_n=eq_n, steps=steps, rounds=rounds,
                                        use_fpcs=use_fpcs, head_cw=head_cw,
                                        a_kind=a_kind, mem_scale=L)

    return _vmap(one, As, Bs, ys)


# ---------------------------------------------------------------------------
# Conv family
# ---------------------------------------------------------------------------

def _conv_impl(x, y, w, b, *, w_bits: int, eq_n: int, steps: int,
               use_fpcs: bool, conv_dims, mem_scale: int = 1):
    """The patch-embed conv search: weight only (activations are 8-bit
    pass-through), one output-MSE FPCS round with per-out-channel
    candidates (num_zp = n_levels).

    x: (N, H, W, IC) NHWC; y: (N, FH, FW, OC); w: (OC, IC, KH, KW); b: (OC,).
    Returns (w_scale (OC, 1), w_zp (OC, 1))."""
    OC = w.shape[0]
    w_flat = w.reshape(OC, -1)
    tgt = y - b if b is not None else y
    N_lv = 2 ** (w_bits - 1)
    num_zp = min(N_lv, eq_n)       # clamped so the scale grid is never empty
    num_scale = eq_n // num_zp

    pct = C._pct(0.9, 1.0, w.device)
    uppers, lowers = C._upper_lower(w_flat, pct, dim=-1)
    ws0, wz0, delta = C._grid((uppers[0] - lowers[0])[None, :],
                              (uppers[1] - lowers[1])[None, :], w_bits,
                              num_zp, num_scale, self_delta=True)
    w_s, w_z = fpcs(
        lambda s, z: S.score_conv_w_out(
            x, tgt, w_flat, conv_dims, s[:, :, None], z[:, :, None], w_bits,
            mem_scale),
        ws0, wz0, eq_n=eq_n, steps=_steps(use_fpcs, steps), delta=delta)
    return w_s[:, None], w_z[:, None]


def search_conv(x, y, w, b, *, w_bits: int, eq_n: int, steps: int,
                use_fpcs: bool, conv_dims):
    return _conv_impl(x, y, w, b, w_bits=w_bits, eq_n=eq_n, steps=steps,
                      use_fpcs=use_fpcs, conv_dims=conv_dims)


def search_conv_batched(xs, ys, ws, bs, *, w_bits: int, eq_n: int, steps: int,
                        use_fpcs: bool, conv_dims):
    """All L same-shape conv sites in one search. Every zoo model has one
    conv (the patch embed), so there the group is a single site."""
    L = xs.shape[0]

    def one(x, y, w, b):
        return _conv_impl(x, y, w, b, w_bits=w_bits, eq_n=eq_n, steps=steps,
                          use_fpcs=use_fpcs, conv_dims=conv_dims,
                          mem_scale=L)

    return _vmap(one, xs, ys, ws, bs)
