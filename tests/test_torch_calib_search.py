"""The port's calibration search core (calib/candidates.py, ops/scoring.py,
calib/search.py) against adalog_tpu on the CPU.

The same numpy inputs go through the JAX function and the port's. Gates:
  - quantiles, the candidate grids' zero points and linspace: bit for bit;
  - AdaLog codes bit for bit; dequantized values to VALUE_RTOL (XLA's CPU
    exp2 is inexact at negative integers, the port's 2^-k is exact);
  - scores to SCORE_RTOL of the largest |score| (fp32 sums in another
    order);
  - integer picks (zero points, AdaLog bases) exact or adjacent, with the
    adjacent share reported; scales to SCALE_RTOL (the JAX programs are
    jitted, and XLA turns a division by a constant into a multiply by its
    reciprocal, the port divides);
  - fpcs keeps jax.lax.top_k's order among tied scores.
Sizes follow tests/test_search_oracle*.py and test_batched_sites.py.
"""

import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adalog_tpu.calib import candidates as JC
from adalog_tpu.calib import search as JS
from adalog_tpu.ops import scoring as JSC
from adalog_tpu.quantizers.state import GELU_MIN
from adalog_tpu_torch.calib import candidates as TC
from adalog_tpu_torch.calib import search as TS
from adalog_tpu_torch.ops import scoring as TSC

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
SCORE_RTOL = 1e-5
SCALE_RTOL = 1e-5
# measured: every pick of these cases lands on JAX's own (0 adjacent)
ADJACENT_SHARE_MAX = 0.1
# far below any value a search meets: XLA's CPU code flushes results near
# the smallest normal float32 to 0, the port keeps them
TINY = 1e-37


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(a):
    return np.asarray(a)


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# quantile, linspace, candidates
# ---------------------------------------------------------------------------

def _jnp_quantile(x, q, axis=None):
    """jnp.quantile as the JAX package's searches call it: inside jit, the
    percentiles constants of the program."""
    q = np.asarray(q)
    return _np(jax.jit(lambda a: jnp.quantile(a, jnp.asarray(q), axis=axis))(
        jnp.asarray(x)))


@pytest.mark.parametrize("shape,axis", [
    ((1000,), None), ((40,), 0), ((7, 33), -1), ((64, 5), 0),
    ((3, 4, 101), -1), ((20, 50), 1), ((16, 300), None)])
def test_quantile_bit_for_bit(shape, axis):
    x = _rng(1).standard_normal(shape).astype(np.float32)
    for q in (jnp.asarray([0.9, 1.0], jnp.float32),
              1.0 - jnp.asarray([0.9, 1.0], jnp.float32),
              jnp.asarray([0.5, 0.25, 0.001], jnp.float32)):
        want = _jnp_quantile(x, q, axis)
        got = TC.quantile(_t(x), torch.from_numpy(np.array(q)),
                          dim=axis).numpy()
        np.testing.assert_array_equal(got, want)


def test_quantile_past_2_pow_24_elements():
    """torch.quantile refuses this size; float32 index arithmetic rounds
    (n - 1) and the last index up past the end, which XLA's gather clamps.
    A sorted input with a few swaps keeps both sorts quick."""
    n = 2 ** 24 + 1001
    x = np.sort(_rng(2).standard_normal(n).astype(np.float32))
    x[[5, n - 3]] = x[[n - 3, 5]]
    q = jnp.asarray([0.9, 1.0, 0.1, 0.0, 0.5], jnp.float32)
    want = _jnp_quantile(x, q)
    got = TC.quantile(_t(x), torch.from_numpy(np.array(q))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 3, 4, 8, 16])
def test_linspace_bit_for_bit(n):
    np.testing.assert_array_equal(TC._linspace01(n, "cpu").numpy(),
                                  _np(jnp.linspace(0.0, 1.0, n)))


def _cands_close(got, want):
    (gs, gz), (ws, wz) = got, want
    assert gs.shape == ws.shape and gz.shape == wz.shape
    np.testing.assert_array_equal(gz.numpy(), _np(wz))
    np.testing.assert_allclose(gs.numpy(), _np(ws), rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("bits,eq_n", [(4, 32), (4, 128), (6, 64)])
def test_weight_candidates(bits, eq_n):
    w = (0.1 * _rng(3).standard_normal((3, 8, 24))).astype(np.float32)
    _cands_close(TC.weight_candidates(_t(w), bits, eq_n),
                 JC.weight_candidates(jnp.asarray(w), bits, eq_n))


@pytest.mark.parametrize("kind", ["weight", "act", "act_cw", "matmul"])
def test_candidates_within_two_ulps_of_jitted_jax(kind):
    """The JAX package's searches run jitted, where XLA forms the grid with
    a fused multiply-add and a multiply by the reciprocal of 2N - 1; the
    port's grids equal the eager arithmetic, so they stay within two float32
    ulps of the jitted ones (one a rounding), zero points equal. Prints the
    share of scales apart (FPCS can turn such an ulp into another pick at a
    near-tie: ROADMAP.md C.6)."""
    rng = _rng(8)
    if kind == "weight":
        a = (0.05 * rng.standard_normal((3, 40, 64))).astype(np.float32)
        got = TC.weight_candidates(_t(a), 4, 128)
        want = jax.jit(lambda v: JC.weight_candidates(v, 4, 128))(
            jnp.asarray(a))
    elif kind == "matmul":
        a = rng.standard_normal((2, 4, 50, 16)).astype(np.float32)
        got = TC.matmul_candidates(_t(a), 4, 128, head_channel_wise=True)
        want = jax.jit(lambda v: JC.matmul_candidates(
            v, 4, 128, head_channel_wise=True))(jnp.asarray(a))
    else:
        a = rng.standard_normal((300, 64)).astype(np.float32)
        got = TC.act_candidates(_t(a), 4, 128, channel_wise=kind == "act_cw")
        want = jax.jit(lambda v: JC.act_candidates(
            v, 4, 128, channel_wise=kind == "act_cw"))(jnp.asarray(a))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    ulps = np.abs(got[0].numpy().view(np.int32).astype(np.int64)
                  - _np(want[0]).view(np.int32).astype(np.int64))
    print(f"{kind}: {np.mean(ulps != 0):.3f} of {ulps.size} scales 1-2 ulps "
          "from the jitted grid")
    assert ulps.max() <= 2


@pytest.mark.parametrize("channel_wise", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_act_candidates(channel_wise, bits):
    x = _rng(4).standard_normal((96, 12)).astype(np.float32)
    x[:, 3] *= 1e-5            # a flat channel: its scales clip at 1e-4
    _cands_close(
        TC.act_candidates(_t(x), bits, 32, channel_wise=channel_wise),
        JC.act_candidates(jnp.asarray(x), bits, 32,
                          channel_wise=channel_wise))


@pytest.mark.parametrize("hcw", [False, True])
def test_matmul_candidates(hcw):
    op = _rng(5).standard_normal((2, 3, 10, 8)).astype(np.float32)
    _cands_close(
        TC.matmul_candidates(_t(op), 4, 32, head_channel_wise=hcw),
        JC.matmul_candidates(jnp.asarray(op), 4, 32, head_channel_wise=hcw))


@pytest.mark.parametrize("case", ["mixed", "none_positive", "one_positive"])
def test_positive_percentile_and_postgelu_grid(case):
    x = _rng(6).standard_normal(500).astype(np.float32)
    if case == "none_positive":
        x = -np.abs(x)
    elif case == "one_positive":
        x = -np.abs(x)
        x[17] = 0.5
    qs = np.array([0.9, 1.0], np.float32)
    np.testing.assert_array_equal(
        TC.positive_percentile(_t(x), _t(qs)).numpy(),
        _np(JC.positive_percentile(jnp.asarray(x), jnp.asarray(qs))))
    ud_t, s_t = TC.postgelu_scale_candidates(_t(x).reshape(50, 10),
                                             GELU_MIN, 32)
    ud_j, s_j = JC.postgelu_scale_candidates(
        jnp.asarray(x).reshape(50, 10), jnp.float32(GELU_MIN), 32)
    np.testing.assert_array_equal(ud_t.numpy(), _np(ud_j))
    np.testing.assert_allclose(s_t.numpy(), _np(s_j), rtol=SCALE_RTOL)


# ---------------------------------------------------------------------------
# quantizers of the search path
# ---------------------------------------------------------------------------

def test_uq_asym_bit_for_bit():
    rng = _rng(7)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    s = rng.uniform(0.01, 0.3, (5, 1, 16)).astype(np.float32)
    z = rng.integers(0, 16, (5, 1, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        TSC.uq_asym(_t(x), _t(s), _t(z), 4).numpy(),
        _np(JSC.uq_asym(jnp.asarray(x), jnp.asarray(s), jnp.asarray(z), 4)))


def _code_of(v, qs, bits):
    """The code whose exact (float64) AdaLog value lies nearest v, per base
    of qs; -1 below TINY."""
    N = 2 ** (bits - 1)
    c = np.arange(2 * N, dtype=np.float64)[None, :]
    prod = c * qs.astype(np.float64)[:, None]
    ts = 1.0 / (4 * N - 2)
    table = np.exp2(-np.floor(prod / 37.0)) * np.round(
        np.exp2(-np.round(np.mod(prod, 37.0)) / 37.0) / ts) * ts
    d = np.abs(v.astype(np.float64)[..., None] - table[:, None, :])
    return np.where(v >= TINY, np.argmin(d, axis=-1), -1)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("clamp_upper", [True, False])
def test_adalog_fq_search_every_code_and_base(bits, clamp_upper):
    """Every code of every base in the search grid 10..137, with inputs at
    the code centres (2^(-code * q / 37)), between them, at 0 and past the
    clamp. Values to VALUE_RTOL; the codes they decode to, bit for bit."""
    qs = np.arange(10, 138, dtype=np.float32)
    codes = np.arange(2 ** bits, dtype=np.float32)
    centre = np.exp2(-codes[None, :] * qs[:, None] / 37.0)
    x = np.concatenate([centre, 0.93 * centre, np.zeros((128, 2)),
                        np.full((128, 1), 1.7)], axis=1).astype(np.float32)
    q = qs[:, None]
    got = TSC.adalog_fq_search(
        _t(x), torch.tensor(1.0) if clamp_upper else None, _t(q), bits,
        clamp_upper).numpy()
    want = _np(JSC.adalog_fq_search(jnp.asarray(x), 1.0, jnp.asarray(q), bits,
                                    clamp_upper))
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL, atol=TINY)
    np.testing.assert_array_equal(_code_of(got, qs, bits),
                                  _code_of(want, qs, bits))
    assert (got > 0).mean() > 0.25      # most codes are reached


def test_adalog_mantissa_table_is_the_quantizer_mantissa():
    from adalog_tpu_torch.quantizers.logarithm import adalog_mantissa

    for bits in (4, 6, 8):
        j = torch.arange(37, dtype=torch.float32)
        assert torch.equal(TSC._mantissa_table(bits, torch.device("cpu")),
                           adalog_mantissa(j, bits))


# ---------------------------------------------------------------------------
# scorers, direct and Gram
# ---------------------------------------------------------------------------

def _close_scores(got, want):
    want = _np(want)
    assert got.shape == want.shape
    tol = SCORE_RTOL * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def linear_case():
    rng = _rng(8)
    T, I, O, V = 64, 16, 48, 3
    x = rng.standard_normal((T, I)).astype(np.float32)
    w = (0.3 * rng.standard_normal((O, I))).astype(np.float32)
    tgt = (x @ w.T).astype(np.float32)
    w_v = w.reshape(V, O // V, I)
    ws0, wz0 = JC.weight_candidates(jnp.asarray(w_v), 4, 32)
    s4 = _np(ws0).reshape(32, V, O // V, 1)
    z4 = _np(wz0).reshape(32, V, O // V, 1)
    as0, az0 = JC.act_candidates(jnp.asarray(x), 4, 32, channel_wise=False)
    return dict(x=x, w=w, tgt=tgt, w_v=w_v, s4=s4, z4=z4,
                a_s=_np(as0), a_z=_np(az0))


@pytest.fixture(params=["float32", "bfloat16"])
def score_dtype(request):
    JSC.set_score_dtype(request.param)
    TSC.set_score_dtype(request.param)
    yield request.param
    JSC.set_score_dtype("float32")
    TSC.set_score_dtype("float32")


def test_score_weight_self(linear_case):
    c = linear_case
    _close_scores(
        TSC.score_weight_self(_t(c["w_v"]), _t(c["s4"]), _t(c["z4"]), 4),
        JSC.score_weight_self(*map(jnp.asarray, (c["w_v"], c["s4"],
                                                 c["z4"])), 4))


@pytest.mark.parametrize("channel_wise", [False, True])
def test_score_act_self(linear_case, channel_wise):
    x = linear_case["x"]
    s, z = JC.act_candidates(jnp.asarray(x), 4, 32,
                             channel_wise=channel_wise)
    s, z = _np(s)[:, None, :], _np(z)[:, None, :]
    js, jz = (s, z) if channel_wise else (s[:, 0], z[:, 0])
    got = TSC.score_act_self(_t(x), _t(s), _t(z), 4,
                             channel_wise=channel_wise, n_batch=2)
    want = JSC.score_act_self(jnp.asarray(x), jnp.asarray(js),
                              jnp.asarray(jz), 4, channel_wise=channel_wise,
                              n_batch=2)
    _close_scores(got, want)


def test_score_linear_w_out_direct_and_gram(linear_case, score_dtype):
    c = linear_case
    x_q = _np(JSC.uq_asym(jnp.asarray(c["x"]), c["a_s"][-2], c["a_z"][-2],
                          4))
    direct = TSC.score_linear_w_out(_t(x_q), _t(c["tgt"]), _t(c["w_v"]),
                                    _t(c["s4"]), _t(c["z4"]), 4)
    _close_scores(direct, JSC.score_linear_w_out(
        *map(jnp.asarray, (x_q, c["tgt"], c["w_v"], c["s4"], c["z4"])), 4))
    G, Cm = TSC.gram_stats(_t(x_q), _t(c["tgt"]))
    jG, jCm = JSC.gram_stats(jnp.asarray(x_q), jnp.asarray(c["tgt"]))
    _close_scores(G, jG)
    _close_scores(Cm, jCm)
    gram = TSC.score_linear_w_out_gram(G, Cm, _t(c["w_v"]), _t(c["s4"]),
                                       _t(c["z4"]), 4)
    _close_scores(gram, JSC.score_linear_w_out_gram(
        jG, jCm, *map(jnp.asarray, (c["w_v"], c["s4"], c["z4"])), 4))
    # the Gram form ranks as the direct one does (with bf16 operands the
    # direct form's rounding breaks near-ties its own way)
    if score_dtype == "float32":
        np.testing.assert_array_equal(torch.argmax(gram, 0).numpy(),
                                      torch.argmax(direct, 0).numpy())


def test_score_linear_a_out_direct_and_gram(linear_case, score_dtype):
    c = linear_case
    s, z = c["a_s"], c["a_z"]
    direct = TSC.score_linear_a_out(_t(c["x"]), _t(c["tgt"]), _t(c["w"]),
                                    _t(s)[:, :, None], _t(z)[:, :, None], 4)
    _close_scores(direct, JSC.score_linear_a_out(
        *map(jnp.asarray, (c["x"], c["tgt"], c["w"], s, z)), 4))
    Mw, Gw = TSC.act_gram_stats(_t(c["tgt"]), _t(c["w"]))
    jMw, jGw = JSC.act_gram_stats(jnp.asarray(c["tgt"]), jnp.asarray(c["w"]))
    gram = TSC.score_linear_a_out_gram(_t(c["x"]), Mw, Gw, _t(s)[:, :, None],
                                       _t(z)[:, :, None], 4)
    _close_scores(gram, JSC.score_linear_a_out_gram(
        jnp.asarray(c["x"]), jMw, jGw, jnp.asarray(s), jnp.asarray(z), 4))


def test_score_linear_a_out_twin_and_adalog(linear_case, score_dtype):
    c = linear_case
    xg = _np(jax.nn.gelu(jnp.asarray(c["x"]), approximate=False))
    tgt = (xg @ c["w"].T).astype(np.float32)
    s_neg = np.array([GELU_MIN / 8], np.float32)
    pos = (np.exp2(np.arange(-5, 24)) * s_neg)[:, None].astype(np.float32)
    _close_scores(
        TSC.score_linear_a_out_twin(_t(xg), _t(tgt), _t(c["w"]),
                                    _t(pos)[:, :, None], _t(s_neg), 4),
        JSC.score_linear_a_out_twin(*map(jnp.asarray, (xg, tgt, c["w"], pos,
                                                       s_neg)), 4))
    scales = np.linspace(0.5, 3.0, 32, dtype=np.float32)[:, None]
    qs = np.arange(10, 42, dtype=np.float32)[:, None]
    _close_scores(
        TSC.score_linear_a_out_adalog(_t(xg), _t(tgt), _t(c["w"]), GELU_MIN,
                                      _t(scales)[:, :, None],
                                      _t(qs)[:, :, None], 4),
        JSC.score_linear_a_out_adalog(
            *map(jnp.asarray, (xg, tgt, c["w"])), jnp.float32(GELU_MIN),
            jnp.asarray(scales), jnp.asarray(qs), 4))


@pytest.fixture(scope="module")
def matmul_case():
    rng = _rng(9)
    A = rng.standard_normal((2, 3, 12, 8)).astype(np.float32)
    B = rng.standard_normal((2, 3, 8, 20)).astype(np.float32)
    return dict(A=A, B=B, y=(A @ B).astype(np.float32))


@pytest.mark.parametrize("hcw", [False, True])
def test_score_matmul_direct_and_gram(matmul_case, hcw, score_dtype):
    A, B, y = matmul_case["A"], matmul_case["B"], matmul_case["y"]
    H = A.shape[1]
    s, z = JC.matmul_candidates(jnp.asarray(A), 4, 32, head_channel_wise=hcw)
    U = H if hcw else 1
    s5, z5 = (_np(a).reshape(32, 1, U, 1, 1) for a in (s, z))
    Bq = _np(JSC.uq_asym(jnp.asarray(B), 0.2, 8.0, 4))
    Aq = _np(JSC.uq_asym(jnp.asarray(A), 0.2, 8.0, 4))
    for got, want in (
            (TSC.score_matmul_opA(_t(A), _t(Bq), _t(y), _t(s5), _t(z5), 4,
                                  hcw),
             JSC.score_matmul_opA(*map(jnp.asarray, (A, Bq, y, s5, z5)), 4,
                                  hcw)),
            (TSC.score_matmul_opB(_t(Aq), _t(B), _t(y), _t(s5), _t(z5), 4,
                                  hcw),
             JSC.score_matmul_opB(*map(jnp.asarray, (Aq, B, y, s5, z5)), 4,
                                  hcw))):
        _close_scores(got, want)
    G_B, M = TSC.matmul_gram_stats_opA(_t(Bq), _t(y))
    jG_B, jM = JSC.matmul_gram_stats_opA(jnp.asarray(Bq), jnp.asarray(y))
    _close_scores(TSC.score_matmul_opA_gram(_t(A), G_B, M, 20, _t(s5),
                                            _t(z5), 4, hcw),
                  JSC.score_matmul_opA_gram(jnp.asarray(A), jG_B, jM, 20,
                                            jnp.asarray(s5), jnp.asarray(z5),
                                            4, hcw))
    G_A, M2 = TSC.matmul_gram_stats_opB(_t(Aq), _t(y))
    jG_A, jM2 = JSC.matmul_gram_stats_opB(jnp.asarray(Aq), jnp.asarray(y))
    _close_scores(TSC.score_matmul_opB_gram(_t(B), G_A, M2, 12, _t(s5),
                                            _t(z5), 4, hcw),
                  JSC.score_matmul_opB_gram(jnp.asarray(B), jG_A, jM2, 12,
                                            jnp.asarray(s5), jnp.asarray(z5),
                                            4, hcw))


def test_score_postsoftmax_base(matmul_case, score_dtype):
    rng = _rng(10)
    P = _np(jax.nn.softmax(jnp.asarray(
        2 * rng.standard_normal((2, 3, 12, 12)).astype(np.float32)), -1))
    V = matmul_case["A"]
    y = (P @ V).astype(np.float32)
    Vq = _np(JSC.uq_asym(jnp.asarray(V), 0.2, 8.0, 4))
    qs = np.arange(10, 42, dtype=np.float32)
    _close_scores(TSC.score_postsoftmax_base(_t(P), _t(Vq), _t(y), _t(qs), 4),
                  JSC.score_postsoftmax_base(*map(jnp.asarray,
                                                  (P, Vq, y, qs)), 4))


@pytest.mark.parametrize("conv_dims", [(4, 4, 4, 0), (4, 4, 2, 1)])
def test_score_conv_w_out(conv_dims):
    rng = _rng(11)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    w = (0.2 * rng.standard_normal((8, 3, 4, 4))).astype(np.float32)
    kh, kw, stride, pad = conv_dims
    y = torch.nn.functional.conv2d(
        _t(x).permute(0, 3, 1, 2), _t(w), stride=stride,
        padding=pad).permute(0, 2, 3, 1).numpy()
    w_flat = w.reshape(8, -1)
    s, z = JC.weight_candidates(jnp.asarray(w_flat)[None], 4, 32)
    s3, z3 = (_np(a).reshape(32, 8, 1) for a in (s, z))
    _close_scores(
        TSC.score_conv_w_out(_t(x), _t(y), _t(w_flat), conv_dims, _t(s3),
                             _t(z3), 4),
        JSC.score_conv_w_out(*map(jnp.asarray, (x, y, w_flat)), conv_dims,
                             jnp.asarray(s3), jnp.asarray(z3), 4))


def test_chunked_map_equals_one_chunk(linear_case, monkeypatch):
    """A budget that forces several chunks gives the one-chunk scores."""
    c = linear_case
    args = (_t(c["x"]), _t(c["tgt"]), _t(c["w"]),
            _t(c["a_s"])[:, :, None], _t(c["a_z"])[:, :, None], 4)
    whole = TSC.score_linear_a_out(*args)
    monkeypatch.setattr(TSC, "SCORE_BUDGET_BYTES", 5 * 64 * (16 + 48) * 4)
    assert TSC._chunk_size(32, 64 * (16 + 48) * 4) == 4
    np.testing.assert_allclose(TSC.score_linear_a_out(*args).numpy(),
                               whole.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# fpcs
# ---------------------------------------------------------------------------

def _fpcs_both(score, scales, zps, **kw):
    """fpcs of both packages on score(xp, s, z), xp the array module."""
    j = JS.fpcs(lambda s, z: score(jnp, s, z), jnp.asarray(scales),
                jnp.asarray(zps), **kw)
    t = TS.fpcs(lambda s, z: score(torch, s, z), _t(scales), _t(zps), **kw)
    return [_np(a) for a in j], [a.numpy() for a in t]


def test_fpcs_exact_ties_keep_lower_index():
    """Scores tied in blocks (as the 1e-4 clip of act_candidates makes
    them): the port keeps jax.lax.top_k's order, lower index first, at
    every step and for the final pick."""
    eq_n, U = 64, 3
    scales = np.repeat(np.linspace(0.1, 1.0, eq_n // 8, dtype=np.float32),
                       8)[:, None].repeat(U, 1)
    zps = np.tile(np.arange(eq_n, dtype=np.float32)[:, None], (1, U))
    target = np.array([0.3, 0.5, 0.7], np.float32)

    def score(xp, s, z):             # coarse, so that many scores tie
        return -xp.round(xp.abs(s - xp.asarray(target)[None]) * 4) / 4

    for steps in (1, 2, 4):
        (js, jz), (ts, tz) = _fpcs_both(score, scales, zps, eq_n=eq_n,
                                        steps=steps)
        np.testing.assert_array_equal(tz, jz)
        np.testing.assert_allclose(ts, js, rtol=SCALE_RTOL)
    idx = TS.top_k_indices(torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0]), 3)
    assert idx.tolist() == [1, 2, 4]


def test_fpcs_degenerate_warning(caplog):
    eq_n, U = 32, 3
    scales = np.linspace(0.1, 1.0, eq_n, dtype=np.float32)[:, None] * \
        np.ones((1, U), np.float32)
    zps = np.zeros((eq_n, U), np.float32)
    target = np.array([0.3, 0.5, 0.7], np.float32)

    def score(xp, s, z):
        return -(s - xp.asarray(target)[None]) ** 2

    with caplog.at_level(logging.WARNING, logger="adalog_tpu_torch"):
        (js, _), (ts, _) = _fpcs_both(score, scales, zps, eq_n=eq_n, steps=2,
                                      width=32)
    assert any("diverging scale walk" in r.message for r in caplog.records)
    np.testing.assert_allclose(ts, js, rtol=SCALE_RTOL)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="adalog_tpu_torch"):
        _fpcs_both(score, scales, zps, eq_n=eq_n, steps=2, width=16)
        _fpcs_both(score, scales, zps, eq_n=eq_n, steps=1, width=32)
    assert not [r for r in caplog.records
                if "diverging scale walk" in r.message]


# ---------------------------------------------------------------------------
# the seven families, single-site and batched
# ---------------------------------------------------------------------------

ADJACENT = {"picks": 0, "adjacent": 0}


def _pick_close(got, want, grid_step=1.0):
    """Integer picks: equal, or one grid step apart (counted)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    assert np.all((d == 0) | (np.abs(d - grid_step) < 1e-6)), (got, want)
    ADJACENT["picks"] += d.size
    ADJACENT["adjacent"] += int((d != 0).sum())


def _scale_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=SCALE_RTOL, atol=0)


def _linear_inputs(L=None, gelu=False, seed=12):
    rng = _rng(seed)
    T, I, O = 64, 16, 48
    lead = () if L is None else (L,)
    x = rng.standard_normal(lead + (T, O if gelu else I)).astype(np.float32)
    if gelu:
        x = np.array(jax.nn.gelu(jnp.asarray(x), approximate=False))
        I, O = O, I
    w = (0.3 * rng.standard_normal(lead + (O, I))).astype(np.float32)
    b = (0.1 * rng.standard_normal(lead + (O,))).astype(np.float32)
    y = (np.einsum("...ti,...oi->...to", x, w) + b[..., None, :]).astype(
        np.float32)
    return x, y, w, b


@pytest.mark.parametrize("gram,a_gram", [(False, False), (True, False),
                                         (True, True)])
@pytest.mark.parametrize("batched", [False, True])
def test_search_linear_default(gram, a_gram, batched):
    args = _linear_inputs(3 if batched else None)
    kw = dict(w_bits=4, a_bits=4, n_V=3, eq_n=32, steps=3, rounds=2,
              use_fpcs=True, gram=gram, a_gram=a_gram)
    jf, tf = ((JS.search_linear_default_batched,
               TS.search_linear_default_batched) if batched else
              (JS.search_linear_default, TS.search_linear_default))
    j = jf(*map(jnp.asarray, args), **kw)
    t = tf(*map(_t, args), **kw)
    for (js, jz), (ts, tz) in (((j[0], j[1]), (t[0], t[1])),
                               ((j[2], j[3]), (t[2], t[3]))):
        assert ts.shape == js.shape
        _pick_close(tz.numpy(), jz)
        _scale_close(ts.numpy(), js)


@pytest.mark.parametrize("batched", [False, True])
def test_search_act_channelwise(batched):
    x = _linear_inputs(3 if batched else None)[0]
    kw = dict(a_bits=4, eq_n=32, steps=3, use_fpcs=True)
    jf, tf = ((JS.search_act_channelwise_batched,
               TS.search_act_channelwise_batched) if batched else
              (JS.search_act_channelwise, TS.search_act_channelwise))
    (js, jz), (ts, tz) = jf(jnp.asarray(x), **kw), tf(_t(x), **kw)
    _pick_close(tz.numpy(), jz)
    _scale_close(ts.numpy(), js)


@pytest.mark.parametrize("use_fpcs", [True, False])
@pytest.mark.parametrize("batched", [False, True])
def test_search_linear_postgelu_adalog(use_fpcs, batched):
    args = _linear_inputs(2 if batched else None, gelu=True)
    kw = dict(w_bits=4, a_bits=4, n_V=1, eq_n=64, steps=3, rounds=2,
              use_fpcs=use_fpcs, gram=True)
    if batched:
        j = JS.search_linear_postgelu_adalog_batched(
            *map(jnp.asarray, args), jnp.float32(GELU_MIN), **kw)
        t = TS.search_linear_postgelu_adalog_batched(*map(_t, args),
                                                     GELU_MIN, **kw)
    else:
        j = JS.search_linear_postgelu_adalog(
            *map(jnp.asarray, args), jnp.float32(GELU_MIN), **kw)
        t = TS.search_linear_postgelu_adalog(*map(_t, args), GELU_MIN, **kw)
    _pick_close(t[1].numpy(), j[1])
    _scale_close(t[0].numpy(), j[0])
    _scale_close(t[2].numpy(), j[2])
    _pick_close(t[3].numpy(), j[3])                 # AdaLog base q


@pytest.mark.parametrize("batched", [False, True])
def test_search_linear_postgelu_twin(batched):
    args = _linear_inputs(2 if batched else None, gelu=True)
    kw = dict(w_bits=4, a_bits=4, n_V=1, eq_n=32, steps=3, rounds=2,
              use_fpcs=True)
    jf, tf = ((JS.search_linear_postgelu_twin_batched,
               TS.search_linear_postgelu_twin_batched) if batched else
              (JS.search_linear_postgelu_twin, TS.search_linear_postgelu_twin))
    j, t = jf(*map(jnp.asarray, args), **kw), tf(*map(_t, args), **kw)
    _pick_close(t[1].numpy(), j[1])
    for a, b in ((t[0], j[0]), (t[2], j[2]), (t[3], j[3])):
        _scale_close(a.numpy(), b)


def _matmul_inputs(L=None, post=False, seed=13):
    rng = _rng(seed)
    lead = () if L is None else (L,)
    N, H, S, C = 2, 2, 12, 8
    if post:
        A = np.array(jax.nn.softmax(jnp.asarray(2 * rng.standard_normal(
            lead + (N, H, S, S)).astype(np.float32)), -1))
        B = rng.standard_normal(lead + (N, H, S, C)).astype(np.float32)
    else:
        A = rng.standard_normal(lead + (N, H, S, C)).astype(np.float32)
        B = rng.standard_normal(lead + (N, H, C, S)).astype(np.float32)
    return A, B, (A @ B).astype(np.float32)


@pytest.mark.parametrize("gram,hcw", [(False, True), (True, True),
                                      (False, False), (True, False)])
@pytest.mark.parametrize("batched", [False, True])
def test_search_matmul(gram, hcw, batched):
    args = _matmul_inputs(2 if batched else None)
    kw = dict(A_bits=4, B_bits=4, eq_n=32, steps=3, rounds=2, use_fpcs=True,
              head_cw=hcw, gram=gram)
    jf, tf = ((JS.search_matmul_batched, TS.search_matmul_batched)
              if batched else (JS.search_matmul, TS.search_matmul))
    j, t = jf(*map(jnp.asarray, args), **kw), tf(*map(_t, args), **kw)
    for k in range(4):
        assert t[k].shape == j[k].shape
    _pick_close(t[1].numpy(), j[1])
    _pick_close(t[3].numpy(), j[3])
    _scale_close(t[0].numpy(), j[0])
    _scale_close(t[2].numpy(), j[2])


@pytest.mark.parametrize("a_kind", ["adalog", "log2", "logsqrt2"])
@pytest.mark.parametrize("batched", [False, True])
def test_search_matmul_postsoftmax(a_kind, batched):
    args = _matmul_inputs(2 if batched else None, post=True)
    kw = dict(A_bits=4, B_bits=4, eq_n=32, steps=3, rounds=2, use_fpcs=True,
              head_cw=True, a_kind=a_kind)
    jf, tf = ((JS.search_matmul_postsoftmax_batched,
               TS.search_matmul_postsoftmax_batched) if batched else
              (JS.search_matmul_postsoftmax, TS.search_matmul_postsoftmax))
    j, t = jf(*map(jnp.asarray, args), **kw), tf(*map(_t, args), **kw)
    _pick_close(t[0].numpy(), j[0])                 # AdaLog base q
    _pick_close(t[2].numpy(), j[2])
    _scale_close(t[1].numpy(), j[1])


@pytest.mark.parametrize("conv_dims", [(4, 4, 4, 0), (4, 4, 2, 1)])
@pytest.mark.parametrize("batched", [False, True])
def test_search_conv(conv_dims, batched):
    rng = _rng(14)
    lead = (2,) if batched else ()
    x = rng.standard_normal(lead + (2, 16, 16, 3)).astype(np.float32)
    w = (0.2 * rng.standard_normal(lead + (8, 3, 4, 4))).astype(np.float32)
    b = (0.1 * rng.standard_normal(lead + (8,))).astype(np.float32)
    kh, kw_, stride, pad = conv_dims

    def conv(x, w, b):
        return torch.nn.functional.conv2d(
            _t(x).permute(0, 3, 1, 2), _t(w), _t(b), stride=stride,
            padding=pad).permute(0, 2, 3, 1).numpy()

    y = np.stack([conv(*a) for a in zip(x, w, b)]) if batched else \
        conv(x, w, b)
    kw = dict(w_bits=4, eq_n=32, steps=3, use_fpcs=True, conv_dims=conv_dims)
    jf, tf = ((JS.search_conv_batched, TS.search_conv_batched) if batched
              else (JS.search_conv, TS.search_conv))
    (js, jz) = jf(*map(jnp.asarray, (x, y, w, b)), **kw)
    (ts, tz) = tf(*map(_t, (x, y, w, b)), **kw)
    assert ts.shape == js.shape
    _pick_close(tz.numpy(), jz)
    _scale_close(ts.numpy(), js)


def test_zz_adjacent_share_reported():
    """Runs last in this file: the share of integer picks of the family
    tests that landed on the candidate next to JAX's."""
    share = ADJACENT["adjacent"] / max(1, ADJACENT["picks"])
    print(f"integer picks: {ADJACENT['picks']}, adjacent "
          f"{ADJACENT['adjacent']} (share {share:.4f})")
    assert share <= ADJACENT_SHARE_MAX
