"""The port's quantizers (adalog_tpu_torch.quantizers) against adalog_tpu's.

The same numpy inputs go through both packages. Uniform, twin and weight
quantizers must agree bitwise: both round half to even and clamp in fp32.
The log quantizers take codes from log2, and torch.log2 and XLA's log2 may
differ in the last bit; a value within an ulp of a .5 code boundary then
rounds to the neighbouring code. Every code that differs must be such a
near-tie, and their share must stay under FLIP_BOUND. Where the codes agree
the dequantized values agree to DEQUANT_RTOL: XLA's CPU exp2 is inexact at
negative integer exponents (exp2(-13) = 1.22070254e-04, not 2**-13; up to
4e-6 relative across the normal range), where torch.exp2 is exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adalog_tpu.quantizers import apply as japply
from adalog_tpu.quantizers import logarithm as jlog
from adalog_tpu.quantizers import state as jstate
from adalog_tpu_torch.quantizers import apply as tapply
from adalog_tpu_torch.quantizers import logarithm as tlog
from adalog_tpu_torch.quantizers import state as tstate
from adalog_tpu_torch.quantizers.ste import round_ste

torch.set_num_threads(1)

# largest share of log-quantizer codes allowed to take the neighbouring code
# (measured on the CPU over 2**20 inputs spread across 20 octaves, q in
# 23..51, 3-6 bits: at most 1 code in 2**20 flips)
FLIP_BOUND = 1e-3
# a flipped code's continuous value must lie this close to a .5 boundary
TIE_WINDOW = 1e-4
# dequantized values where the codes agree (XLA's exp2 error, see above)
DEQUANT_RTOL = 5e-6
# one fp32 ulp, relative
ULP_RTOL = 1.2e-7


def _pair(**fields):
    """(JAX QuantizerState, port QuantizerState) from numpy fields."""
    arrays = {k: v for k, v in fields.items() if isinstance(v, np.ndarray)}
    static = {k: v for k, v in fields.items() if not isinstance(v, np.ndarray)}
    j = jstate.QuantizerState(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **static)
    t = tstate.QuantizerState(
        **{k: torch.from_numpy(v.copy()) for k, v in arrays.items()}, **static)
    return j, t


def _both(jq, tq, x):
    yj = np.asarray(japply.apply_quantizer(jq, jnp.asarray(x)))
    yt = tapply.apply_quantizer(tq, torch.from_numpy(x)).numpy()
    return yj, yt


@pytest.mark.parametrize("bits", [3, 4, 6, 8])
@pytest.mark.parametrize("symmetric", [False, True])
def test_uniform_bitwise(rng, bits, symmetric):
    x = (3 * rng.standard_normal((4, 6, 64))).astype(np.float32)
    scale = (0.05 + 0.3 * rng.random((1, 6, 1))).astype(np.float32)
    fields = dict(scale=scale, kind="uniform", bits=bits, symmetric=symmetric)
    if not symmetric:
        fields["zero_point"] = rng.uniform(0, 2 ** bits - 1,
                                           (1, 6, 1)).astype(np.float32)
    yj, yt = _both(*_pair(**fields), x)
    np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("bits", [4, 6])
def test_twin_bitwise(rng, bits):
    x = (rng.standard_normal((8, 128)) - 0.1).astype(np.float32)
    scale = np.array([[0.05], [0.004]], np.float32)
    yj, yt = _both(*_pair(scale=scale, kind="twin", bits=bits), x)
    np.testing.assert_array_equal(yt, yj)


def _codes(xs, scale, k, bits):
    """Both packages' clamped log codes of the same fp32 input; ``k`` is the
    base factor, a number or (for AdaLog) the pair of each package's r/q."""
    kj, kt = k if isinstance(k, tuple) else (k, k)
    cj, _ = jlog._log_codes(jnp.asarray(xs), jnp.asarray(scale), kj, bits,
                            False)
    ct, _ = tlog._log_codes(torch.from_numpy(xs), torch.from_numpy(scale), kt,
                            bits, False)
    return np.asarray(cj), ct.numpy()


def _assert_near_ties(codes, outs, k_cont):
    """Codes agree bitwise except where the continuous code value k_cont
    (float64) sits within TIE_WINDOW of a .5 boundary, and those stay rare;
    outputs agree wherever the codes do."""
    (cj, ct), (yj, yt) = codes, outs
    flip = cj != ct
    assert flip.mean() <= FLIP_BOUND, f"flip share {flip.mean()}"
    frac = np.abs(np.mod(k_cont[flip], 1.0) - 0.5)
    assert np.all(frac < TIE_WINDOW), f"non-tie flips: {frac.max()}"
    np.testing.assert_allclose(yt[~flip], yj[~flip], rtol=DEQUANT_RTOL, atol=0)


def _log_inputs(rng, n=1 << 16):
    # spread over ~20 octaves so every code level is hit
    return np.exp2(-rng.uniform(0, 20, n)).astype(np.float32)


@pytest.mark.parametrize("kind,k", [("log2", 1.0), ("logsqrt2", 2.0)])
@pytest.mark.parametrize("bits", [3, 4, 6])
def test_log_quantizers(rng, kind, k, bits):
    x = _log_inputs(rng)
    scale = np.array([0.8], np.float32)
    outs = _both(*_pair(scale=scale, kind=kind, bits=bits), x)
    k_cont = -np.log2(np.clip(x.astype(np.float64) / scale[0], 1e-15, 1)) * k
    _assert_near_ties(_codes(x, scale, k, bits), outs, k_cont)


def _adalog_k(q):
    """Each package's base factor r/q, computed as its adalog_quant does."""
    return (37.0 / jnp.asarray(q, jnp.float32), 37.0 / torch.tensor(q))


@pytest.mark.parametrize("q", [23.0, 29.0, 37.0, 45.0, 51.0])
@pytest.mark.parametrize("bits", [3, 4, 6])
def test_adalog_unshifted(rng, q, bits):
    """Post-softmax AdaLog: probabilities, scale 1, searched base q."""
    x = _log_inputs(rng)
    scale = np.ones((1,), np.float32)
    outs = _both(*_pair(scale=scale, log_q=np.asarray(q, np.float32),
                        kind="adalog", bits=bits), x)
    k_cont = -np.log2(np.clip(x.astype(np.float64), 1e-15, 1)) * 37.0 / q
    _assert_near_ties(_codes(x, scale, _adalog_k(q), bits), outs, k_cont)


@pytest.mark.parametrize("bias_reparamed", [False, True])
@pytest.mark.parametrize("q", [29.0, 43.0])
def test_adalog_shifted(rng, q, bias_reparamed):
    """Post-GeLU AdaLog: quantize x + GELU_MIN, subtract the shift back
    unless it has been folded into the consumer's bias."""
    x = (rng.standard_normal((32, 256)) * 1.5).astype(np.float32)
    x = np.maximum(x, -tstate.GELU_MIN)        # the post-GeLU range
    scale = np.array([6.0], np.float32)
    shift = np.full((1,), tstate.GELU_MIN, np.float32)
    yj, yt = _both(*_pair(scale=scale, shift=shift,
                          log_q=np.asarray(q, np.float32),
                          bias_reparamed=np.asarray(bias_reparamed),
                          kind="adalog", bits=4, shifted=True), x)
    xs = x + shift                              # fp32, as both packages add
    k_cont = -np.log2(np.clip(xs.astype(np.float64) / scale[0], 1e-15, 1)) \
        * 37.0 / q
    _assert_near_ties(_codes(xs, scale, _adalog_k(q), 4), (yj, yt), k_cont)
    if not bias_reparamed:
        # the shift comes back off: outputs live in the input's range
        assert yt.min() >= -tstate.GELU_MIN - 1e-6


@pytest.mark.parametrize("q", [23, 31, 37, 46, 51])
@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8])
def test_adalog_tables_exact(q, bits):
    t1j, t2j = jlog.make_adalog_tables(q, bits)
    t1t, t2t = tlog.make_adalog_tables(q, bits)
    np.testing.assert_array_equal(t1t.numpy(), np.asarray(t1j))
    np.testing.assert_array_equal(t2t.numpy(), np.asarray(t2j))
    # the closed-form dequant of every code is the table lookup
    # 2**-table1 * table2 (to an ulp: the run-time mantissa rounds in fp32,
    # the table in float64), and the JAX package's to DEQUANT_RTOL; codes
    # whose value leaves the normal fp32 range (XLA flushes it) are skipped
    codes = np.arange(2 ** bits, dtype=np.float32)
    normal = t1t.numpy() <= 125         # mantissa >= 0.5: a normal product
    dt = tlog.adalog_dequant_code(torch.from_numpy(codes),
                                  torch.tensor(float(q)), bits=bits).numpy()
    table = np.ldexp(t2t.numpy(), -t1t.numpy().astype(np.int32))
    np.testing.assert_allclose(dt[normal], table[normal], rtol=ULP_RTOL,
                               atol=0)
    dj = np.asarray(jlog.adalog_dequant_code(jnp.asarray(codes),
                                             jnp.float32(q), bits=bits))
    np.testing.assert_allclose(dt[normal], dj[normal], rtol=DEQUANT_RTOL,
                               atol=0)


@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8])
def test_mantissa_table_exact(bits):
    np.testing.assert_array_equal(tlog.make_mantissa_table(bits).numpy(),
                                  np.asarray(jlog.make_mantissa_table(bits)))


@pytest.mark.parametrize("bits", [3, 4, 6, 8])
@pytest.mark.parametrize("with_alpha", [False, True])
def test_weight_quantizer_bitwise(rng, bits, with_alpha):
    """Row-group weight quantizer, plain uniform or AdaRound hard rounding."""
    w = (0.05 * rng.standard_normal((3, 16, 32))).astype(np.float32)
    hi, lo = w.max(-1, keepdims=True), w.min(-1, keepdims=True)
    scale = np.maximum((hi - lo) / (2 ** bits - 1), 1e-8).astype(np.float32)
    zp = np.round(-lo / scale).astype(np.float32)
    alpha = (rng.standard_normal(w.shape).astype(np.float32)
             if with_alpha else None)
    jw = jstate.WeightQuantizerState(
        scale=jnp.asarray(scale), zero_point=jnp.asarray(zp),
        alpha=None if alpha is None else jnp.asarray(alpha), bits=bits)
    tw = tstate.WeightQuantizerState(
        scale=torch.from_numpy(scale), zero_point=torch.from_numpy(zp),
        alpha=None if alpha is None else torch.from_numpy(alpha), bits=bits)
    yj = np.asarray(japply.apply_weight_quantizer(jw, jnp.asarray(w)))
    yt = tapply.apply_weight_quantizer(tw, torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(yt, yj)


def test_bf16_input_roundtrip(rng):
    """Quantizer math runs in fp32 and the result is cast back to the
    input dtype, as in the JAX package."""
    x = (3 * rng.standard_normal((64,))).astype(np.float32)
    jq, tq = _pair(scale=np.array([0.3], np.float32),
                   zero_point=np.array([7.0], np.float32), kind="uniform",
                   bits=4)
    yj = np.asarray(japply.apply_quantizer(
        jq, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    yt = tapply.apply_quantizer(
        tq, torch.from_numpy(x).to(torch.bfloat16))
    assert yt.dtype == torch.bfloat16
    np.testing.assert_array_equal(yt.float().numpy(), yj)


def test_ste_identity_gradient():
    x = torch.tensor([0.4, 1.5, 2.5, -0.6], requires_grad=True)
    y = round_ste(x)
    assert torch.equal(y.detach(), torch.tensor([0.0, 2.0, 2.0, -1.0]))
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, torch.ones_like(x))


@pytest.mark.parametrize("kind", ["uniform", "logsqrt2", "adalog"])
def test_training_forward_matches_jax(rng, kind):
    """training=True rounds with the straight-through estimator and, for the
    log quantizers, dequantizes with the continuous exp2(-code*k)."""
    if kind == "uniform":
        x = (3 * rng.standard_normal((4096,))).astype(np.float32)
        fields = dict(scale=np.array([0.3], np.float32),
                      zero_point=np.array([7.0], np.float32))
    else:
        x = _log_inputs(rng, 4096)
        fields = dict(scale=np.ones((1,), np.float32))
        if kind == "adalog":
            fields["log_q"] = np.asarray(31.0, np.float32)
    jq, tq = _pair(**fields, kind=kind, bits=4)
    yj = np.asarray(japply.apply_quantizer(jq, jnp.asarray(x), training=True))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tapply.apply_quantizer(tq, xt, training=True)
    far = ~np.isclose(yt.detach().numpy(), yj, rtol=DEQUANT_RTOL, atol=0)
    assert far.mean() <= FLIP_BOUND
    (g,) = torch.autograd.grad(yt.sum(), xt)
    assert torch.isfinite(g).all()
