"""The port's fused fake-quant attention (adalog_tpu_torch.ops.fq_attn, K1)
against adalog_tpu's Pallas fq_flash_attn run in interpret mode.

On the CPU the wrapper runs fq_flash_attn_plain. The same numpy inputs go
through both packages; outputs agree to ATOL/RTOL: both quantize the
operands identically and accumulate in fp32, so only the order of the fp32
sums differs. A probability within an ulp of an AdaLog code boundary could
take the neighbouring code; on these seeded inputs none does.

The CUDA kernel is held against the plain version in
test_torch_fq_attn_cuda.py, which imports no jax so that it runs on the GPU
machine.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from adalog_tpu.models.layers import MatMulSite as JMatMulSite
from adalog_tpu.ops import fq_attn as jfa
from adalog_tpu.quantizers.state import QuantizerState as JQS
from adalog_tpu_torch.models.layers import MatMulSite, qmatmul
from adalog_tpu_torch.ops import fq_attn
from adalog_tpu_torch.quantizers.state import QuantizerState

torch.set_num_threads(1)

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _inputs(seed, G, S, D, P, bits=4):
    """chip_smoke's seeded attention inputs as numpy: (7 arrays, bias or
    None)."""
    *arrays, bias = (t.numpy() for t in chip_smoke.attention_inputs(
        torch, G, S, D, P, seed, "cpu", bits))
    return arrays, (bias if P else None)


def _jax(arrays, bias, dtype, **kw):
    j = [jnp.asarray(a) for a in arrays]
    j[:3] = [a.astype(dtype) for a in j[:3]]
    return np.asarray(jfa.fq_flash_attn(
        *j, None if bias is None else jnp.asarray(bias), **kw))


def _torch(arrays, bias, dtype, **kw):
    t = [torch.from_numpy(a) for a in arrays]
    t[:3] = [a.to(dtype) for a in t[:3]]
    b = None if bias is None else torch.from_numpy(bias)
    return fq_attn.fq_flash_attn(*t, b, **kw).numpy()


def _kw(bits, logit_scale):
    return dict(m1a_bits=bits, m1b_bits=bits, m2a_bits=bits, m2b_bits=bits,
                logit_scale=logit_scale)


@pytest.mark.parametrize("G,S,D,P,bits", [
    (6, 16, 8, 0, 4),
    (6, 16, 8, 3, 4),           # bias with period P=3 < G
    (6, 16, 8, 0, 6),
    (6, 197, 64, 0, 4),         # deit_small: S=197, D=64, G = 6 heads
    (6, 197, 64, 6, 4),
])
def test_plain_matches_jax_flash_fp32(G, S, D, P, bits):
    arrays, bias = _inputs(G * S + P + bits, G, S, D, P, bits)
    kw = _kw(bits, 1.0 if P else D ** -0.5)
    want = _jax(arrays, bias, jnp.float32, **kw)
    got = _torch(arrays, bias, torch.float32, **kw)
    assert got.dtype == np.float32 and got.shape == (G, S, D)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("P", [0, 3])
def test_plain_matches_jax_flash_bf16(P):
    """bf16 inputs: quantized operands rounded to bf16 before each product,
    fp32 accumulation, in both packages."""
    G, S, D = 6, 16, 8
    arrays, bias = _inputs(7 + P, G, S, D, P)
    kw = _kw(4, D ** -0.5)
    want = _jax(arrays, bias, jnp.bfloat16, **kw)
    got = _torch(arrays, bias, torch.bfloat16, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _sites(rng, H, q_log):
    def uq_np():
        return dict(scale=(0.1 + 0.05 * rng.random((1, H, 1, 1))
                           ).astype(np.float32),
                    zero_point=rng.integers(6, 10, (1, H, 1, 1)
                                            ).astype(np.float32))

    m1 = (uq_np(), uq_np())
    m2b = uq_np()

    def jq(d):
        return JQS(**{k: jnp.asarray(v) for k, v in d.items()},
                   kind="uniform", bits=4)

    def tq(d):
        return QuantizerState(**{k: torch.from_numpy(v) for k, v in d.items()},
                              kind="uniform", bits=4)

    ja = JQS(scale=jnp.ones((1, 1, 1, 1)), log_q=jnp.asarray(q_log),
             kind="adalog", bits=4)
    ta = QuantizerState(scale=torch.ones((1, 1, 1, 1)),
                        log_q=torch.tensor(q_log), kind="adalog", bits=4)
    return ((JMatMulSite(Aq=jq(m1[0]), Bq=jq(m1[1])),
             JMatMulSite(Aq=ja, Bq=jq(m2b))),
            (MatMulSite(Aq=tq(m1[0]), Bq=tq(m1[1])),
             MatMulSite(Aq=ta, Bq=tq(m2b))))


def test_run_flash_matches_jax():
    """4D dispatch with per-head site state, as the ViT forward calls it."""
    rng = np.random.default_rng(3)
    N, H, S, D = 2, 3, 16, 8
    q, v = (rng.standard_normal((2, N, H, S, D)) * 2).astype(np.float32)
    kT = (rng.standard_normal((N, H, D, S)) * 2).astype(np.float32)
    (jm1, jm2), (tm1, tm2) = _sites(rng, H, 29.0)
    want = np.asarray(jfa.run_flash(jm1, jm2, jnp.asarray(q), jnp.asarray(kT),
                                    jnp.asarray(v), logit_scale=D ** -0.5))
    got = fq_attn.run_flash(tm1, tm2, torch.from_numpy(q),
                            torch.from_numpy(kT), torch.from_numpy(v),
                            logit_scale=D ** -0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_flash_matches_unfused_port_path():
    """The fused path equals the port's own unfused chain: quantized
    matmul1 -> scale -> softmax -> quantized matmul2."""
    rng = np.random.default_rng(4)
    N, H, S, D = 2, 4, 16, 8
    q, v = (torch.from_numpy((rng.standard_normal((N, H, S, D)) * 2
                              ).astype(np.float32)) for _ in range(2))
    kT = torch.from_numpy((rng.standard_normal((N, H, D, S)) * 2
                           ).astype(np.float32))
    _, (m1, m2) = _sites(rng, H, 43.0)
    attn = torch.softmax(qmatmul(m1, q, kT, mode="quant") * D ** -0.5, -1)
    want = qmatmul(m2, attn, v, mode="quant")
    got = fq_attn.run_flash(m1, m2, q, kT, v, logit_scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_flash_gate():
    """supports_flash needs the kernels switched on, both-uniform matmul1
    and AdaLog matmul2, both sites in quant mode."""
    rng = np.random.default_rng(0)
    _, (m1, m2) = _sites(rng, 2, 29.0)
    assert not fq_attn.supports_flash(m1, m2, "quant", "quant")
    with fq_attn.activate(True):
        assert fq_attn.supports_flash(m1, m2, "quant", "quant")
        assert not fq_attn.supports_flash(m1, m2, "quant", "raw")
        assert not fq_attn.supports_flash(None, m2, "quant", "quant")
        assert not fq_attn.supports_flash(m2, m2, "quant", "quant")
        assert not fq_attn.supports_flash(m1, m1, "quant", "quant")
    assert not fq_attn.enabled()


def test_wrapper_cpu_runs_plain_and_counts_nothing():
    arrays, bias = _inputs(11, 6, 16, 8, 3)
    t = [torch.from_numpy(a) for a in arrays]
    kw = _kw(4, 0.5)
    before = fq_attn.fq_flash_attn.launches
    got = fq_attn.fq_flash_attn(*t, torch.from_numpy(bias), **kw)
    want = fq_attn.fq_flash_attn_plain(*t, torch.from_numpy(bias), **kw)
    assert torch.equal(got, want)
    assert fq_attn.fq_flash_attn.launches == before


def test_wrapper_rejects_bad_inputs():
    arrays, _ = _inputs(12, 6, 16, 8, 0)
    t = [torch.from_numpy(a) for a in arrays]
    kw = _kw(4, 0.5)
    with pytest.raises(ValueError):          # kT given as (G, S, D)
        fq_attn.fq_flash_attn(t[0], t[0], *t[2:], **kw)
    with pytest.raises(TypeError):           # mixed dtypes
        fq_attn.fq_flash_attn(t[0].to(torch.bfloat16), *t[1:], **kw)
    with pytest.raises(ValueError):          # P must divide G
        fq_attn.fq_flash_attn(*t, torch.zeros(4, 16, 16), **kw)
    with pytest.raises(ValueError):
        fq_attn.fq_flash_attn(*t, **{**kw, "m2a_bits": 32})


def test_kernel_shape_limits():
    """The kernel stages uq(kT) and uq(v) of a slice in shared memory:
    deit_small fits, vit_large's S=577 at D=64 does not."""
    fq_attn.check_kernel_shape(197, 64)
    fq_attn.check_kernel_shape(144, 32)
    with pytest.raises(ValueError):
        fq_attn.check_kernel_shape(577, 64)
    with pytest.raises(ValueError):
        fq_attn.check_kernel_shape(64, 256)
