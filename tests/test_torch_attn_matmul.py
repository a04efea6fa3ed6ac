"""The port's fused attention matmuls (adalog_tpu_torch.ops.fq_attn: K3
fq_attn_matmul, K2 fq_softmax_attn_matmul) against adalog_tpu's Pallas
kernels run in interpret mode, and the attention fall-back chain of the ViT
forward against the JAX package's.

On the CPU the wrappers run their plain versions. The same numpy inputs go
through both packages; outputs agree to ATOL/RTOL: both quantize the
operands identically and accumulate in fp32, so only the order of the fp32
sums (and, for K2, of the softmax's) differs. A probability within an ulp of
an AdaLog code boundary could take the neighbouring code; on these seeded
inputs none does. The absolute tolerance is ATOL times the mean output
magnitude where that is above 1: q @ kT at head dim 64 sums 64 products of
magnitude up to about 10 (mean |out| about 17), and the order of that sum
alone moves a cancelling result by more than 1e-5.

The CUDA kernels are held against the plain versions in
test_torch_attn_matmul_cuda.py, which imports no jax so that it runs on the
GPU machine.
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from adalog_tpu.calib.init_state import init_qstate as j_init_qstate
from adalog_tpu.models.layers import MatMulSite as JMatMulSite
from adalog_tpu.models.vit import vit_forward as j_vit_forward
from adalog_tpu.models.vit import vit_init as j_vit_init
from adalog_tpu.ops import fq_attn as jfa
from adalog_tpu.quantizers.state import QuantizerState as JQS
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.models.layers import MatMulSite
from adalog_tpu_torch.models.vit import vit_forward
from adalog_tpu_torch.ops import fq_attn
from adalog_tpu_torch.quantizers.state import QuantizerState
from adalog_tpu_torch.utils.interop import from_jax

torch.set_num_threads(1)

ATOL = RTOL = 1e-5
# model logits of the two packages with the kernels' plain versions in the
# path: fp32 sum order differs in every product (measured max |diff| below
# 1e-6 on logits of magnitude 0.3)
LOGIT_TOL = 1e-5
SHAPES = [(6, 16, 8), (6, 197, 64), (12, 49, 32)]     # (G, S, D)
CASES = ("K3 uniform A (q @ kT)", "K3 AdaLog A (probs @ v)",
         "K2 (softmax, AdaLog, @ v)")


@pytest.fixture(autouse=True)
def interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _case(case, G, S, D, seed, dtype=torch.float32):
    """chip_smoke's seeded K2/K3 inputs of one case: (port wrapper, kwargs,
    numpy args)."""
    cases, _ = chip_smoke.matmul_cases(torch, fq_attn, G, S, D, seed, "cpu",
                                       dtype)
    fn, _, args, kw = cases[case]
    return fn, kw, args


def _close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(want).mean())))


def _jax(case, args, kw):
    j = [jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)
        for a in args]
    fn = jfa.fq_softmax_attn_matmul if case.startswith("K2") \
        else jfa.fq_attn_matmul
    return np.asarray(fn(*j, **kw))


@pytest.mark.parametrize("G,S,D", SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_fp32(case, G, S, D):
    fn, kw, args = _case(case, G, S, D, seed=G * S + D)
    got = fn(*args, **kw).numpy()
    assert got.dtype == np.float32
    assert got.shape == (G, S, args[1].shape[2])
    _close(got, _jax(case, args, kw))


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_bf16(case):
    """bf16 operands: quantized values rounded to bf16 before the product,
    fp32 accumulation, fp32 output, in both packages."""
    fn, kw, args = _case(case, 6, 16, 8, seed=5, dtype=torch.bfloat16)
    got = fn(*args, **kw).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _jax(case, args, kw), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bits", [3, 6])
def test_plain_matches_jax_other_bits(bits):
    q, kT, v, m1a, m1b, m2q, m2b, _ = chip_smoke.attention_inputs(
        torch, 6, 16, 8, 1, 9, "cpu", bits)
    m2a = torch.stack([m2q, torch.zeros_like(m2q)], dim=1)
    L = torch.matmul(q, kT) * 8 ** -0.5
    for case, args, kw in (
            (CASES[0], (q, kT, m1a, m1b), dict(a_kind="uniform")),
            (CASES[1], (torch.softmax(L, -1), v, m2a, m2b),
             dict(a_kind="adalog")),
            (CASES[2], (L, v, m2a, m2b), {})):
        kw = dict(kw, a_bits=bits, b_bits=bits)
        fn = fq_attn.fq_softmax_attn_matmul if case.startswith("K2") \
            else fq_attn.fq_attn_matmul
        np.testing.assert_allclose(fn(*args, **kw).numpy(),
                                   _jax(case, args, kw), rtol=RTOL, atol=ATOL)


def _site_pair(rng, H, a_kind, q_log=29.0):
    """The same matmul site in both packages: per-head uniform B, and A
    per-head uniform or AdaLog with base q_log."""
    def uq_np():
        return dict(scale=(0.1 + 0.05 * rng.random((1, H, 1, 1))
                           ).astype(np.float32),
                    zero_point=rng.integers(6, 10, (1, H, 1, 1)
                                            ).astype(np.float32))

    def both(d, **kw):
        return (JQS(**{k: jnp.asarray(v) for k, v in d.items()}, **kw),
                QuantizerState(**{k: torch.from_numpy(np.asarray(v))
                                  for k, v in d.items()}, **kw))

    if a_kind == "uniform":
        ja, ta = both(uq_np(), kind="uniform", bits=4)
    else:
        ja, ta = both(dict(scale=np.ones((1, 1, 1, 1), np.float32),
                           log_q=np.float32(q_log)), kind="adalog", bits=4)
    jb, tb = both(uq_np(), kind="uniform", bits=4)
    return JMatMulSite(Aq=ja, Bq=jb), MatMulSite(Aq=ta, Bq=tb)


@pytest.mark.parametrize("a_kind", ["uniform", "adalog"])
def test_run_matches_jax(a_kind):
    """4-D dispatch with per-head site state, as qmatmul calls it."""
    rng = np.random.default_rng(3)
    N, H, S, D = 2, 3, 16, 8
    if a_kind == "uniform":
        A = (rng.standard_normal((N, H, S, D)) * 2).astype(np.float32)
        B = (rng.standard_normal((N, H, D, S)) * 2).astype(np.float32)
    else:
        A = torch.softmax(torch.from_numpy(
            rng.standard_normal((N, H, S, S)) * 3), -1).float().numpy()
        B = rng.standard_normal((N, H, S, D)).astype(np.float32)
    js, ts = _site_pair(rng, H, a_kind)
    want = np.asarray(jfa.run(js, jnp.asarray(A), jnp.asarray(B)))
    got = fq_attn.run(ts, torch.from_numpy(A), torch.from_numpy(B))
    assert got.shape == (N, H, S, B.shape[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_run_softmax_matches_jax():
    rng = np.random.default_rng(4)
    N, H, S, D = 2, 3, 16, 8
    L = (rng.standard_normal((N, H, S, S)) * 3).astype(np.float32)
    v = rng.standard_normal((N, H, S, D)).astype(np.float32)
    js, ts = _site_pair(rng, H, "adalog", q_log=43.0)
    want = np.asarray(jfa.run_softmax(js, jnp.asarray(L), jnp.asarray(v)))
    got = fq_attn.run_softmax(ts, torch.from_numpy(L), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # and the port's own unfused chain: softmax, then the quantized matmul2
    from adalog_tpu_torch.models.layers import qmatmul
    unfused = qmatmul(ts, torch.softmax(torch.from_numpy(L), -1),
                      torch.from_numpy(v), mode="quant")
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=RTOL,
                               atol=ATOL)


def _qs_pair(kind, bits, shifted):
    kw = dict(kind=kind, bits=bits, shifted=shifted)
    return (JQS(scale=jnp.ones((1,)), **kw),
            QuantizerState(scale=torch.ones(1), **kw))


def test_supports_truth_tables_equal_jax(monkeypatch):
    """supports and supports_softmax decide as the JAX package's do for every
    combination of A kind, B kind, bit widths, shift flag and mode; with the
    kernels off both say no."""
    monkeypatch.setattr(jfa, "enabled", lambda: True)
    kinds = ("uniform", "adalog", "log2", "logsqrt2", "twin")
    n = 0
    for a_kind, b_kind, a_bits, b_bits, shifted, mode in itertools.product(
            kinds, ("uniform", "adalog"), (4, 32), (4, 32), (False, True),
            ("quant", "raw", "w_only", "a_only")):
        ja, ta = _qs_pair(a_kind, a_bits, shifted)
        jb, tb = _qs_pair(b_kind, b_bits, False)
        js, ts = JMatMulSite(Aq=ja, Bq=jb), MatMulSite(Aq=ta, Bq=tb)
        with fq_attn.activate(True):
            assert fq_attn.supports(ts, mode) == jfa.supports(js, mode)
            assert fq_attn.supports_softmax(ts, mode) == \
                jfa.supports_softmax(js, mode)
        assert not fq_attn.supports(ts, mode)
        assert not fq_attn.supports_softmax(ts, mode)
        n += jfa.supports(js, mode) + jfa.supports_softmax(js, mode)
    assert n > 0


# ---------------------------------------------------------------------------
# The ViT forward's fall-back chain
# ---------------------------------------------------------------------------

SPEC = zoo.model_spec("test_tiny")
W4A4 = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)
RAW_M1 = {"*": "quant", "blocks.0.attn.matmul1": "raw",
          "blocks.1.attn.matmul1": "raw"}
# name: (post_softmax_quantizer, modes, capture, calls of (K1, K2, K3))
CHAIN = {
    "shipped": ("adalog", {"*": "quant"}, False, (2, 0, 0)),
    "log2": ("log2", {"*": "quant"}, False, (0, 0, 2)),
    "matmul1_raw": ("adalog", RAW_M1, False, (0, 2, 0)),
    "capture": ("adalog", {"*": "quant"}, True, (0, 0, 4)),
}


def _tiny_state(post):
    """test_tiny JAX params and init_qstate with activation quantizers that
    do real work: unit scales would clip every activation to a few codes."""
    params = jax.jit(j_vit_init, static_argnums=0)(SPEC.cfg,
                                                   jax.random.PRNGKey(0))
    qstate = j_init_qstate(SPEC, JConfig(**W4A4, post_softmax_quantizer=post),
                           params)
    for nm, site in list(qstate.items()):
        if hasattr(site, "aq"):
            if site.aq.kind == "uniform" and site.aq.zero_point is not None:
                qstate[nm] = site.replace(aq=site.aq.replace(
                    scale=jnp.full_like(site.aq.scale, 0.3),
                    zero_point=jnp.full_like(site.aq.zero_point, 8.0)))
        else:
            def real(qs, s):
                return qs.replace(scale=jnp.full_like(qs.scale, s),
                                  zero_point=jnp.full_like(qs.zero_point, 8.0))
            Aq = real(site.Aq, 0.02) if site.Aq.kind == "uniform" else site.Aq
            qstate[nm] = site.replace(Aq=Aq, Bq=real(site.Bq, 0.02))
    return jax.tree_util.tree_map(np.asarray, (params, qstate))


@pytest.mark.parametrize("name", list(CHAIN))
def test_vit_fallback_chain_matches_jax(name, monkeypatch):
    """Which kernel each attention site reaches, by the wrappers' call
    counts, and logits equal to the JAX forward's with its kernels forced on
    in interpret mode."""
    post, modes, capture, want_calls = CHAIN[name]
    params, qstate = _tiny_state(post)
    model, tq = from_jax(SPEC.cfg, params, qstate)
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 3)
                                                 ).astype(np.float32)

    jcalls = {"K1": 0, "K2": 0, "K3": 0}
    for key, attr in (("K1", "run_flash"), ("K2", "run_softmax"),
                      ("K3", "run")):
        def counted(*a, _real=getattr(jfa, attr), _key=key, **k):
            jcalls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(jfa, attr, counted)
    monkeypatch.setattr(jfa, "enabled", lambda: True)
    want = j_vit_forward(SPEC.cfg, params, jnp.asarray(x), qstate, modes,
                         capture=capture)
    want = np.asarray(want[0] if capture else want)
    assert tuple(jcalls.values()) == want_calls

    wrappers = (fq_attn.fq_flash_attn, fq_attn.fq_softmax_attn_matmul,
                fq_attn.fq_attn_matmul)
    before = [w.calls for w in wrappers]
    with torch.no_grad(), fq_attn.activate(True):
        got = vit_forward(SPEC.cfg, model, torch.from_numpy(x), tq, modes,
                          capture=capture)
    got = (got[0] if capture else got).numpy()
    assert tuple(w.calls - b for w, b in zip(wrappers, before)) == want_calls
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)

    # kernels off: the plain ops give the same logits, through no wrapper
    before = [w.calls for w in wrappers]
    with torch.no_grad():
        off = vit_forward(SPEC.cfg, model, torch.from_numpy(x), tq, modes)
    assert [w.calls for w in wrappers] == before
    np.testing.assert_allclose(off.numpy(), want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_qmatmul_dispatch_needs_4d_operands():
    """qmatmul takes K3 only for 4-D operands, as the JAX package's does."""
    from adalog_tpu_torch.models.layers import qmatmul

    rng = np.random.default_rng(8)
    _, site = _site_pair(rng, 1, "uniform")
    A = torch.from_numpy(rng.standard_normal((2, 1, 8, 4)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((2, 1, 4, 8)).astype(np.float32))
    before = fq_attn.fq_attn_matmul.calls
    with fq_attn.activate(True):
        y4 = qmatmul(site, A, B, mode="quant")
        assert fq_attn.fq_attn_matmul.calls == before + 1
        y3 = qmatmul(site, A[:, 0], B[:, 0], mode="quant")
        qmatmul(site, A, B, mode="raw")
        assert fq_attn.fq_attn_matmul.calls == before + 1
    # the (1, 1, 1, 1) site state broadcasts the 3-D product to 4-D
    np.testing.assert_allclose(y4[:, 0].numpy(), y3.reshape(2, 8, 8).numpy(),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_wrapper_cpu_runs_plain_and_launches_nothing(case):
    cases, _ = chip_smoke.matmul_cases(torch, fq_attn, 6, 16, 8, 11, "cpu",
                                       torch.float32)
    fn, plain, args, kw = cases[case]
    launches, calls = fn.launches, fn.calls
    assert torch.equal(fn(*args, **kw), plain(*args, **kw))
    assert fn.launches == launches and fn.calls == calls + 1


def test_wrapper_rejects_bad_inputs():
    fn, kw, (A, B, ap, bp) = _case(CASES[0], 6, 16, 8, seed=12)
    with pytest.raises(ValueError):          # B given as (G, S, K)
        fn(A, A, ap, bp, **kw)
    with pytest.raises(TypeError):           # mixed dtypes
        fn(A.to(torch.bfloat16), B, ap, bp, **kw)
    with pytest.raises(ValueError):          # params of another G
        fn(A, B, ap[:3], bp, **kw)
    with pytest.raises(ValueError):
        fn(A, B, ap, bp, **{**kw, "a_kind": "log2"})
    with pytest.raises(ValueError):
        fn(A, B, ap, bp, **{**kw, "b_bits": 32})
    with pytest.raises(ValueError):
        fq_attn.fq_softmax_attn_matmul(A, A, ap, bp, a_bits=4, b_bits=4)


def test_matmul_kernel_shape_limits():
    """K2/K3 stage uq(B) of a slice, (K, C) in fp32, in shared memory beside
    one A row per warp: every zoo shape fits (deit_small both ways, Swin's
    7x7 and 12x12 windows); K=577 at C=128 does not, and the message
    carries the numbers; the grid's x dimension holds G * tiles."""
    for S, K, C in ((197, 64, 197), (197, 197, 64), (49, 32, 49),
                    (49, 49, 32), (144, 32, 144), (144, 144, 32)):
        fq_attn.check_matmul_kernel_shape(8192, S, K, C)
    with pytest.raises(ValueError, match="295424.*232448"):
        fq_attn.check_matmul_kernel_shape(1, 577, 577, 128)
    with pytest.raises(ValueError, match="blocks"):
        fq_attn.check_matmul_kernel_shape(2 ** 30, 197, 64, 197)
    with pytest.raises(ValueError):
        fq_attn.check_matmul_kernel_shape(4, 0, 64, 64)


@pytest.mark.parametrize("S,rows,warps", [
    (49, 49, 10), (197, 50, 10), (144, 48, 12), (1, 1, 1), (12, 12, 12),
    (64, 64, 11), (65, 33, 11)])
def test_matmul_tile_plan(S, rows, warps):
    """Rows split evenly over tiles of at most 64, a tile's rows evenly over
    at most 12 warps; every row is covered."""
    assert fq_attn.matmul_tile_plan(S) == (rows, warps)
    tiles = -(-S // rows)
    assert tiles * rows >= S and (tiles - 1) * rows < S and warps <= 12


def test_library_name_follows_shared_headers(tmp_path, monkeypatch):
    """The built library's name carries the hash of the source and of every
    header of csrc/, so an edit to the quantizers' shared header rebuilds
    the kernels that include it."""
    from adalog_tpu_torch.ops import cuda_build

    (tmp_path / "k.cu").write_text('#include "q.cuh"\n')
    (tmp_path / "q.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    first = cuda_build._lib_path("k")
    assert cuda_build._lib_path("k") == first
    (tmp_path / "q.cuh").write_text("// v2\n")
    second = cuda_build._lib_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "q.cuh"\n// edited\n')
    assert cuda_build._lib_path("k") not in (first, second)
