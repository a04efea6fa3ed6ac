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

The kernels' tensor-core variant ("mma") computes another formulation of
the same function (bf16 operands, for fp32 inputs integer operands with the
scales on the sums, AdaLog values from a per-slice code table);
``fq_attn._attn_matmul_mma_plain`` is that formulation step for step in
plain PyTorch, and is held here to the JAX kernels too, with the routing
that decides which variant a call takes.

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
from adalog_tpu.models import swin as j_swin
from adalog_tpu.models.zoo import build_model as j_build_model
from adalog_tpu.ops import fq_attn as jfa
from adalog_tpu.quantizers.state import QuantizerState as JQS
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu_torch.models import layers, zoo
from adalog_tpu_torch.models.layers import MatMulSite
from adalog_tpu_torch.models.swin import swin_forward
from adalog_tpu_torch.models.vit import vit_forward
from adalog_tpu_torch.ops import fq_attn, routes
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
    """supports and supports_softmax decide as the JAX package's do (its
    switch on) for every combination of A kind, B kind, bit widths, shift
    flag and mode; ``qmatmul`` takes K3 where supports says yes under a
    plan with the kernels on, and nowhere with them off."""
    monkeypatch.setattr(jfa, "enabled", lambda: True)
    taken = []
    monkeypatch.setattr(fq_attn, "run",
                        lambda site, A, B, name=None: taken.append(site) or A)
    monkeypatch.setattr(layers, "_act_quant",
                        lambda qs, x, training, act=None: x)
    A = B = torch.zeros(1, 1, 2, 2)
    on, off = routes.Plan(attn=True), routes.Plan(attn=False)
    kinds = ("uniform", "adalog", "log2", "logsqrt2", "twin")
    n = 0
    for a_kind, b_kind, a_bits, b_bits, shifted, mode in itertools.product(
            kinds, ("uniform", "adalog"), (4, 32), (4, 32), (False, True),
            ("quant", "raw", "w_only", "a_only")):
        ja, ta = _qs_pair(a_kind, a_bits, shifted)
        jb, tb = _qs_pair(b_kind, b_bits, False)
        js, ts = JMatMulSite(Aq=ja, Bq=jb), MatMulSite(Aq=ta, Bq=tb)
        assert fq_attn.supports(ts, mode) == jfa.supports(js, mode)
        assert fq_attn.supports_softmax(ts, mode) == \
            jfa.supports_softmax(js, mode)
        for plan in (on, off):
            taken.clear()
            with routes.activate(plan):
                layers.qmatmul(ts, A, B, mode=mode)
            assert bool(taken) == (plan.attn and jfa.supports(js, mode))
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
    with torch.no_grad(), routes.activate(routes.build(SPEC, model, tq)):
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
    with routes.activate(routes.Plan(attn=True)):
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


# ---------------------------------------------------------------------------
# Variant "mma": its formulation in plain PyTorch, and the routing
# ---------------------------------------------------------------------------

# share of outputs that may leave the tolerance (an AdaLog code flipped by a
# last-bit difference of log2 between XLA and torch); measured 0 on these
# seeded inputs
MMA_SHARE = 1e-4
BF16_ULP = 2.0 ** -8
MMA_SHAPES = [(6, 197, 64), (12, 49, 32), (5, 33, 24)]    # the last ragged


def _mma_plain(case, args, kw):
    return fq_attn._attn_matmul_mma_plain(
        *args, a_kind=kw.get("a_kind", "adalog"), a_bits=kw["a_bits"],
        b_bits=kw["b_bits"], do_softmax=case.startswith("K2")).numpy()


@pytest.mark.parametrize("G,S,D", MMA_SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_mma_formulation_matches_jax_fp32(case, G, S, D):
    """fp32 inputs: integer operands c - z and steps * 2^-shift in bf16, the
    scales s_a * s_b or ts * s_b on the fp32 sum. Exact integer sums where
    JAX rounds every fp32 product, so the two differ by a few ulp of the
    sums: atol = rtol = 1e-5 (atol times the mean magnitude for q @ kT), at
    most MMA_SHARE of the outputs past it."""
    fn, kw, args = _case(case, G, S, D, seed=G * S + D)
    got, want = _mma_plain(case, args, kw), _jax(case, args, kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    tol = ATOL * max(1.0, float(np.abs(want).mean())) + RTOL * np.abs(want)
    share = float((np.abs(got - want) > tol).mean())
    assert share <= MMA_SHARE, f"share past tolerance {share}"
    # and the port's own plain version, which the card compares with
    plain = fn(*args, **kw).numpy()
    assert float((np.abs(got - plain) > tol).mean()) <= MMA_SHARE


@pytest.mark.parametrize("G,S,D", MMA_SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_mma_formulation_matches_jax_bf16(case, G, S, D):
    """bf16 inputs: the operands are the plain version's own bf16 values, so
    only the order of the fp32 sums is left; held to one bf16 ulp of the
    output."""
    fn, kw, args = _case(case, G, S, D, seed=G + S + D, dtype=torch.bfloat16)
    got, want = _mma_plain(case, args, kw), _jax(case, args, kw)
    tol = ATOL + BF16_ULP * np.abs(want)
    assert float((np.abs(got - want) > tol).mean()) <= MMA_SHARE
    np.testing.assert_allclose(got, fn(*args, **kw).numpy(), rtol=RTOL,
                               atol=ATOL * max(1.0,
                                               float(np.abs(want).mean())))


@pytest.mark.parametrize("G,S,D", MMA_SHAPES)
def test_mma_bf16_operands_bit_for_bit(G, S, D):
    """What "mma" stages for bf16 inputs is bit for bit what the plain
    version rounds to bf16 before its product: uq(A), uq(B), and the AdaLog
    values through the code table."""
    q, kT, v, m1a, m1b, m2q, m2b, _ = chip_smoke.attention_inputs(
        torch, G, S, D, 1, 21, "cpu")
    q, kT, v = (t.to(torch.bfloat16) for t in (q, kT, v))

    def per_g(a):
        return a.reshape(-1, 1, 1)

    ops = fq_attn._matmul_mma_operands(q, kT, m1a, m1b, a_kind="uniform",
                                       a_bits=4, b_bits=4)
    for got, x, prm in ((ops["A"], q, m1a), (ops["B"], kT, m1b)):
        want = fq_attn._uq(x.float(), per_g(prm[:, 0]), per_g(prm[:, 1]), 4)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want.to(torch.bfloat16))
    assert bool((ops["out_scale"] == 1).all()) and ops["table"] is None

    probs = torch.softmax(torch.matmul(q.float(), kT.float()) * D ** -0.5,
                          -1).to(torch.bfloat16)
    m2a = torch.stack([m2q, torch.zeros_like(m2q)], dim=1)
    ops = fq_attn._matmul_mma_operands(probs, v, m2a, m2b, a_kind="adalog",
                                       a_bits=4, b_bits=4)
    got = fq_attn._adalog_lookup(probs.float(), ops["table"], per_g(m2q))
    want = fq_attn._adalog_unit(probs.float(), per_g(m2q), 4)
    assert torch.equal(got.to(torch.bfloat16), want.to(torch.bfloat16))
    assert torch.equal(ops["B"], fq_attn._uq(
        v.float(), per_g(m2b[:, 0]), per_g(m2b[:, 1]), 4).to(torch.bfloat16))


@pytest.mark.parametrize("int_mode", [False, True])
@pytest.mark.parametrize("bits", [3, 4, 6, 8])
def test_code_table_equals_adalog_unit_on_every_code(bits, int_mode):
    """The table "mma" reads holds, for every code 0..2N-1 and bases with
    and without a fraction, the bits ``_adalog_unit`` returns for a
    probability of that code; for fp32 inputs the entry times ts is that
    value, and the entry (steps * 2^-shift, steps <= 4N - 2) is exact in
    bf16 up to 7 bits."""
    dtype = torch.float32 if int_mode else torch.bfloat16
    base = torch.tensor([23.0, 29.5, 37.0, 41.25, 51.0])
    n = 2 ** bits
    A = torch.zeros(len(base), 1, 1, dtype=dtype)
    ap = torch.stack([base, torch.zeros_like(base)], dim=1)
    bp = torch.tensor([[0.1, 8.0]]).repeat(len(base), 1)
    ops = fq_attn._matmul_mma_operands(A, A, ap, bp, a_kind="adalog",
                                       a_bits=bits, b_bits=4)
    table = ops["table"]
    assert tuple(table.shape) == (len(base), n)
    # a probability in the middle of each code's interval
    code = torch.arange(n, dtype=torch.float64).reshape(1, -1)
    x = torch.exp2(-code * base.double().reshape(-1, 1) / 37.0).float()
    q = base.reshape(-1, 1, 1)
    want = fq_attn._adalog_unit(x.reshape(len(base), 1, n), q, bits)
    ts = 1.0 / (2 * n - 2)
    entry = (table * ts if int_mode else table).reshape(want.shape)
    # the quantizer clamps probabilities at 1e-15, so the highest codes of 6
    # and 8 bits are reached by none: those entries are only finite
    reached = (x > 2e-15).reshape(want.shape)
    assert bool(reached[..., :min(n, 32)].all())
    assert torch.equal(entry[reached], want[reached])
    assert torch.equal(
        fq_attn._adalog_lookup(x.reshape(len(base), 1, n), table, q)
        * (ts if int_mode else 1.0), want)
    if int_mode and bits <= 7:
        assert torch.equal(table.to(torch.bfloat16).float(), table)
        assert torch.equal(ops["out_scale"].reshape(-1),
                           torch.tensor(ts) * bp[:, 0])


def _routes(mode, S, K, C, dtype, a_bits=4, b_bits=4, exact=True, G=12):
    return fq_attn.matmul_variant(mode, G, S, K, C, dtype, a_bits, b_bits,
                                  exact)


F32, BF16 = torch.float32, torch.bfloat16
# (mode, S, K, C, dtype, a_bits, b_bits, exact_ints) -> variant
ROUTING = [
    (("uniform", 197, 64, 197, F32, 4, 4, True), "mma"),
    (("adalog", 197, 197, 64, F32, 4, 4, True), "mma"),
    (("softmax", 197, 197, 64, F32, 4, 4, True), "mma"),
    (("softmax", 49, 49, 32, BF16, 4, 4, True), "mma"),
    (("softmax", 144, 144, 32, F32, 4, 4, True), "mma"),
    # a row of logits past 256 columns: K2 only
    (("softmax", 256, 256, 64, F32, 4, 4, True), "mma"),
    (("softmax", 300, 300, 64, F32, 4, 4, True), "fma"),
    (("softmax", 300, 300, 64, BF16, 4, 4, True), "fma"),
    (("adalog", 300, 300, 64, F32, 4, 4, True), "mma"),
    (("uniform", 300, 64, 300, F32, 4, 4, True), "mma"),
    # output tiles and A operands in registers
    (("adalog", 197, 197, 128, BF16, 4, 4, True), "mma"),
    (("adalog", 197, 197, 129, BF16, 4, 4, True), "fma"),
    (("softmax", 197, 197, 129, BF16, 4, 4, True), "fma"),
    (("uniform", 197, 128, 197, BF16, 4, 4, True), "mma"),
    (("uniform", 197, 129, 197, BF16, 4, 4, True), "fma"),
    # the code table holds 256 values
    (("adalog", 49, 49, 32, BF16, 8, 4, True), "mma"),
    (("adalog", 49, 49, 32, BF16, 9, 4, True), "fma"),
    (("softmax", 49, 49, 32, BF16, 9, 4, True), "fma"),
    (("uniform", 49, 32, 49, BF16, 9, 9, True), "mma"),
    # fp32: integers exact in bf16 only
    (("uniform", 49, 32, 49, F32, 8, 8, True), "mma"),
    (("uniform", 49, 32, 49, F32, 9, 4, True), "fma"),
    (("uniform", 49, 32, 49, F32, 4, 9, True), "fma"),
    (("adalog", 49, 49, 32, F32, 7, 8, True), "mma"),
    (("adalog", 49, 49, 32, F32, 8, 4, True), "fma"),
    (("softmax", 49, 49, 32, F32, 8, 4, True), "fma"),
    (("adalog", 49, 49, 32, F32, 4, 9, True), "fma"),
    (("uniform", 49, 32, 49, F32, 4, 4, False), "fma"),
    (("adalog", 49, 49, 32, F32, 4, 4, False), "fma"),
    (("softmax", 49, 49, 32, F32, 4, 4, False), "fma"),
    (("softmax", 49, 49, 32, BF16, 4, 4, False), "mma"),
    # the staging of uq(B) in one block's shared memory
    (("adalog", 64, 800, 128, BF16, 4, 4, True), "mma"),
    (("adalog", 64, 900, 128, BF16, 4, 4, True), None),     # nor "fma"
]


@pytest.mark.parametrize("call,want", ROUTING,
                         ids=[f"{c[0]}-S{c[1]}-K{c[2]}-C{c[3]}-"
                              f"{str(c[4])[6:]}-a{c[5]}b{c[6]}-"
                              f"{'exact' if c[7] else 'inexact'}"
                              for c, _ in ROUTING])
def test_matmul_routing_truth_table(call, want):
    """"mma" where it applies, else "fma"; "mma" forced where it does not
    apply raises with the limit named, "fma" forced is always taken."""
    mode, S, K, C, dtype, a_bits, b_bits, exact = call
    why = fq_attn.matmul_mma_refusal(mode, 12, S, K, C, dtype, a_bits, b_bits,
                                     exact)
    if K * C * 4 > 232448:          # past the fp32 staging of "fma" as well
        for variant in ("fma",) + (("auto",) if want is None else ()):
            with pytest.raises(ValueError, match="shared memory"):
                fq_attn.matmul_variant(mode, 12, S, K, C, dtype, a_bits,
                                       b_bits, exact, variant)
        assert (why is None) == (want == "mma")
        if want == "mma":
            assert _routes(*call) == "mma"
        return
    assert _routes(*call) == want
    assert fq_attn.matmul_variant(mode, 12, S, K, C, dtype, a_bits, b_bits,
                                  exact, "fma") == "fma"
    if want == "mma":
        assert why is None
        assert fq_attn.matmul_variant(mode, 12, S, K, C, dtype, a_bits,
                                      b_bits, exact, "mma") == "mma"
    else:
        assert why
        with pytest.raises(ValueError, match="refused"):
            fq_attn.matmul_variant(mode, 12, S, K, C, dtype, a_bits, b_bits,
                                   exact, "mma")
    with pytest.raises(ValueError):
        fq_attn.matmul_variant(mode, 12, S, K, C, dtype, a_bits, b_bits,
                               exact, "wgmma")


@pytest.mark.parametrize("case", CASES)
def test_forced_variant_is_checked_on_the_cpu(case):
    """A forced variant that does not take the call raises on a CPU tensor
    too; one that does runs the plain version; the wrapper reads the zero
    points itself when no verdict is given."""
    fn, kw, (A, B, ap, bp) = _case(case, 6, 16, 8, seed=13)
    want = fn(A, B, ap, bp, **kw)
    for variant in ("mma", "fma"):
        assert torch.equal(fn(A, B, ap, bp, variant=variant, **kw), want)
    with pytest.raises(ValueError, match="zero point"):
        fn(A, B, ap, bp, variant="mma", exact_ints=False, **kw)
    far = bp.clone()
    far[2, 1] = 300.0                       # |c - z| up to 300 > 256
    with pytest.raises(ValueError, match="zero point"):
        fn(A, B, ap, far, variant="mma", **kw)
    assert fn(A, B, ap, far, variant="fma", **kw).shape == want.shape
    with pytest.raises(ValueError, match="variant"):
        fn(A, B, ap, bp, variant="tensor", **kw)
    if case.startswith("K2"):
        L = torch.zeros(2, 4, 300)
        with pytest.raises(ValueError, match="K=300"):
            fn(L, torch.zeros(2, 300, 8), ap[:2], bp[:2], variant="mma", **kw)


def test_matmul_mma_shared_memory_bytes():
    """The bytes a block of "mma" asks for, as the launch computes them: the
    zoo's shapes leave room for three or more blocks an SM."""
    smem = fq_attn._matmul_mma_smem_bytes
    assert smem("softmax", 197, 64) == 208 * 72 * 2 + 1040
    assert smem("softmax", 49, 32) == 64 * 40 * 2 + 1040
    assert smem("adalog", 197, 64) == 208 * 72 * 2 + 1040
    assert smem("adalog", 300, 64) == 304 * 72 * 2 + 1040
    assert smem("uniform", 64, 197) == 64 * 216 * 2 + 4 * (16 * 72 * 2
                                                           + 16 * 72 * 4)
    assert smem("uniform", 32, 49) == 32 * 72 * 2 + 4 * (16 * 40 * 2
                                                         + 16 * 72 * 4)
    for mode, K, C in (("softmax", 197, 64), ("adalog", 197, 64),
                       ("uniform", 64, 197), ("softmax", 144, 32),
                       ("uniform", 32, 144)):
        assert 3 * smem(mode, K, C) <= 232448 - 3 * 1024


@pytest.mark.parametrize("verdict", [None, True, False])
def test_run_carries_the_verdict_and_the_site_params(verdict, monkeypatch):
    """run and run_softmax hand the plan's verdict on the zero points on as
    ``run_flash`` does, and take the site's (P, 2) parameter rows from the
    plan by its name when it has them (unrepeated: the kernel reads row
    g % P), else flatten them on the call; rows built from another site
    raise."""
    rng = np.random.default_rng(14)
    N, H, S, D = 2, 3, 16, 8
    _, site = _site_pair(rng, H, "adalog")
    L = torch.from_numpy((rng.standard_normal((N, H, S, S)) * 3
                          ).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((N, H, S, D)).astype(np.float32))
    seen = []
    real = fq_attn._attn_matmul

    def spy(wrapper, mode, A, B, ap, bp, a_bits, b_bits, variant, exact):
        seen.append((wrapper.__name__, mode, ap, bp, variant, exact))
        return real(wrapper, mode, A, B, ap, bp, a_bits, b_bits, variant,
                    exact)

    monkeypatch.setattr(fq_attn, "_attn_matmul", spy)
    name = "blocks.0.attn.matmul2"
    rows = fq_attn.site_params(site)
    plan = routes.Plan(attn=True, exact_ints=verdict,
                       attn_params={name: (site, *rows)})
    want2 = fq_attn.run_softmax(site, L, v)
    want3 = fq_attn.run(site, torch.softmax(L, -1), v)
    seen.clear()
    with routes.activate(plan):
        got2 = fq_attn.run_softmax(site, L, v, name=name)
        got3 = fq_attn.run(site, torch.softmax(L, -1), v, name=name)
    assert torch.equal(got2, want2) and torch.equal(got3, want3)
    assert [(s[0], s[1], s[4], s[5]) for s in seen] == [
        ("fq_softmax_attn_matmul", "softmax", "auto", verdict),
        ("fq_attn_matmul", "adalog", "auto", verdict)]
    for _, _, ap, bp, _, _ in seen:
        assert ap is rows[0] and bp is rows[1]
        assert tuple(ap.shape) == (1, 2) and tuple(bp.shape) == (H, 2)
    seen.clear()
    with routes.activate(plan):
        assert torch.equal(fq_attn.run(site, torch.softmax(L, -1), v), want3)
        with pytest.raises(RuntimeError, match="another quantizer state"):
            fq_attn.run(_site_pair(rng, H, "adalog")[1],
                        torch.softmax(L, -1), v, name=name)
    assert seen[0][2] is not rows[0] and torch.equal(seen[0][2], rows[0])
    with pytest.raises(ValueError, match="tile"):
        fq_attn.run(site, torch.softmax(L, -1)[:, :2], v[:, :2])


def _swin_state(post):
    """test_tiny_swin JAX params and init_qstate with matmul quantizers that
    do real work (unit scales would clip q, k, v to a few codes)."""
    _, params = j_build_model("test_tiny_swin", seed=0)
    spec = zoo.model_spec("test_tiny_swin")
    qstate = j_init_qstate(spec, JConfig(**W4A4, post_softmax_quantizer=post),
                           params)
    for nm, site in list(qstate.items()):
        if hasattr(site, "Aq"):
            def real(qs):
                return qs.replace(scale=jnp.full_like(qs.scale, 0.02),
                                  zero_point=jnp.full_like(qs.zero_point, 8.0))
            Aq = real(site.Aq) if site.Aq.kind == "uniform" else site.Aq
            qstate[nm] = site.replace(Aq=Aq, Bq=real(site.Bq))
    return jax.tree_util.tree_map(np.asarray, (params, qstate))


SWIN_M1 = ["layers.0.blocks.0.attn.matmul1", "layers.1.blocks.0.attn.matmul1",
           "layers.1.blocks.1.attn.matmul1"]
# model: (JAX forward, port forward, state, matmul1 sites, attentions)
FORWARDS = {
    "test_tiny": (j_vit_forward, vit_forward, _tiny_state,
                  list(RAW_M1)[1:], 2),
    "test_tiny_swin": (j_swin.swin_forward, swin_forward, _swin_state,
                       SWIN_M1, 3),
}


@pytest.mark.parametrize("config", ["log2", "matmul1_raw", "capture"])
@pytest.mark.parametrize("model_name", list(FORWARDS))
def test_fallback_forward_in_mma_formulation_matches_jax(model_name, config,
                                                         monkeypatch):
    """The whole forward of both fixture models through each configuration
    that reaches K2 / K3, with every such call computed in the "mma"
    formulation (as the card computes it), against the JAX forward with its
    kernels in interpret mode, at 1e-5; fp32, so integer operands."""
    j_fwd, fwd, state, m1_sites, n_attn = FORWARDS[model_name]
    spec = zoo.model_spec(model_name)
    post = "log2" if config == "log2" else "adalog"
    modes = {"*": "quant"}
    if config == "matmul1_raw":
        modes.update({m: "raw" for m in m1_sites})
    capture = config == "capture"
    params, qstate = state(post)
    model, tq = from_jax(spec.cfg, params, qstate)
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 3)
                                                 ).astype(np.float32)
    monkeypatch.setattr(jfa, "enabled", lambda: True)
    want = j_fwd(spec.cfg, params, jnp.asarray(x), qstate, modes,
                 capture=capture)
    want = np.asarray(want[0] if capture else want)

    n_mma = [0]

    def mma_plain(A, B, ap, bp, a_kind, a_bits, b_bits, do_softmax):
        n_mma[0] += 1
        mode = "softmax" if do_softmax else a_kind
        assert fq_attn.matmul_mma_refusal(
            mode, *A.shape, B.shape[2], A.dtype, a_bits, b_bits,
            fq_attn.integers_exact(tq)) is None
        return fq_attn._attn_matmul_mma_plain(
            A, B, ap, bp, a_kind=a_kind, a_bits=a_bits, b_bits=b_bits,
            do_softmax=do_softmax)

    monkeypatch.setattr(fq_attn, "_attn_matmul_plain", mma_plain)
    with torch.no_grad(), routes.activate(routes.build(spec, model, tq)):
        got = fwd(spec.cfg, model, torch.from_numpy(x), tq, modes,
                  capture=capture)
    got = (got[0] if capture else got).numpy()
    assert n_mma[0] == n_attn * (2 if capture else 1)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
