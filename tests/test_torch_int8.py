"""The port's int8 path (ops/int8_linear.py, its dispatch in qlinear and the
predictor's plan) against adalog_tpu's on the CPU, case for case of
tests/test_int8_path.py.

The same numpy inputs go to both packages. JAX's ``int8_qlinear`` runs
eagerly, one XLA program an operation, so its epilogue rounds the product
and the sum apart as the port's plain version does: codes and outputs are
held bit for bit. Whole forwards are held to the serving tests' LOGIT_TOL:
the jitted JAX forward may fuse that product and sum, and the two packages'
fp32 GEMMs and quantizers elsewhere sum in other orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adalog_tpu.calib.init_state import init_qstate as j_init_qstate
from adalog_tpu.models.layers import LinearP as JLinearP
from adalog_tpu.models.layers import LinearSite as JLinearSite
from adalog_tpu.models.zoo import build_model as j_build_model
from adalog_tpu.models.zoo import model_forward_fn as j_forward_fn
from adalog_tpu.ops import int8_linear as j_int8
from adalog_tpu.quantizers.state import QuantizerState as JQState
from adalog_tpu.quantizers.state import WeightQuantizerState as JWQState
from adalog_tpu.serve import make_predictor as j_make_predictor
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.models.layers import LinearSite, qlinear
from adalog_tpu_torch.ops import int8_linear, routes
from adalog_tpu_torch.serve import make_predictor
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.interop import from_jax, qstate_from_tree

torch.set_num_threads(1)

W4A4 = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)
# logits of whole forwards, as tests/test_torch_vit_serve.py holds them
LOGIT_TOL = 1e-5
# int8 against the fake-quant path of the same package: the fake-quant
# products are fp32-rounded, the integer ones exact (JAX's own bound)
FAKE_QUANT_TOL = 2e-5
MODELS = ("test_tiny", "test_tiny_swin")


def _int8_plan(lin, site, weights=None):
    """A plan of the one int8 site "ln" of Linear ``lin``."""
    if weights is None:
        weights = int8_linear.site_weights(lin.weight, site)
    return routes.Plan({"ln": routes.Route("int8", site, lin.weight.shape,
                                           int8=weights)})


def _int8_table(plan):
    """{site: Int8Weights} of a plan's int8 routes."""
    return {n: r.int8 for n, r in plan.linear.items() if r.kind == "int8"}


@pytest.fixture(autouse=True)
def jax_int8_off():
    """JAX's switch is process-global: every test leaves it off."""
    yield
    j_int8.set_enabled(False)


def _site(rng, O, n_V=1, bits=4):
    """tests/test_int8_path.py's site: a JAX LinearSite and the port's."""
    N = 2 ** (bits - 1)
    V, R = n_V, O // n_V
    j = JLinearSite(
        wq=JWQState(
            scale=jnp.asarray(0.02 + 0.01 * rng.random((V, R, 1)),
                              jnp.float32),
            zero_point=jnp.asarray(
                rng.integers(N - 2, N + 2, (V, R, 1)).astype(np.float32)),
            bits=bits, symmetric=False),
        aq=JQState(scale=jnp.full((1,), 0.07, jnp.float32),
                   zero_point=jnp.full((1,), float(N - 1), jnp.float32),
                   kind="uniform", bits=bits, symmetric=False),
        n_V=n_V)
    return j, qstate_from_tree({"s": jax.tree_util.tree_map(np.asarray,
                                                            j)})["s"]


def _linear(rng, O, I, bias=True):
    """(JAX LinearP, the port's nn.Linear) of the same numpy weights."""
    w = (rng.standard_normal((O, I)) * 0.2).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32) if bias else None
    lin = torch.nn.Linear(I, O, bias=bias).requires_grad_(False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        if bias:
            lin.bias.copy_(torch.from_numpy(b))
    return JLinearP(w=jnp.asarray(w),
                    b=None if b is None else jnp.asarray(b)), lin


def _x(rng, T, I):
    return rng.standard_normal((T, I)).astype(np.float32)


CASES = [(3, 1), (4, 3), (6, 1)]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("bits,n_V", CASES)
def test_int8_equals_jax_bit_for_bit(rng, bits, n_V, bias):
    """Weight codes, row scales and outputs equal JAX's int8_qlinear."""
    T, I, O = 24, 16, 12
    jp, lin = _linear(rng, O, I, bias)
    jsite, site = _site(rng, O, n_V, bits)
    x = _x(rng, T, I)

    j_w, j_s = j_int8.weight_codes(jp, jsite)
    w_int, s_row = int8_linear.weight_codes(lin.weight, site)
    assert w_int.dtype == torch.int8
    np.testing.assert_array_equal(w_int.numpy(), np.asarray(j_w))
    np.testing.assert_array_equal(s_row.numpy(), np.asarray(j_s))

    want = np.asarray(j_int8.int8_qlinear(jp, jsite, jnp.asarray(x)))
    got = int8_linear.int8_qlinear(lin, site, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits,n_V", CASES)
def test_int8_activation_codes_equal_jax(rng, bits, n_V):
    """The activation codes, read through an identity weight (codes 1 at
    row scale 1): equal JAX's bit for bit on inputs spread past the clamp."""
    T, I = 24, 16
    jsite, site = _site(rng, I, n_V, bits)
    x = 3 * _x(rng, T, I)
    ident = JWQState(scale=jnp.ones((1, I, 1), jnp.float32),
                     zero_point=jnp.zeros((1, I, 1), jnp.float32), bits=2,
                     symmetric=False)
    want = np.asarray(j_int8.int8_qlinear(
        JLinearP(w=jnp.eye(I, dtype=jnp.float32), b=None),
        jsite.replace(wq=ident, n_V=1), jnp.asarray(x)))
    aq = site.aq
    a_params = torch.stack([aq.scale.reshape(()), aq.zero_point.reshape(())])
    codes = int8_linear.activation_codes(torch.from_numpy(x), a_params,
                                         bits=bits)
    got = int8_linear.int8_gemm(torch.from_numpy(x),
                                torch.eye(I, dtype=torch.int8), a_params,
                                aq.scale.reshape(()) * torch.ones(I),
                                bits=bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), (codes * aq.scale).numpy())
    assert codes.min() == -round(float(aq.zero_point))
    assert codes.max() == 2 ** bits - 1 - round(float(aq.zero_point))


@pytest.mark.parametrize("bits,n_V", CASES)
def test_int8_matches_fake_quant(rng, bits, n_V):
    """int8 against the port's own fake-quant qlinear (JAX's bound)."""
    T, I, O = 24, 16, 12
    _, lin = _linear(rng, O, I)
    _, site = _site(rng, O, n_V, bits)
    x = torch.from_numpy(_x(rng, T, I))
    got = int8_linear.int8_qlinear(lin, site, x)
    with torch.no_grad():
        want = qlinear(lin, site, x, mode="quant")
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               rtol=FAKE_QUANT_TOL, atol=FAKE_QUANT_TOL)


@pytest.mark.parametrize("bits,n_V", [(4, 3), (6, 1)])
def test_int8_prepared_weights_identical(rng, bits, n_V):
    """Codes from the plan give the per-call result bit for bit."""
    T, I, O = 24, 16, 12
    _, lin = _linear(rng, O, I)
    _, site = _site(rng, O, n_V, bits)
    x = torch.from_numpy(_x(rng, T, I))
    want = int8_linear.int8_qlinear(lin, site, x)
    hit = int8_linear.site_weights(lin.weight, site)
    w_int, s_row = int8_linear.weight_codes(lin.weight, site)
    assert torch.equal(hit.w_int, w_int)
    assert torch.equal(hit.scale_row, site.aq.scale.reshape(()) * s_row)
    calls = int8_linear.int8_gemm.calls
    got = int8_linear.int8_qlinear(lin, site, x, hit)
    with routes.activate(_int8_plan(lin, site, hit)):
        via_qlinear = qlinear(lin, site, x, mode="quant", name="ln")
    assert int8_linear.int8_gemm.calls == calls + 2
    assert torch.equal(got, want) and torch.equal(via_qlinear, want)


def test_int8_prepared_shape_mismatch_recomputes(rng):
    """A route built for a weight of another shape raises where it is asked
    for: each predictor builds its plan from the weights it runs (a tp
    rank's from its shard). Codes of the weight at hand, computed per call,
    equal JAX's fallback for a weight shard."""
    T, I, O, bits = 24, 16, 12, 4
    jp, lin = _linear(rng, O, I)
    jsite, site = _site(rng, O, 1, bits)
    x = _x(rng, T, I)
    half = torch.nn.Linear(I, O // 2).requires_grad_(False)
    with torch.no_grad():
        half.weight.copy_(lin.weight[: O // 2])
        half.bias.copy_(lin.bias[: O // 2])
    wq = site.wq
    site_h = LinearSite(wq=type(wq)(scale=wq.scale[:, : O // 2],
                                    zero_point=wq.zero_point[:, : O // 2],
                                    bits=wq.bits, symmetric=False),
                        aq=site.aq, n_V=1)
    got = int8_linear.int8_qlinear(half, site_h, torch.from_numpy(x))
    full = int8_linear.site_weights(lin.weight, site)            # (O, I)
    plan = routes.Plan({"ln": routes.Route("int8", site_h, lin.weight.shape,
                                           int8=full)})
    with routes.activate(plan), pytest.raises(RuntimeError,
                                              match="another model"):
        qlinear(half, site_h, torch.from_numpy(x), mode="quant", name="ln")
    assert got.shape == (T, O // 2)
    # and the same shard through JAX's fallback
    jp_h = JLinearP(w=jp.w[: O // 2], b=jp.b[: O // 2])
    jsite_h = jsite.replace(wq=jsite.wq.replace(
        scale=jsite.wq.scale[:, : O // 2],
        zero_point=jsite.wq.zero_point[:, : O // 2]))
    with j_int8.activate({"ln": j_int8.weight_codes(jp, jsite)}):
        j_got = j_int8.int8_qlinear(jp_h, jsite_h, jnp.asarray(x), name="ln")
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_got))


def test_int8_tables_isolated_across_predictors(rng):
    """Two models' plans, each entered by its own predictor, never mix, in
    whatever order the predictors first run; outside both, qlinear takes the
    fake-quant path."""
    T, I, O, bits = 8, 16, 12, 4
    _, site = _site(rng, O, 1, bits)
    x = torch.from_numpy(_x(rng, T, I))

    def make_model(seed):
        _, lin = _linear(np.random.default_rng(seed), O, I, bias=False)
        plan = _int8_plan(lin, site)

        def predict(xx):
            with routes.activate(plan):
                return qlinear(lin, site, xx, mode="quant", name="ln")
        return lin, predict

    lin1, pred1 = make_model(1)
    lin2, pred2 = make_model(2)
    out2, out1 = pred2(x), pred1(x)
    assert torch.equal(out1, int8_linear.int8_qlinear(lin1, site, x))
    assert torch.equal(out2, int8_linear.int8_qlinear(lin2, site, x))
    assert not torch.equal(out1, out2)
    assert routes.current() is None
    calls = int8_linear.int8_gemm.calls
    with torch.no_grad():
        qlinear(lin1, site, x, mode="quant", name="ln")
    assert int8_linear.int8_gemm.calls == calls


def test_int8_bf16_codes_from_cast_weights(rng):
    """Codes of the bf16-cast weights equal JAX's prepare with
    cast_dtype=bfloat16, and serve a bf16 weight bit for bit as JAX."""
    T, I, O, bits = 24, 16, 12, 4
    jp, lin = _linear(rng, O, I)
    jsite, site = _site(rng, O, 1, bits)
    x = _x(rng, T, I)
    j_w, j_s = j_int8.weight_codes(jp, jsite, cast_dtype=jnp.bfloat16)
    lin_bf = torch.nn.Linear(I, O).requires_grad_(False)
    with torch.no_grad():
        lin_bf.weight = torch.nn.Parameter(lin.weight.to(torch.bfloat16),
                                           requires_grad=False)
        lin_bf.bias.copy_(lin.bias)
    w_int, s_row = int8_linear.weight_codes(lin_bf.weight, site)
    np.testing.assert_array_equal(w_int.numpy(), np.asarray(j_w))
    np.testing.assert_array_equal(s_row.numpy(), np.asarray(j_s))
    p_bf = JLinearP(w=jp.w.astype(jnp.bfloat16), b=jp.b)
    want = np.asarray(j_int8.int8_qlinear(p_bf, jsite, jnp.asarray(x)))
    with routes.activate(_int8_plan(lin_bf, site)):
        got = qlinear(lin_bf, site, torch.from_numpy(x), mode="quant",
                      name="ln")
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_bf16_inputs_round_once(rng):
    """bf16 x and bias: the fp32 epilogue rounded once to bf16, equal to
    JAX's int8_qlinear on the same bf16 values."""
    T, I, O, bits = 24, 16, 12, 4
    jp, lin = _linear(rng, O, I)
    jsite, site = _site(rng, O, 3, bits)
    x = torch.from_numpy(_x(rng, T, I)).to(torch.bfloat16)
    lin_bf = torch.nn.Linear(I, O).to(torch.bfloat16).requires_grad_(False)
    with torch.no_grad():
        lin_bf.weight.copy_(lin.weight)
        lin_bf.bias.copy_(lin.bias)
    got = int8_linear.int8_qlinear(lin_bf, site, x)
    assert got.dtype == torch.bfloat16
    p_bf = JLinearP(w=jp.w.astype(jnp.bfloat16), b=jp.b.astype(jnp.bfloat16))
    want = j_int8.int8_qlinear(p_bf, jsite,
                               jnp.asarray(x.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _uniform_state(name):
    """JAX model ``name`` (seed 0) and its init_qstate at W4A4 with every
    uniform activation at scale 0.05, zero point 8 (as
    tests/test_int8_path.py sets them), in both packages."""
    spec, params = j_build_model(name, seed=0)
    qstate = j_init_qstate(spec, JConfig(**W4A4), params)
    for nm, site in list(qstate.items()):
        if hasattr(site, "aq") and site.aq.kind == "uniform" and \
                site.aq.zero_point is not None:
            qstate[nm] = site.replace(aq=site.aq.replace(
                scale=jnp.full_like(site.aq.scale, 0.05),
                zero_point=jnp.full_like(site.aq.zero_point, 8.0)))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    np_q = jax.tree_util.tree_map(np.asarray, qstate)
    port_spec = zoo.model_spec(name)
    model, tq = from_jax(port_spec.cfg, np_params, np_q)
    return spec, params, qstate, port_spec, model, tq


def _images(spec, seed, n=2):
    s = spec.cfg.img_size
    return np.random.default_rng(seed).standard_normal(
        (n, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("name", MODELS)
def test_int8_prepare_walks_model_as_jax(name, monkeypatch):
    """The port's plan routes the sites of JAX's prepare to int8 with their
    codes bit for bit, each entry equal to ``site_weights`` computed
    directly, and the forward with it equals the forward with per-call
    codes bit for bit."""
    jspec, jparams, jq, spec, model, tq = _uniform_state(name)
    cfg = Config(**W4A4)
    j_table = j_int8.prepare(jspec, jparams, jq, JConfig(**W4A4))
    plan = routes.build(spec, model, tq, cfg, use_int8=True)
    table = _int8_table(plan)
    assert set(table) == set(j_table) and len(table) >= 4, sorted(table)
    for nm, (j_w, j_s) in j_table.items():
        np.testing.assert_array_equal(table[nm].w_int.numpy(),
                                      np.asarray(j_w))
        np.testing.assert_array_equal(
            table[nm].scale_row.numpy(),
            np.asarray(jq[nm].aq.scale.reshape(()) * j_s))
        direct = int8_linear.site_weights(model.get_submodule(nm).weight,
                                          tq[nm])
        for a, b in zip(table[nm][:3], direct[:3]):
            assert torch.equal(a, b), nm
    fwd = zoo.model_forward_fn(spec)
    x = torch.from_numpy(_images(spec, 3))
    with torch.no_grad(), routes.activate(plan):
        got = fwd(spec.cfg, model, x, tq, {"*": "quant"})
        real = int8_linear.int8_qlinear
        monkeypatch.setattr(int8_linear, "int8_qlinear",
                            lambda p, site, x, weights: real(p, site, x))
        per_call = fwd(spec.cfg, model, x, tq, {"*": "quant"})
    assert torch.equal(got, per_call)


@pytest.mark.parametrize("eval_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_int8_predictor_matches_jax(name, eval_dtype):
    """make_predictor(use_int8=True) against JAX's predictor with its
    int8_prep table on the same state and images; the int8 sites take
    neither a fake-quantized weight nor the fused GEMM."""
    jspec, jparams, jq, spec, model, tq = _uniform_state(name)
    x = _images(spec, 4)
    j_int8.set_enabled(True)
    prep = j_int8.prepare(jspec, jparams, jq, JConfig(**W4A4),
                          cast_dtype=eval_dtype)
    want = np.asarray(j_make_predictor(jspec, jparams, jq,
                                       eval_dtype=eval_dtype, int8_prep=prep,
                                       cfg=JConfig(**W4A4))(jnp.asarray(x)))
    j_int8.set_enabled(False)
    calls = int8_linear.int8_gemm.calls
    predict = make_predictor(spec, model, tq, eval_dtype=eval_dtype,
                             cfg=Config(**W4A4), use_int8=True,
                             use_gemm_kernels=True, device="cpu")
    got = predict(x).numpy()
    n_int8 = int8_linear.int8_gemm.calls - calls
    assert n_int8 == len(prep), (n_int8, sorted(prep))
    tol = LOGIT_TOL if eval_dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_int8_sites_skip_weight_prep_and_fused_gemm():
    """Int8 before K4: an int8 site holds no fake-quantized weight and no
    fused GEMM entry; every other Linear site keeps both."""
    _, _, _, spec, model, tq = _uniform_state("test_tiny")
    cfg = Config(**W4A4)
    both = routes.build(spec, model, tq, cfg, use_int8=True,
                        use_gemm_kernels=True)
    gemm = routes.build(spec, model, tq, cfg, use_gemm_kernels=True)
    skip = set(_int8_table(both))
    assert skip and all(both.linear[n].weight is None
                        and both.linear[n].gemm is None for n in skip)
    full = {n for n, r in gemm.linear.items() if r.kind == "fq_gemm"}
    kept = {n for n, r in both.linear.items() if r.kind == "fq_gemm"}
    assert skip <= full and kept == full - skip
    for n in kept:
        assert torch.equal(both.linear[n].weight, gemm.linear[n].weight)


def test_int8_supports_as_jax(rng):
    """supports() answers as JAX's for the uniform site, and no for what
    JAX refuses: 8 bits, a per-channel activation scale, an AdaRound alpha,
    a mode other than quant."""
    jsite, site = _site(rng, 12, 1, 4)
    j_int8.set_enabled(True)
    assert int8_linear.supports(site, "quant") == j_int8.supports(jsite,
                                                                  "quant")
    assert not int8_linear.supports(site, "w_only")
    wq, aq = site.wq, site.aq
    for bad in (LinearSite(wq=wq, aq=type(aq)(**{**aq.__dict__, "bits": 8})),
                LinearSite(wq=type(wq)(**{**wq.__dict__, "bits": 8}), aq=aq),
                LinearSite(wq=wq, aq=type(aq)(**{**aq.__dict__,
                                                 "scale": aq.scale.repeat(3)})),
                LinearSite(wq=type(wq)(**{**wq.__dict__,
                                          "alpha": torch.zeros(1, 12, 16)}),
                           aq=aq)):
        assert not int8_linear.supports(bad, "quant")


def test_int8_prepare_refuses_codes_past_int8():
    """A zero point that would give codes past ±127 raises where the plan
    is built, not in a served call."""
    _, _, _, spec, model, tq = _uniform_state("test_tiny")
    name = "blocks.0.attn.qkv"
    aq = tq[name].aq
    tq[name] = LinearSite(wq=tq[name].wq, n_V=tq[name].n_V,
                          aq=type(aq)(**{**aq.__dict__, "bits": 7,
                                         "zero_point": aq.zero_point - 10.0}))
    with pytest.raises(ValueError, match="past int8"):
        routes.build(spec, model, tq, Config(**W4A4), use_int8=True)


def test_int8_wrapper_checks():
    x = torch.zeros(4, 8)
    w = torch.zeros(3, 8, dtype=torch.int8)
    prm, s = torch.tensor([0.1, 3.0]), torch.ones(3)
    with pytest.raises(TypeError):
        int8_linear.int8_gemm(x, w.float(), prm, s, bits=4)
    with pytest.raises(TypeError):
        int8_linear.int8_gemm(x, w, prm, s, torch.zeros(3).double(), bits=4)
    with pytest.raises(ValueError):
        int8_linear.int8_gemm(x, w[:, :4], prm, s, bits=4)
    with pytest.raises(ValueError):
        int8_linear.int8_gemm(x, w, prm, s, bits=8)
    with pytest.raises(RuntimeError, match="no path"):
        int8_linear.int8_gemm(x.to("meta"), w.to("meta"), prm.to("meta"),
                              s.to("meta"), bits=4)


# ---------------------------------------------------------------------------
# Routing between K5's variants (ops/int8_linear.py::int8_variant)
# ---------------------------------------------------------------------------

# the models the routing is held to: the two the port serves in its checks
# and the three the JAX package serves with int8 by default
ROUTED_MODELS = ("deit_small", "swin_tiny", "deit_base", "vit_large",
                 "swin_base_384")


def _int8_site_shapes(spec, batch=32):
    """[(site, T, K, O)] of every int8 site of a model at ``batch`` images
    (the uniform Linear sites: qkv, proj and fc1 of each block, Swin's
    patch-merging reductions and the head; fc2 is an AdaLog site), from its
    config: the large models are not built on the CPU."""
    c, out = spec.cfg, []
    if spec.family == "vit":
        T, D = batch * (c.num_patches + 1), c.dim
        for i in range(c.depth):
            out += [(f"blocks.{i} qkv", T, D, 3 * D),
                    (f"blocks.{i} proj", T, D, D),
                    (f"blocks.{i} fc1", T, D, int(D * c.mlp_ratio))]
        return out + [("head", batch, D, c.num_classes)]
    for s, depth in enumerate(c.depths):
        C, T = c.stage_dim(s), batch * c.stage_res(s) ** 2
        for i in range(depth):
            out += [(f"stage {s} block {i} qkv", T, C, 3 * C),
                    (f"stage {s} block {i} proj", T, C, C),
                    (f"stage {s} block {i} fc1", T, C, int(C * c.mlp_ratio))]
        if s + 1 < len(c.depths):
            out.append((f"reduction {s}-{s + 1}",
                        batch * c.stage_res(s + 1) ** 2, 4 * C, 2 * C))
    return out + [("head", batch, c.stage_dim(len(c.depths) - 1),
                   c.num_classes)]


@pytest.mark.parametrize("name", MODELS)
def test_int8_site_shapes_match_prepare(name):
    """The shape arithmetic of the routing test lists the (K, O) of every
    int8 route of the port's plan, on the tiny models that do build."""
    *_, spec, model, tq = _uniform_state(name)
    table = _int8_table(routes.build(spec, model, tq, Config(**W4A4),
                                     use_int8=True))
    want = sorted((K, O) for _, _, K, O in _int8_site_shapes(spec))
    assert sorted(tuple(hit.w_int.shape[::-1]) for hit in table.values()) \
        == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ROUTED_MODELS)
def test_int8_every_model_site_routes_wgmma(name, dtype):
    """Every int8 site of the served models, at batch 32, contiguous x:
    "wgmma" takes it (the heads' T = 32 too: rows past T are computed and
    never stored), by int8_variant and by the wrapper's forced call."""
    sites = _int8_site_shapes(zoo.model_spec(name))
    assert len(sites) == {"deit_small": 37, "swin_tiny": 40, "deit_base": 37,
                          "vit_large": 73, "swin_base_384": 76}[name]
    for site, T, K, O in sites:
        assert int8_linear.wgmma_refusal(T, K, O, K, 0, dtype) is None, site
        assert int8_linear.int8_variant(T, K, O, K, 0, dtype) == "wgmma"
    assert max(K for _, _, K, _ in sites) <= int8_linear.WGMMA_K_MAX


@pytest.mark.parametrize("T,K,O,lda,mod16,dtype,why,routed", [
    (64, 100, 128, 100, 0, torch.float32, "multiple of 16", "wgmma_codes"),
    (64, 40, 1001, 40, 0, torch.bfloat16, "multiple of 16", "mma"),
    (64, 32, 64, 33, 0, torch.float32, "16-byte aligned", "wgmma_codes"),
    (64, 32, 64, 36, 0, torch.bfloat16, "16-byte aligned", "wgmma_codes"),
    (64, 32, 64, 32, 8, torch.float32, "16-byte aligned", "wgmma_codes"),
    (64, 32, 130, 32, 0, torch.float32, "16-byte pieces", "mma"),
    (64, 32, 1004, 32, 0, torch.bfloat16, "16-byte pieces", "mma"),
    (64, 2192, 128, 2192, 0, torch.float32, "stay resident", "wgmma_codes"),
    (64, 4096, 1024, 4096, 0, torch.bfloat16, "stay resident",
     "wgmma_codes"),
])
def test_int8_wgmma_refusal_reasons(T, K, O, lda, mod16, dtype, why,
                                    routed):
    """Each reason "wgmma" refuses a call for; the call then takes
    "wgmma_codes" where K or x's alignment is the reason, "mma" where the
    output rows are (which "wgmma_codes" refuses too); a forced "wgmma"
    raises naming the reason."""
    assert why in int8_linear.wgmma_refusal(T, K, O, lda, mod16, dtype)
    assert int8_linear.int8_variant(T, K, O, lda, mod16, dtype) == routed
    assert (int8_linear.wgmma_codes_refusal(T, K, O, lda, mod16, dtype)
            is None) == (routed == "wgmma_codes")
    assert int8_linear.int8_variant(T, K, O, lda, mod16, dtype,
                                    "mma") == "mma"
    with pytest.raises(ValueError, match=why):
        int8_linear.int8_variant(T, K, O, lda, mod16, dtype, "wgmma")


def _eva02_site_shapes(batch=64):
    """{site: (T, K, O)} of eva02_large_448's five int8 sites at ``batch``
    images, from its config (q | k | v and gate | value are one site
    each; the head takes the mean-pooled rows)."""
    c = zoo.model_spec("eva02_large_448").cfg
    T, D = batch * ((c.img_size // c.patch_size) ** 2 + 1), c.dim
    return {"qkv": (T, D, 3 * D), "proj": (T, D, D),
            "fc1": (T, D, 2 * c.mlp_hidden), "fc2": (T, c.mlp_hidden, D),
            "head": (batch, D, c.num_classes)}


@pytest.mark.parametrize("dtype,site,want", [
    (torch.float32, "qkv", "wgmma"), (torch.float32, "proj", "wgmma"),
    (torch.float32, "fc1", "wgmma"), (torch.float32, "fc2", "wgmma_codes"),
    (torch.float32, "head", "wgmma"),
    (torch.bfloat16, "qkv", "wgmma"), (torch.bfloat16, "proj", "wgmma"),
    (torch.bfloat16, "fc1", "mma"), (torch.bfloat16, "fc2", "wgmma_codes"),
    (torch.bfloat16, "head", "wgmma"),
])
def test_int8_eva02_sites_route(dtype, site, want):
    """eva02_large_448's sites at batch 64, x contiguous: fc2 (K = 2730)
    on "wgmma_codes", fc1's 5460 bf16 outputs a row (no multiple of 16
    bytes) on "mma", the rest on "wgmma"."""
    T, K, O = _eva02_site_shapes()[site]
    assert (T, K, O)[1:] == {"qkv": (1024, 3072), "proj": (1024, 1024),
                             "fc1": (1024, 5460), "fc2": (2730, 1024),
                             "head": (1024, 1000)}[site]
    assert int8_linear.int8_variant(T, K, O, K, 0, dtype) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("O", [1, 4, 8, 16, 130, 1000, 1001, 1004, 5460])
def test_int8_wgmma_codes_refusal(rng, O, dtype):
    """"wgmma_codes" takes exactly the calls whose output rows are a
    multiple of 16 bytes, whatever K and x's layout; where its refusal
    says no, a forced call raises naming it, on the CPU too, and
    launches nothing; elsewhere it runs (the plain version on the CPU)."""
    item = 4 if dtype == torch.float32 else 2
    for K, lda, mod16 in ((40, 40, 0), (2730, 2730, 8), (32, 33, 4),
                          (4096, 4096, 0)):
        why = int8_linear.wgmma_codes_refusal(5, K, O, lda, mod16, dtype)
        assert (why is None) == ((O * item) % 16 == 0)
        if why is None:
            assert int8_linear.int8_variant(5, K, O, lda, mod16, dtype,
                                            "wgmma_codes") == "wgmma_codes"
        else:
            assert "16-byte pieces" in why
            with pytest.raises(ValueError, match="'wgmma_codes' refused"):
                int8_linear.int8_variant(5, K, O, lda, mod16, dtype,
                                         "wgmma_codes")
    x = torch.from_numpy(_x(rng, 5, 40)).to(dtype)
    w = torch.from_numpy(rng.integers(-7, 8, (O, 40)).astype(np.int8))
    prm, s = torch.tensor([0.07, 7.0]), torch.rand(O)
    launches = dict(int8_linear.int8_gemm.variant_launches)
    if (O * item) % 16:
        with pytest.raises(ValueError, match="'wgmma_codes' refused"):
            int8_linear.int8_gemm(x, w, prm, s, bits=4,
                                  variant="wgmma_codes")
    else:
        assert torch.equal(
            int8_linear.int8_gemm(x, w, prm, s, bits=4,
                                  variant="wgmma_codes"),
            int8_linear.int8_gemm_plain(x, w, prm, s, bits=4))
    assert int8_linear.int8_gemm.variant_launches == launches


@pytest.mark.parametrize("K", [12, 32, 40, 2730])
def test_int8_site_weights_padded_storage(rng, K):
    """site_weights keeps a site's codes in a zero-padded (O, roundup(K,
    16)) buffer: w_int is weight_codes' output, shape, dtype and codes,
    its rows 16-byte aligned, the pad 0."""
    _, site = _site(rng, 12)
    _, lin = _linear(rng, 12, K)
    want, _ = int8_linear.weight_codes(lin.weight, site)
    hit = int8_linear.site_weights(lin.weight, site)
    assert hit.w_int.dtype == torch.int8 and hit.w_int.shape == want.shape
    assert torch.equal(hit.w_int, want)
    pitch = -(-K // 16) * 16
    assert hit.w_int.stride() == (pitch, 1)
    assert hit.w_int.is_contiguous() == (K % 16 == 0)
    whole = torch.as_strided(hit.w_int, (12, pitch), (pitch, 1))
    assert not whole[:, K:].any()


@pytest.mark.parametrize("T", [1, 32, 63, 64, 65, 294912])
def test_int8_wgmma_takes_any_row_count(T):
    """T takes no part in the routing: a partial last row tile is computed
    and never stored; K up to the resident limit is taken."""
    for K in (16, 96, 384, int8_linear.WGMMA_K_MAX):
        assert int8_linear.int8_variant(T, K, 1000, K, 0,
                                        torch.bfloat16) == "wgmma"


def test_int8_variant_argument(rng):
    """variant= takes "auto", "wgmma" or "mma"; anything else raises, on
    the CPU too; a forced "wgmma" the call's shape refuses raises on the
    CPU as on the card; every accepted variant runs the plain version on CPU
    tensors and launches nothing."""
    x = torch.from_numpy(_x(rng, 5, 32))
    w = torch.from_numpy(rng.integers(-7, 8, (16, 32)).astype(np.int8))
    prm, s = torch.tensor([0.07, 7.0]), torch.rand(16)
    want = int8_linear.int8_gemm_plain(x, w, prm, s, bits=4)
    launches = dict(int8_linear.int8_gemm.variant_launches)
    for v in int8_linear.VARIANTS:
        assert torch.equal(int8_linear.int8_gemm(x, w, prm, s, bits=4,
                                                 variant=v), want)
    assert int8_linear.int8_gemm.variant_launches == launches
    with pytest.raises(ValueError, match="variant"):
        int8_linear.int8_gemm(x, w, prm, s, bits=4, variant="fma")
    with pytest.raises(ValueError, match="variant"):
        int8_linear.int8_variant(5, 32, 16, 32, 0, torch.float32, "cuda")
    with pytest.raises(ValueError, match="'wgmma' refused"):
        int8_linear.int8_gemm(x[:, :24], w[:, :24], prm, s, bits=4,
                              variant="wgmma")
    strided = torch.from_numpy(_x(rng, 5, 66))[:, :33]     # lda 66, K 33
    with pytest.raises(ValueError, match="'wgmma' refused"):
        int8_linear.int8_gemm(strided, w.repeat(1, 2)[:, :33], prm, s,
                              bits=4, variant="wgmma")
    assert torch.equal(
        int8_linear.int8_gemm(strided, w.repeat(1, 2)[:, :33], prm, s,
                              bits=4, variant="mma"),
        int8_linear.int8_gemm_plain(strided, w.repeat(1, 2)[:, :33], prm, s,
                                    bits=4))


def test_int8_cpu_table_has_no_tensor_map(rng):
    """The tensor map is built on the card only: a CPU table's entries carry
    none, and weight_map refuses a CPU tensor."""
    _, site = _site(rng, 12)
    _, lin = _linear(rng, 12, 32)
    hit = int8_linear.site_weights(lin.weight, site)
    assert hit.w_map is None and hit.w_int.is_contiguous()
    with pytest.raises(RuntimeError, match="CUDA"):
        int8_linear.weight_map(hit.w_int)
