"""K6's wrapper (adalog_tpu_torch/ops/fq_act.py) on the CPU: which sites
a predictor's plan sends to it, the parameters it prepares from PyTorch's own evaluation
(the AdaLog table, k = 37 / q, the rounded zero point, the shift-back
term), the input layouts it reads, and the routing in ``qlinear``: a CPU
tensor, training and soft rounding never reach the kernel, and importing
the module builds nothing. The kernel itself is held to
``apply_quantizer`` on the card (tests/test_torch_fq_act_cuda.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from adalog_tpu_torch.calib.init_state import init_qstate
from adalog_tpu_torch.models import layers, zoo
from adalog_tpu_torch.models.layers import LinearSite
from adalog_tpu_torch.ops import fq_act, routes
from adalog_tpu_torch.quantizers.apply import apply_quantizer
from adalog_tpu_torch.quantizers.logarithm import adalog_dequant_code
from adalog_tpu_torch.quantizers.state import GELU_MIN, QuantizerState
from adalog_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(**cfg_kw):
    spec, model = zoo.build_model("test_tiny", seed=0)
    cfg = Config(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4, **cfg_kw)
    return spec, model, cfg, init_qstate(spec, cfg, model)


def _linear(qstate):
    return {n for n, s in qstate.items() if isinstance(s, LinearSite)}


def _k6(model, qstate, **kw):
    """{site: ActSite} of the Linear sites a predictor's plan sends to K6."""
    plan = routes.build(zoo.model_spec("test_tiny"), model, qstate, **kw)
    return {n: r.act for n, r in plan.linear.items() if r.kind == "fq_act"}


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def test_prepare_takes_every_served_linear_site():
    _, model, _, qstate = _tiny()
    table = _k6(model, qstate)
    assert set(table) == _linear(qstate)
    kinds = {n: s.kind for n, s in table.items()}
    assert {n for n, k in kinds.items() if k == "adalog"} == \
        {n for n in table if n.endswith("mlp.fc2")}
    for n, s in table.items():
        assert s.qs is qstate[n].aq
        assert s.code == (2 if s.kind == "adalog" else 0)


@pytest.mark.parametrize("post", ["log2", "logsqrt2", "ptq4vit"])
def test_prepare_leaves_other_kinds_eager(post):
    """log2, logsqrt2 and twin (PTQ4ViT) post-GeLU sites stay on
    apply_quantizer; every other Linear site is taken."""
    _, model, _, qstate = _tiny(post_gelu_quantizer=post)
    table = _k6(model, qstate)
    fc2 = {n for n in _linear(qstate) if n.endswith("mlp.fc2")}
    assert fc2 and set(table) == _linear(qstate) - fc2
    for n in fc2:
        assert "kind" in fq_act.refusal(qstate[n].aq)


@pytest.mark.parametrize("change,why", [
    (lambda aq: setattr(aq, "scale", torch.ones(1, 1, 8)), "per-channel"),
    (lambda aq: setattr(aq, "zero_point", torch.zeros(3)), "per-channel"),
    (lambda aq: setattr(aq, "bits", 32), "bits"),
    (lambda aq: setattr(aq, "bits", 9), "bits"),
    (lambda aq: setattr(aq, "scale", torch.ones(1, dtype=torch.float64)),
     "promote"),
])
def test_prepare_refuses_a_uniform_site(change, why):
    _, model, _, qstate = _tiny()
    name = "blocks.0.attn.qkv"
    change(qstate[name].aq)
    assert why in fq_act.refusal(qstate[name].aq)
    assert fq_act.act_site(qstate[name].aq) is None
    assert set(_k6(model, qstate)) == _linear(qstate) - {name}


def test_prepare_refuses_per_channel_adalog_and_skips():
    """A per-channel AdaLog site stays eager; the sites K4 takes skip K6."""
    _, model, _, qstate = _tiny()
    name = "blocks.1.mlp.fc2"
    qstate[name].aq.log_q = torch.full((4,), 20.0)
    assert "per-channel" in fq_act.refusal(qstate[name].aq)
    gemm = {n for n in _linear(qstate) if not n.endswith("mlp.fc2")}
    assert set(_k6(model, qstate)) == _linear(qstate) - {name}
    assert set(_k6(model, qstate, use_gemm_kernels=True)) == \
        _linear(qstate) - {name} - gemm


@pytest.mark.parametrize("scale", [0.0, -0.5, float("inf"), 1e-39])
def test_prepare_refuses_a_scale_that_is_not_positive_normal(scale):
    _, model, _, qstate = _tiny()
    name = "blocks.0.mlp.fc1"
    qstate[name].aq.scale = torch.tensor([scale])
    assert fq_act.refusal(qstate[name].aq) is None
    assert fq_act.site_params(qstate[name].aq) is None
    assert fq_act.act_site(qstate[name].aq) is None
    assert name not in _k6(model, qstate)


def test_prepare_skips_the_int8_sites():
    """With eval_int8 only the AdaLog fc2 sites are left to K6."""
    spec, model, cfg, qstate = _tiny()
    plan = routes.build(spec, model, qstate, cfg, use_int8=True)
    int8 = {n for n, r in plan.linear.items() if r.kind == "int8"}
    table = _k6(model, qstate, use_int8=True)
    assert set(table) == {n for n in _linear(qstate)
                          if n.endswith("mlp.fc2")}
    assert not set(table) & int8 and set(table) | int8 == _linear(qstate)


def _adalog(q, bits, scale=1.0, shifted=False, reparamed=False):
    return QuantizerState(
        scale=torch.tensor([scale]), log_q=torch.tensor(float(q)),
        shift=torch.tensor([GELU_MIN]) if shifted else None,
        bias_reparamed=torch.tensor(reparamed) if shifted else None,
        kind="adalog", bits=bits, shifted=shifted)


@pytest.mark.parametrize("scale", [1.0, 0.37])
@pytest.mark.parametrize("bits", [3, 4, 6, 8])
def test_adalog_table_is_the_dequantized_codes(bits, scale):
    """The table holds adalog_dequant_code of each code 0..2N-1 times the
    scale, for every base q, bit for bit."""
    N2 = 2 ** bits
    code = torch.arange(N2, dtype=torch.float32)
    for q in range(1, 37):
        p = fq_act.site_params(_adalog(q, bits, scale))
        want = adalog_dequant_code(code, torch.tensor(float(q)), bits=bits) \
            * torch.tensor([scale])
        assert p.n_table == N2
        np.testing.assert_array_equal(_bits(p.table[:N2]),
                                      _bits(want.numpy()))
        assert not any(p.table[N2:])


def test_k_is_the_eager_r_over_q():
    """k = 37 / q as the eager chain forms it (``q.reciprocal() * 37``),
    bit for bit, for every base."""
    for q in range(1, 37):
        p = fq_act.site_params(_adalog(q, 4))
        want = (37.0 / torch.tensor(float(q))).numpy()
        assert _bits(p.k) == _bits(want), q


@pytest.mark.parametrize("reparamed", [False, True])
def test_shift_and_shift_back(reparamed):
    p = fq_act.site_params(_adalog(20, 4, 2.5, shifted=True,
                                   reparamed=reparamed))
    assert p.shifted == 1
    assert _bits(p.shift) == _bits(GELU_MIN)
    assert p.back == (0.0 if reparamed else p.shift)


@pytest.mark.parametrize("zp,want", [(2.5, 2.0), (3.5, 4.0), (-1.5, -2.0),
                                     (7.0, 7.0), (0.3, 0.0)])
def test_uniform_params(zp, want):
    qs = QuantizerState(scale=torch.tensor([0.05]),
                        zero_point=torch.tensor([zp]), kind="uniform",
                        bits=4)
    p = fq_act.site_params(qs)
    assert (p.zp, p.lo, p.hi, p.shifted) == (want, 0, 15, 0)
    assert _bits(p.scale) == _bits(0.05)
    sym = QuantizerState(scale=torch.tensor([0.05]), kind="uniform", bits=4,
                         symmetric=True)
    assert fq_act.act_site(sym).code == 1
    p = fq_act.site_params(sym)
    assert (p.lo, p.hi) == (-8, 7)


@pytest.mark.parametrize("make,want", [
    (lambda: torch.zeros(4, 5, 6), (1, 120, 120)),
    (lambda: torch.zeros(4, 197, 384)[:, 0], (4, 384, 197 * 384)),
    (lambda: torch.zeros(4, 5, 6)[:, :, :5], (20, 5, 6)),
    (lambda: torch.zeros(12, 8)[::3], (4, 8, 24)),
    (lambda: torch.zeros(4, 6, 8)[::2, 1:3], None),
    (lambda: torch.zeros(4, 6, 8)[:, ::2], (12, 8, 16)),
    (lambda: torch.zeros(1, 5, 6)[:, ::2], (3, 6, 12)),
    (lambda: torch.zeros(4, 5, 6)[:, :3], None),
    (lambda: torch.zeros(5, 6).t(), None),
    (lambda: torch.zeros(12)[::2], None),
])
def test_row_layout(make, want):
    x = make()
    assert fq_act.row_layout(x) == want


def test_act_quant_sends_a_table_site_to_the_wrapper():
    """A site's ActSite goes to K6's wrapper, which runs apply_quantizer for
    a CPU tensor and launches nothing; without one the same site stays on
    apply_quantizer."""
    _, model, _, qstate = _tiny()
    name = "blocks.1.mlp.fc2"
    qs = qstate[name].aq
    x = torch.randn(2, 5, 128)
    act = _k6(model, qstate)[name]
    calls, launches = fq_act.fq_act_quant.calls, fq_act.fq_act_quant.launches
    y = layers._act_quant(qs, x, False, act)
    layers._act_quant(qs, x, True)
    layers._act_quant(qs, x, False)
    assert fq_act.fq_act_quant.calls == calls + 1
    assert fq_act.fq_act_quant.launches == launches
    assert torch.equal(y, apply_quantizer(qs, x))


def test_plain_version_is_apply_quantizer_on_the_cpu():
    qs = _adalog(20, 4, 2.5, shifted=True)
    site = fq_act.act_site(qs)
    x = torch.randn(6, 10)
    calls, launches = fq_act.fq_act_quant.calls, fq_act.fq_act_quant.launches
    assert torch.equal(fq_act.fq_act_quant(site, x), apply_quantizer(qs, x))
    assert fq_act.fq_act_quant.calls == calls + 1
    assert fq_act.fq_act_quant.launches == launches
    with pytest.raises(RuntimeError, match="no path"):
        fq_act.fq_act_quant(site, torch.zeros(2, 2, device="meta"))


def test_lookup_needs_the_same_state():
    """A route asked for with another quantizer state, another weight shape
    or no name raises: its parameters would not be that site's. Under no
    plan ``qlinear`` reads no route."""
    spec, model, _, qstate = _tiny()
    plan = routes.build(spec, model, qstate)
    name = "blocks.0.attn.qkv"
    w = model.get_submodule(name).weight
    route = plan.route(name, qstate[name], w)
    assert route.act.qs is qstate[name].aq and route.kind == "fq_act"
    with pytest.raises(RuntimeError, match="another model or state"):
        plan.route(name, qstate["head"], w)
    with pytest.raises(RuntimeError, match="another model or state"):
        plan.route(name, qstate[name], w[:, :4])
    with pytest.raises(RuntimeError, match="another model or state"):
        plan.route(None, qstate[name], w)
    x = torch.randn(2, 5, w.shape[1])
    p = model.get_submodule(name)
    with routes.activate(plan), pytest.raises(RuntimeError,
                                              match="another model"):
        layers.qlinear(p, qstate["head"], x, mode="quant", name=name)
    assert routes.current() is None
    with routes.activate(plan):
        y = layers.qlinear(p, qstate[name], x, mode="quant", name=name)
    assert torch.equal(y, layers.qlinear(p, qstate[name], x, mode="quant",
                                         name=name))


@pytest.mark.parametrize("training,soft,hit", [
    (False, False, True), (True, False, False), (False, True, False),
    (True, True, False)])
def test_qlinear_routing(monkeypatch, training, soft, hit):
    """A table site reaches the kernel's wrapper outside training and soft
    rounding only; elsewhere apply_quantizer runs, in the same span."""
    _, model, _, qstate = _tiny()
    name = "blocks.0.mlp.fc1"
    site = qstate[name]
    p = model.get_submodule(name)
    x = torch.randn(2, 5, p.in_features)
    got = []
    monkeypatch.setattr(fq_act, "fq_act_quant",
                        lambda s, x: got.append(s) or apply_quantizer(s.qs, x))
    plan = routes.build(zoo.model_spec("test_tiny"), model, qstate)
    with routes.activate(plan):
        y = layers.qlinear(p, site, x, mode="quant", training=training,
                           soft=soft, name=name)
    assert got == ([plan.linear[name].act] if hit else [])
    want = layers.qlinear(p, site, x, mode="quant", training=training,
                          soft=soft, name=name)
    assert torch.equal(y, want)


def test_cpu_predictor_builds_the_table_and_never_launches(monkeypatch):
    """A CPU predictor builds its plan (every Linear site on K6; only the
    fc2 sites with eval_int8) and sends each of its K6 sites once a forward
    to K6's wrapper, which runs apply_quantizer: no kernel launch."""
    spec, model, cfg, qstate = _tiny()
    from adalog_tpu_torch.serve import make_predictor

    built = []
    real = routes.build

    def spy(*a, **k):
        plan = real(*a, **k)
        built.append({n for n, r in plan.linear.items()
                      if r.kind == "fq_act"})
        return plan

    monkeypatch.setattr(routes, "build", spy)
    x = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    calls, launches = fq_act.fq_act_quant.calls, fq_act.fq_act_quant.launches
    y = make_predictor(spec, model, qstate, device="cpu")(x)
    y8 = make_predictor(spec, model, qstate, device="cpu", use_int8=True)(x)
    assert set(built[0]) == _linear(qstate)
    assert set(built[1]) == {n for n in _linear(qstate)
                             if n.endswith("mlp.fc2")}
    assert fq_act.fq_act_quant.launches == launches
    assert fq_act.fq_act_quant.calls == calls + len(built[0]) + len(built[1])
    assert y.shape == y8.shape == (2, spec.cfg.num_classes)


GUARD = """
import sys
from adalog_tpu_torch.ops import cuda_build

def boom(*a, **k):
    raise AssertionError("built a kernel at import")

cuda_build.build = cuda_build.library = boom
import adalog_tpu_torch.ops.fq_act
import adalog_tpu_torch.models.layers
import adalog_tpu_torch.serve
import chip_smoke
print("built nothing")
"""


def test_import_builds_nothing():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "built nothing" in out.stdout
