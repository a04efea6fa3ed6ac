"""The predictor's route table (adalog_tpu_torch/ops/routes.py) on the CPU:
which kernel each quantized site of a served model takes, by the one
precedence int8 > K4 > K6 > eager, with the counts the benchmark's cells
and chip_smoke.py assert on the card; the row-parallel sites of a tp rank;
and each family's forward under a plan against the same forward through
the plain tiers.
"""

import numpy as np
import pytest
import torch

from adalog_tpu_torch.calib.init_state import init_qstate
from adalog_tpu_torch.calib.reparam import fold_gelu_shift_into_bias
from adalog_tpu_torch.calib.layout import tree_get, tree_set
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.models.layers import LinearSite
from adalog_tpu_torch.ops import fq_attn, routes
from adalog_tpu_torch.parallel.tp import make_tp_plan
from adalog_tpu_torch.utils.config import Config

torch.set_num_threads(2)

W4A4 = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)
# logits through K1's plain version against the unfused path's ops
LOGIT_TOL = 1e-5


def _served_state(name):
    """(spec, model, qstate) of ``name`` at W4A4 with random weights and
    the post-GeLU shift folded into each fc2 bias, as a finished
    calibration leaves it (and as the benchmark builds its state)."""
    spec, model = zoo.build_model(name, seed=0)
    cfg = Config(**W4A4)
    qstate = init_qstate(spec, cfg, model)
    with torch.no_grad():
        for nm, site in qstate.items():
            if isinstance(site, LinearSite) and site.aq.shifted:
                path = tuple(int(p) if p.isdigit() else p
                             for p in nm.split("."))
                lin = fold_gelu_shift_into_bias(
                    tree_get(model, path), site,
                    shift=float(site.aq.shift.reshape(-1)[0]))
                model = tree_set(model, path, lin)
                site.aq.bias_reparamed = torch.ones((), dtype=torch.bool)
    return spec, model, qstate


@pytest.fixture(scope="module")
def deit_small():
    return _served_state("deit_small")


def _kinds(plan):
    """{route kind (K6 split by quantizer kind): count}."""
    out = {}
    for r in plan.linear.values():
        key = f"fq_act.{r.act.kind}" if r.kind == "fq_act" else r.kind
        out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("switches,want", [
    ({}, {"fq_act.adalog": 12, "fq_act.uniform": 37}),
    ({"use_int8": True}, {"int8": 37, "fq_act.adalog": 12}),
    ({"use_gemm_kernels": True}, {"fq_gemm": 49}),
    ({"use_int8": True, "use_gemm_kernels": True},
     {"int8": 37, "fq_gemm": 12}),
    ({"use_kernels": False}, {"fq_act.adalog": 12, "fq_act.uniform": 37}),
])
def test_deit_small_routes(deit_small, switches, want):
    """deit_small's 49 Linear sites, as PERF.md's cells count them: every
    one on K6 (12 AdaLog fc2, 37 uniform); with int8 the 37 uniform ones
    on K5 and the AdaLog fc2 left to K6; with the GEMM switch all 49 on K4
    and none on K6; int8 ahead of K4 with both. The attention kernels are
    on with either kernel switch."""
    spec, model, qstate = deit_small
    plan = routes.build(spec, model, qstate, Config(**W4A4), **switches)
    assert _kinds(plan) == want
    assert plan.attn == (switches.get("use_kernels", True)
                         or switches.get("use_gemm_kernels", False))
    assert len(plan.attn_params) == (24 if plan.attn else 0)
    for name, r in plan.linear.items():
        assert r.site is qstate[name] and r.row is None
        assert (r.weight is None) == (r.kind == "int8")
        assert (r.int8 is not None) == (r.kind == "int8")
        assert (r.gemm is not None) == (r.kind == "fq_gemm")
        assert (r.act is not None) == (r.kind == "fq_act")
    if switches.get("use_gemm_kernels"):
        assert all(r.gemm.mma_fp32 for r in plan.linear.values()
                   if r.kind == "fq_gemm")


def test_eva_int8_takes_every_site():
    """test_tiny_eva has no post-GeLU site: with int8 every Linear site is
    an integer product and none is left to K6."""
    spec, model, qstate = _served_state("test_tiny_eva")
    plan = routes.build(spec, model, qstate, Config(**W4A4), use_int8=True)
    n = sum(isinstance(s, LinearSite) for s in qstate.values())
    assert _kinds(plan) == {"int8": n} and n == 4 * spec.cfg.depth + 1


@pytest.mark.parametrize("int8", [False, True])
def test_tp_row_sites_take_k6(deit_small, int8):
    """A tp=2 rank's row-parallel sites (proj, fc2) take neither int8 nor
    K4, and do take K6, with the rank's group; every other site keeps its
    route."""
    spec, model, qstate = deit_small
    rows = make_tp_plan(spec, qstate, 2).row_sites
    group = object()
    plan = routes.build(spec, model, qstate, Config(**W4A4),
                        use_gemm_kernels=True, use_int8=int8,
                        row_group=group, row_sites=rows)
    assert len(rows) == 24
    for name, r in plan.linear.items():
        if name in rows:
            assert r.kind == "fq_act" and r.row is group
        else:
            assert r.row is None
            assert r.kind == ("int8" if int8 and not name.endswith("fc2")
                              else "fq_gemm")
    assert _kinds(plan)["fq_act.adalog"] == 12


@pytest.mark.parametrize("name", ["test_tiny", "test_tiny_swin",
                                  "test_tiny_eva"])
def test_family_forward_under_a_plan_equals_the_plain_tiers(name):
    """Each family's quantized forward under a plan with the attention
    kernels on (K1 once an attention, every Linear site through its route)
    gives the logits of the same forward through the plain tiers, with no
    plan."""
    spec, model, qstate = _served_state(name)
    fwd = zoo.model_forward_fn(spec)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, spec.cfg.img_size, spec.cfg.img_size, 3)).astype(np.float32))
    plan = routes.build(spec, model, qstate, Config(**W4A4))
    calls = fq_attn.fq_flash_attn.calls
    with torch.no_grad(), routes.activate(plan):
        got = fwd(spec.cfg, model, x, qstate, {"*": "quant"})
    n_attn = sum(n.endswith("matmul1") for n in qstate)
    assert fq_attn.fq_flash_attn.calls - calls == n_attn > 0
    calls = fq_attn.fq_flash_attn.calls
    with torch.no_grad():
        want = fwd(spec.cfg, model, x, qstate, {"*": "quant"})
    assert fq_attn.fq_flash_attn.calls == calls
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_plan_is_read_only(deit_small):
    spec, model, qstate = deit_small
    plan = routes.build(spec, model, qstate, Config(**W4A4))
    with pytest.raises(TypeError):
        plan.linear["head"] = None
    with pytest.raises(AttributeError):
        plan.attn = False
