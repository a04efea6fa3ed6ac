"""The port's serving slice with the fused activation-quant GEMM dispatch
(ops/fq_gemm.py) against adalog_tpu, on the CPU at test_tiny size.

Under a plan with the GEMM switch on every supported Linear site runs
through ``fq_gemm`` (its plain version on the CPU); logits are held to the JAX
package's quantized logits (its unfused path) at LOGIT_TOL, and a call
counter shows which sites took the route.
"""

import numpy as np
import pytest
import torch

from adalog_tpu.calib.init_state import init_qstate as j_init_qstate
from adalog_tpu.utils import checkpoint as j_checkpoint
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu_torch.models.vit import vit_forward
from adalog_tpu_torch.ops import fq_gemm, routes, weight_prep
from adalog_tpu_torch.serve import load_quantized
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.interop import from_jax, qstate_from_tree
from test_torch_vit_serve import (  # noqa: F401 (fixtures)
    LOGIT_TOL, SPEC, W4A4, _images, _jax_logits, _np_tree, jax_calibrated,
    jax_model,
)

torch.set_num_threads(1)

DEPTH = SPEC.cfg.depth


def _gemm_table(model, tq, **kw):
    """(plan with the GEMM switch on, {site: GemmSite} of its K4 routes)."""
    plan = routes.build(SPEC, model, tq, Config(**W4A4),
                        use_gemm_kernels=True, **kw)
    return plan, {n: r.gemm for n, r in plan.linear.items()
                  if r.kind == "fq_gemm"}


def _gemm_logits(model, tq, x):
    """Quantized logits under the plan of ``tq`` with the GEMM switch on;
    returns (logits, fq_gemm calls in the forward, its K4 sites)."""
    plan, table = _gemm_table(model, tq)
    before = fq_gemm.fq_gemm.calls
    with torch.no_grad(), routes.activate(plan):
        y = vit_forward(SPEC.cfg, model, torch.from_numpy(x), tq,
                        {"*": "quant"}).numpy()
    return y, fq_gemm.fq_gemm.calls - before, table


def test_gemm_dispatch_logits_match_jax(jax_calibrated):
    """JAX-calibrated state (folded fc2 bias): all 4*depth+1 Linear sites
    take fq_gemm, fc2 as adalog_shift, and the logits are JAX's."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    x = _images(12)
    y, calls, table = _gemm_logits(model, tq, x)
    assert calls == len(table) == 4 * DEPTH + 1
    assert {k for k, site in table.items()
            if site.kind == "adalog_shift"} == \
        {f"blocks.{i}.mlp.fc2" for i in range(DEPTH)}
    np.testing.assert_allclose(y, _jax_logits(params, x, qstate,
                                              {"*": "quant"}),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_unfolded_fc2_stays_plain(jax_model):
    """Without the bias fold the shifted AdaLog fc2 sites keep the plain
    path; the other 3*depth+1 sites take fq_gemm."""
    model, _ = from_jax(SPEC.cfg, jax_model)
    jq = _np_tree(j_init_qstate(SPEC, JConfig(**W4A4), jax_model))
    tq = qstate_from_tree(jq)
    x = _images(13)
    y, calls, table = _gemm_logits(model, tq, x)
    assert calls == len(table) == 3 * DEPTH + 1
    assert not any(k.endswith("fc2") for k in table)
    np.testing.assert_allclose(y, _jax_logits(jax_model, x, jq,
                                              {"*": "quant"}),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("eval_dtype", ["float32", "bfloat16"])
def test_load_quantized_gemm_switch(jax_calibrated, tmp_path, eval_dtype):
    """Config(use_pallas_gemm=True) routes every Linear site through
    fq_gemm and serves the logits of the same call with it off."""
    params, qstate = jax_calibrated
    path = str(tmp_path / "jax.ckpt")
    j_checkpoint.save_checkpoint(path, params, qstate, {"model": "test_tiny"})
    x = _images(14)
    out = {}
    for on in (False, True):
        predict, *_ = load_quantized(
            "test_tiny", path, config=Config(**W4A4, use_pallas_gemm=on),
            device="cpu", eval_dtype=eval_dtype)
        before = fq_gemm.fq_gemm.calls
        out[on] = predict(x).numpy()
        assert fq_gemm.fq_gemm.calls - before == (4 * DEPTH + 1 if on else 0)
        assert out[on].shape == (8, 10) and np.isfinite(out[on]).all()
    if eval_dtype == "float32":
        np.testing.assert_allclose(out[True], out[False], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        np.testing.assert_allclose(
            out[True], _jax_logits(params, x, qstate, {"*": "quant"}),
            rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("log_q, ok", [(29.0, True), (1108378.0, True),
                                       (29.5, False), (0.0, False),
                                       (1118482.0, False)])
def test_prepare_checks_adalog_base(jax_calibrated, log_q, ok):
    """The kernel's AdaLog quantizer needs an integer base q >= 1 with
    (2^bits - 1) * q < 2^24 (at 4 bits: q <= 1118481); ``gemm_site`` reads
    each fc2 base once where the plan is built and raises for any other."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    tq["blocks.0.mlp.fc2"].aq.log_q = torch.tensor(log_q)
    if ok:
        assert _gemm_table(model, tq)[1]["blocks.0.mlp.fc2"].params[3] \
            == log_q
    else:
        with pytest.raises(ValueError, match="blocks.0.mlp.fc2"):
            _gemm_table(model, tq)


def _mma_formulation(site, x, w, bias=None):
    """``fq_gemm.run`` with variant "mma"'s fp32 formulation in plain
    PyTorch in the kernel's place: what a CUDA launch of the site computes."""
    assert site.mma_fp32 and site.variant(x.dtype) == "mma"
    fq_gemm.fq_gemm.calls += 1
    return fq_gemm._gemm_mma_plain(x, w, site.params, bias, kind=site.kind,
                                   bits=site.bits, codes=site.codes)


def test_weight_codes_table_matches_prepared_weights(jax_calibrated):
    """weight_codes gives every Linear site of the W4A4 model (qkv with
    n_V = 3 among them) codes exact in bf16 whose product with the row
    scales is the prepared weight bit for bit; the fp32 plan routes every
    site to "mma" in both dtypes with them, and the bf16 plan, which builds
    none, fp32 to "fma"."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    plan, table = _gemm_table(model, tq)
    assert len(table) == len(plan.linear) == 4 * DEPTH + 1
    assert tq["blocks.0.attn.qkv"].n_V == 3
    for name, route in plan.linear.items():
        c = weight_prep.weight_codes(model.get_submodule(name).weight,
                                     tq[name])
        assert c.codes.dtype == torch.bfloat16
        assert torch.equal(c.codes.float() * c.scale[:, None], route.weight)
        assert torch.equal(route.gemm.codes.codes, c.codes)
    for site in table.values():
        assert site.mma_fp32 and site.codes is not None
        assert site.variant(torch.float32) == "mma"
        assert site.variant(torch.bfloat16) == "mma"
    for site in _gemm_table(model, tq, dtype=torch.bfloat16)[1].values():
        assert not site.mma_fp32 and site.codes is None
        assert site.variant(torch.float32) == "fma"
        assert site.variant(torch.bfloat16) == "mma"


@pytest.mark.parametrize("what,value", [("a_bits", 9), ("fc2_bits", 8),
                                        ("zero_point", 400.0),
                                        ("w_zero_point", 7.5)])
def test_inexact_sites_stay_on_fma(jax_calibrated, what, value):
    """A site whose fp32 integers are not exact in bf16 (9-bit activations,
    8-bit AdaLog, a zero point of 400, a fractional AdaRound zero point)
    keeps variant "fma" for fp32 inputs; the other sites take "mma"."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    name = "blocks.0.mlp.fc2" if what == "fc2_bits" else "blocks.0.attn.proj"
    site = tq[name]
    if what in ("a_bits", "fc2_bits"):
        site.aq.bits = value
    elif what == "zero_point":
        site.aq.zero_point = torch.full_like(site.aq.zero_point, value)
    else:
        w = model.get_submodule(name).weight
        site.wq.alpha = torch.zeros_like(w).reshape(site.n_V, -1, w.shape[1])
        site.wq.zero_point = torch.full_like(site.wq.zero_point, value)
    table = _gemm_table(model, tq)[1]
    assert {k for k, s in table.items() if not s.mma_fp32} == {name}
    assert table[name].variant(torch.float32) == "fma"
    assert (table[name].codes is None) == (what == "w_zero_point")


def test_gemm_dispatch_mma_formulation_matches_jax(jax_calibrated,
                                                   monkeypatch):
    """The whole fp32 forward with every Linear site computed as variant
    "mma" computes it (integer operands from the table's codes, scaled
    sums): the JAX package's logits at LOGIT_TOL."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    x = _images(15)
    plan, _ = _gemm_table(model, tq)
    monkeypatch.setattr(fq_gemm, "run", _mma_formulation)
    before = fq_gemm.fq_gemm.calls
    with torch.no_grad(), routes.activate(plan):
        y = vit_forward(SPEC.cfg, model, torch.from_numpy(x), tq,
                        {"*": "quant"}).numpy()
    assert fq_gemm.fq_gemm.calls - before == 4 * DEPTH + 1
    np.testing.assert_allclose(y, _jax_logits(params, x, qstate,
                                              {"*": "quant"}),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
