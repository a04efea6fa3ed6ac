"""The port's per-site error report (utils/diagnostics.py) against the JAX
package's on the CPU: test_tiny at W4A4 with the init_qstate of both
packages (no calibration, so it is quick), on the same numpy weights and
images. The same rows (one a site, in the qstate's order), the same kinds,
and every error
within REL_TOL relative of JAX's: both forwards quantize alike, their fp32
products sum in other orders."""

import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adalog_tpu.calib.init_state import init_qstate as j_init_qstate
from adalog_tpu.calib.layout import quant_layout as j_quant_layout
from adalog_tpu.models.zoo import build_model as j_build_model
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu.utils.diagnostics import site_error_report as j_report
from adalog_tpu_torch.calib.layout import quant_layout
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.diagnostics import log_report, site_error_report
from adalog_tpu_torch.utils.interop import from_jax

torch.set_num_threads(2)

W4A4 = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)
REL_TOL = 1e-5
MODES = ("w_only", "a_only", "quant")


@pytest.fixture(scope="module")
def reports():
    spec_j, params = j_build_model("test_tiny", seed=0)
    qstate = j_init_qstate(spec_j, JConfig(**W4A4), params)
    batches = [np.random.default_rng(1).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)]
    want = j_report(spec_j, params, qstate,
                    j_quant_layout(spec_j, JConfig(**W4A4)), batches)
    spec = zoo.model_spec("test_tiny")
    model, tq = from_jax(spec.cfg, jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, qstate))
    got = site_error_report(spec, model, tq, quant_layout(spec,
                                                          Config(**W4A4)),
                            batches)
    return got, want, tq


def test_report_rows_and_kinds_match_jax(reports):
    got, want, tq = reports
    assert {r["site"]: r["kind"] for r in got} == \
        {r["site"]: r["kind"] for r in want}
    assert [r["site"] for r in got] == list(tq)
    kinds = {r["kind"] for r in got}
    assert {"conv", "linear", "postgelu"} <= kinds, kinds


def test_report_errors_match_jax(reports):
    got, want, _ = reports
    want = {r["site"]: r for r in want}
    for g in got:
        w = want[g["site"]]
        for mode in MODES:
            if w[mode] is None:
                assert g[mode] is None, (g["site"], mode)
                continue
            assert isinstance(g[mode], float)
            np.testing.assert_allclose(g[mode], w[mode], rtol=REL_TOL,
                                       atol=0, err_msg=f"{g['site']} {mode}")
    assert any(r["quant"] > 0 for r in got if r["w_only"] is not None)


def test_log_report_lists_the_worst_sites(reports, caplog):
    got, _, _ = reports
    with caplog.at_level(logging.INFO, logger="adalog_tpu_torch"):
        log_report(got, top=3)
    worst = max(got, key=lambda r: r["quant"])
    lines = caplog.text.splitlines()
    assert len(lines) == 4 and worst["site"] in lines[1], caplog.text
