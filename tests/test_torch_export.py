"""The port's export (utils/export.py, torch.export) on the CPU: the
serialized forward round-trips to the live port forward within the JAX
package's own round-trip tolerance, and to the JAX package's forward
within the serving tests' LOGIT_TOL, on test_tiny (W6A6, as
tests/test_export.py, and W4A4) and test_tiny_swin."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adalog_tpu.calib.init_state import init_qstate as j_init_qstate
from adalog_tpu.models.zoo import build_model as j_build_model
from adalog_tpu.models.zoo import model_forward_fn as j_forward_fn
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.utils.export import (
    export_quantized, load_exported, make_serving_fn,
)
from adalog_tpu_torch.utils.interop import from_jax

torch.set_num_threads(2)

ROUND_TRIP_TOL = 1e-5        # tests/test_export.py's
LOGIT_TOL = 1e-5             # tests/test_torch_vit_serve.py's


def _state(name, bits):
    spec_j, params = j_build_model(name, seed=0)
    cfg = dict(w_bit=bits, a_bit=bits, s_bit=bits, qhead_a_bit=bits)
    qstate = j_init_qstate(spec_j, JConfig(**cfg), params)
    spec = zoo.model_spec(name)
    model, tq = from_jax(spec.cfg, jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, qstate))
    return spec_j, params, qstate, spec, model, tq


@pytest.mark.parametrize("name,bits", [("test_tiny", 6), ("test_tiny", 4),
                                       ("test_tiny_swin", 4)])
def test_export_roundtrip(name, bits):
    spec_j, params, qstate, spec, model, tq = _state(name, bits)
    x = np.random.default_rng(2).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    live = make_serving_fn(spec, model, tq, device="cpu")
    with torch.no_grad():
        want = live(torch.from_numpy(x)).numpy()
    blob = export_quantized(spec, model, tq, batch_size=4, device="cpu")
    assert isinstance(blob, bytes) and len(blob) > 1000
    got = load_exported(blob)(x)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=ROUND_TRIP_TOL,
                               atol=ROUND_TRIP_TOL)
    fwd = j_forward_fn(spec_j)
    j_want = np.asarray(jax.jit(lambda p, xx, q: fwd(
        spec_j.cfg, p, xx, q, {"*": "quant"}))(params, jnp.asarray(x),
                                              qstate))
    np.testing.assert_allclose(got.numpy(), j_want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    # the live module after the trace still computes real values
    with torch.no_grad():
        assert np.array_equal(live(torch.from_numpy(x)).numpy(), want)


def test_export_bf16_keeps_the_callers_module():
    _, _, _, spec, model, tq = _state("test_tiny", 4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    blob = export_quantized(spec, model, tq, batch_size=2,
                            eval_dtype="bfloat16", device="cpu")
    live = make_serving_fn(spec, model, tq, eval_dtype="bfloat16",
                           device="cpu")
    with torch.no_grad():
        want = live(torch.from_numpy(x))
    got = load_exported(blob)(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k


def test_export_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, _, spec, model, tq = _state("test_tiny", 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_quantized(spec, model, tq, batch_size=2)
