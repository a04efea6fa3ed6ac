"""The port's serving slice against adalog_tpu on the CPU, at test_tiny size
(img 32, patch 8, dim 32, depth 2, heads 2).

Weights go across with adalog_tpu_torch.utils.interop; logits of the port's
vit_forward are held to the JAX package's for the raw model, init_qstate,
and a JAX-calibrated state (FPCS search, LayerNorm reparam, folded post-GeLU
bias). Both packages quantize identically (see test_torch_quantizers.py),
so logits differ only by fp32 sum order in the GEMMs: LOGIT_TOL. Checkpoints
cross in both directions, and the paths the port does not have yet raise
(the Swin family's counterpart of this file is test_torch_swin.py).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adalog_tpu.calib.calibrator import QuantCalibrator
from adalog_tpu.calib.init_state import init_qstate as j_init_qstate
from adalog_tpu.models.vit import vit_forward as j_vit_forward
from adalog_tpu.models.vit import vit_init as j_vit_init
from adalog_tpu.utils import checkpoint as j_checkpoint
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu_torch.calib.init_state import init_qstate
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.models.load import load_vit, read_state_dict
from adalog_tpu_torch.models.vit import vit_forward
from adalog_tpu_torch.ops import fq_attn
from adalog_tpu_torch.ops.kernel_defaults import resolve_kernel_config
from adalog_tpu_torch.serve import load_quantized, make_predictor
from adalog_tpu_torch.utils import checkpoint
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.interop import from_jax, qstate_from_tree

torch.set_num_threads(1)

# fp32 logits of the two packages: GEMM sum order differs, quantizer math
# does not (measured max |diff| about 6e-8 on logits of magnitude 0.3)
LOGIT_TOL = 1e-5
W4A4 = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)
SPEC = zoo.model_spec("test_tiny")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, n=8):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_forward(mode):
    modes = None if mode is None else {"*": mode}
    return jax.jit(lambda p, x, q: j_vit_forward(SPEC.cfg, p, x, q, modes))


def _jax_logits(params, x, qstate=None, modes=None):
    mode = None if modes is None else modes["*"]
    return np.asarray(_jax_forward(mode)(params, jnp.asarray(x), qstate))


def _port_logits(model, x, qstate=None, modes=None, kernels=False):
    with torch.no_grad(), fq_attn.activate(kernels):
        return vit_forward(SPEC.cfg, model, torch.from_numpy(x), qstate,
                           modes).numpy()


@pytest.fixture(scope="module")
def jax_model():
    # the JAX random init, jitted (op-by-op it takes seconds)
    init = jax.jit(j_vit_init, static_argnums=0)
    return _np_tree(init(SPEC.cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_calibrated(jax_model):
    """One tiny FPCS calibration by the JAX package (W4A4)."""
    cfg = JConfig(**W4A4, eq_n=32, steps=2, search_round=1, fpcs=True,
                  calib_size=8, calib_batch_size=8)
    calib = QuantCalibrator(SPEC, jax.tree_util.tree_map(jnp.asarray,
                                                         jax_model), cfg)
    calib.calibrate([_images(1)])
    new_params, qstate = calib.finish_calibration()
    return _np_tree(new_params), _np_tree(qstate)


def test_raw_logits_match_jax(jax_model):
    model, _ = from_jax(SPEC.cfg, jax_model)
    x = _images(2)
    np.testing.assert_allclose(_port_logits(model, x),
                               _jax_logits(jax_model, x),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_module_keys_are_timm(jax_model):
    model, _ = from_jax(SPEC.cfg, jax_model)
    keys = set(model.state_dict())
    assert {"patch_embed.proj.weight", "cls_token", "pos_embed",
            "blocks.1.attn.qkv.bias", "blocks.0.mlp.fc2.weight",
            "norm.bias", "head.weight"} <= keys
    assert not any("q_norm" in k for k in keys)


def test_init_qstate_matches_jax(jax_model):
    """The port's init_qstate equals the JAX package's leaf by leaf, and the
    quantized logits agree with the fused attention path on or off."""
    model, _ = from_jax(SPEC.cfg, jax_model)
    jq = _np_tree(j_init_qstate(SPEC, JConfig(**W4A4), jax_model))
    tq = init_qstate(SPEC, Config(**W4A4), model)
    carried = qstate_from_tree(jq)
    assert set(tq) == set(carried)
    for name in tq:
        a, b = dataclasses.asdict(tq[name]), dataclasses.asdict(carried[name])
        assert a.keys() == b.keys(), name
        for k in a:
            if isinstance(a[k], dict):
                for f, v in a[k].items():
                    w = b[k][f]
                    if isinstance(v, torch.Tensor):
                        assert torch.equal(v, w), (name, k, f)
                    else:
                        assert v == w, (name, k, f)
            else:
                assert a[k] == b[k], (name, k)
    x = _images(3)
    want = _jax_logits(jax_model, x, jq, {"*": "quant"})
    for kernels in (False, True):
        np.testing.assert_allclose(
            _port_logits(model, x, tq, {"*": "quant"}, kernels), want,
            rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("kernels", [False, True])
def test_calibrated_logits_match_jax(jax_calibrated, kernels):
    """JAX-calibrated params + qstate carried over: reparam'd LayerNorms,
    folded post-GeLU bias (bias_reparamed), searched AdaLog bases."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    m2 = tq["blocks.0.attn.matmul2"]
    assert m2.Aq.kind == "adalog" and float(m2.Aq.log_q) != 37.0
    assert bool(tq["blocks.0.mlp.fc2"].aq.bias_reparamed)
    x = _images(4)
    np.testing.assert_allclose(
        _port_logits(model, x, tq, {"*": "quant"}, kernels),
        _jax_logits(params, x, qstate, {"*": "quant"}),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("mode", ["w_only", "a_only"])
def test_debug_modes_match_jax(jax_calibrated, mode):
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    x = _images(5)
    np.testing.assert_allclose(
        _port_logits(model, x, tq, {"*": mode}),
        _jax_logits(params, x, qstate, {"*": mode}),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_capture_taps_match_jax(jax_model):
    model, _ = from_jax(SPEC.cfg, jax_model)
    x = _images(6, n=2)
    _, jt = j_vit_forward(SPEC.cfg, jax_model, jnp.asarray(x), capture=True,
                          capture_blocks=True)
    with torch.no_grad():
        _, tt = vit_forward(SPEC.cfg, model, torch.from_numpy(x),
                            capture=True, capture_blocks=True)
    assert set(tt) == set(jt)
    for name in jt:
        assert len(tt[name]) == len(jt[name]), name
        for a, b in zip(tt[name], jt[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_jax_checkpoint_serves_in_port(jax_calibrated, tmp_path):
    """A .ckpt written by adalog_tpu loads through the port's
    load_quantized and serves the JAX package's logits."""
    params, qstate = jax_calibrated
    path = str(tmp_path / "jax.ckpt")
    j_checkpoint.save_checkpoint(path, params, qstate, {"model": "test_tiny"})
    x = _images(7)
    want = _jax_logits(params, x, qstate, {"*": "quant"})
    for on in (True, False):
        predict, spec, model, tq = load_quantized(
            "test_tiny", path, config=Config(**W4A4), device="cpu",
            use_pallas=on)
        assert spec.name == "test_tiny"
        y = predict(x)
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), want, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


def test_port_checkpoint_loads_in_jax(jax_calibrated, tmp_path):
    """A .ckpt written by the port loads in adalog_tpu with the same arrays
    and the same quantized logits."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    path = str(tmp_path / "port.ckpt")
    checkpoint.save_checkpoint(path, model, tq, {"model": "test_tiny"})
    jp, jq, meta = j_checkpoint.load_checkpoint(path)
    assert meta == {"model": "test_tiny"}
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(jp)),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    x = _images(8)
    np.testing.assert_allclose(
        _jax_logits(jp, x, jq, {"*": "quant"}),
        _port_logits(model, x, tq, {"*": "quant"}),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # and the port reads its own file back bit for bit
    m2, q2, _ = checkpoint.load_checkpoint(path, SPEC.cfg)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k
    assert float(q2["blocks.1.attn.matmul2"].Aq.log_q) == \
        float(tq["blocks.1.attn.matmul2"].Aq.log_q)


def test_predictor_matches_forward_and_keeps_module(jax_calibrated):
    """Load-time weight prep gives the per-call forward's logits; the
    caller's module stays float32 and untouched by a bf16 predictor."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = _images(9)
    y = make_predictor(SPEC, model, tq, cfg=Config(**W4A4),
                       device="cpu")(x)
    np.testing.assert_array_equal(y.numpy(),
                                  _port_logits(model, x, tq, {"*": "quant"},
                                               kernels=True))
    y16 = make_predictor(SPEC, model, tq, eval_dtype="bfloat16",
                         device="cpu")(x)
    assert y16.dtype == torch.float32 and y16.shape == (8, 10)
    assert torch.isfinite(y16).all()
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k


def test_load_vit_from_npz(jax_model, tmp_path):
    """timm-keyed .npz -> read_state_dict -> load_vit; extra keys (e.g. a
    distillation head) are ignored, missing ones raise."""
    model, _ = from_jax(SPEC.cfg, jax_model)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    sd["head_dist.weight"] = np.zeros((10, 32), np.float32)
    path = str(tmp_path / "w.npz")
    np.savez(path, **sd)
    m2 = load_vit(SPEC.cfg, read_state_dict(path))
    x = _images(10)
    np.testing.assert_array_equal(_port_logits(m2, x), _port_logits(model, x))
    del sd["norm.weight"]
    with pytest.raises(KeyError):
        load_vit(SPEC.cfg, sd)


def test_kernel_defaults_start_empty():
    cfg = resolve_kernel_config(Config(), zoo.model_spec("deit_small"))
    assert cfg.use_pallas is True and cfg.eval_int8 is False
    cfg = resolve_kernel_config(Config(use_pallas=False),
                                zoo.model_spec("vit_large"))
    assert cfg.use_pallas is False


def test_unported_paths_raise(jax_calibrated, tmp_path):
    params, qstate = jax_calibrated
    path = str(tmp_path / "m.ckpt")
    j_checkpoint.save_checkpoint(path, params, qstate)
    with pytest.raises(NotImplementedError):
        load_quantized("test_tiny", path, device="cpu", mesh_devices=2)
    with pytest.raises(NotImplementedError):
        load_quantized("test_tiny", path, device="cpu", mesh_devices=4,
                       mesh_tp=2)
    with pytest.raises(NotImplementedError):
        load_quantized("test_tiny", path, device="cpu",
                       config=Config(**W4A4, eval_int8=True))
    # reference-format files are read now (utils/ref_checkpoint.py): a
    # missing one is a missing file, no longer an unported path
    with pytest.raises(FileNotFoundError):
        load_quantized("test_tiny", str(tmp_path / "ref.pth"), device="cpu")


def test_mesh_devices_minus_one_is_all_local_devices(jax_calibrated, tmp_path,
                                                     monkeypatch):
    """mesh_devices=-1 means every local device, as in the JAX package: on
    the CPU, or with at most one GPU, that is one device and serves; with
    more it is multi-device serving, which is not ported."""
    params, qstate = jax_calibrated
    path = str(tmp_path / "m.ckpt")
    j_checkpoint.save_checkpoint(path, params, qstate)
    x = _images(12, n=2)
    want = load_quantized("test_tiny", path, device="cpu")[0](x)
    got = load_quantized("test_tiny", path, device="cpu", mesh_devices=-1)[0](x)
    assert torch.equal(got, want)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError):
        load_quantized("test_tiny", path, device="cuda", mesh_devices=-1)
    # the CPU has one device whatever the GPUs
    got = load_quantized("test_tiny", path, device="cpu", mesh_devices=-1)[0](x)
    assert torch.equal(got, want)


def test_build_model_random_init():
    """zoo.build_model initializes from an explicit seed: the same seed gives
    the same weights, another seed others, and the forward runs."""
    _, m0 = zoo.build_model("test_tiny", seed=0)
    _, m0b = zoo.build_model("test_tiny", seed=0)
    _, m1 = zoo.build_model("test_tiny", seed=1)
    assert torch.equal(m0.head.weight, m0b.head.weight)
    assert not torch.equal(m0.head.weight, m1.head.weight)
    assert torch.equal(m0.blocks[0].norm1.weight.detach(), torch.ones(32))
    y = _port_logits(m0, _images(11, n=2))
    assert y.shape == (2, 10) and np.isfinite(y).all()
