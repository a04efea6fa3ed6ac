"""The port's Swin serving slice against adalog_tpu on the CPU, at
test_tiny_swin size (img 32, patch 4, embed 16, depths (1, 2), heads (2, 4),
window 4: stage 1's second block is shifted).

Weights go across with adalog_tpu_torch.utils.interop (the JAX package's
gathered rel-pos biases back to timm's tables); logits of the port's
swin_forward are held to the JAX package's for the raw model, init_qstate,
and a JAX-calibrated state (FPCS search, LayerNorm reparam that gives the
bias-free reduction a bias, folded post-GeLU bias). Both packages quantize
identically (see test_torch_quantizers.py), so logits differ only by fp32
sum order in the GEMMs: LOGIT_TOL. Checkpoints cross in both directions,
and the attention fall-back chain routes as the JAX package's does.
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
from adalog_tpu.models import swin as j_swin
from adalog_tpu.models.zoo import build_model as j_build_model
from adalog_tpu.ops import fq_attn as jfa
from adalog_tpu.utils import checkpoint as j_checkpoint
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu_torch.calib.init_state import init_qstate
from adalog_tpu_torch.calib.layout import quant_layout, tree_get
from adalog_tpu_torch.models import swin, zoo
from adalog_tpu_torch.models.load import load_swin, read_state_dict
from adalog_tpu_torch.models.swin import swin_forward
from adalog_tpu_torch.ops import fq_attn, fq_gemm, routes
from adalog_tpu_torch.serve import load_quantized, make_predictor
from adalog_tpu_torch.utils import checkpoint
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.interop import from_jax, qstate_from_tree

torch.set_num_threads(1)

# fp32 logits of the two packages: GEMM sum order differs, quantizer math
# does not (measured max |diff| below 1e-6 on logits of magnitude 0.5)
LOGIT_TOL = 1e-5
W4A4 = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)
SPEC = zoo.model_spec("test_tiny_swin")
SHIFTED = "layers.1.blocks.1"            # the one shifted block


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, n=4):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_forward(mode):
    modes = None if mode is None else {"*": mode}
    return jax.jit(lambda p, x, q: j_swin.swin_forward(SPEC.cfg, p, x, q,
                                                       modes))


def _jax_logits(params, x, qstate=None, modes=None):
    mode = None if modes is None else modes["*"]
    return np.asarray(_jax_forward(mode)(params, jnp.asarray(x), qstate))


def _port_logits(model, x, qstate=None, modes=None, kernels=False):
    plan = routes.build(SPEC, model, qstate or {}) if kernels else None
    with torch.no_grad(), routes.activate(plan):
        return swin_forward(SPEC.cfg, model, torch.from_numpy(x), qstate,
                            modes).numpy()


@pytest.fixture(scope="module")
def jax_model():
    return _np_tree(j_build_model("test_tiny_swin", seed=0)[1])


@pytest.fixture(scope="module")
def jax_calibrated(jax_model):
    """One tiny FPCS calibration by the JAX package (W4A4)."""
    cfg = JConfig(**W4A4, eq_n=32, steps=2, search_round=1, fpcs=True,
                  calib_size=8, calib_batch_size=8)
    calib = QuantCalibrator(SPEC, jax.tree_util.tree_map(jnp.asarray,
                                                         jax_model), cfg)
    calib.calibrate([_images(1, n=8)])
    new_params, qstate = calib.finish_calibration()
    return _np_tree(new_params), _np_tree(qstate)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws", [2, 4, 7, 12])
def test_relative_position_helpers_equal_jax(ws):
    """Index, gather and ungather are bitwise the JAX package's, and
    ungather inverts gather exactly."""
    np.testing.assert_array_equal(swin.relative_position_index(ws),
                                  j_swin.relative_position_index(ws))
    table = np.random.default_rng(ws).standard_normal(
        ((2 * ws - 1) ** 2, 3)).astype(np.float32)
    bias = swin.gather_rel_pos_bias(table, ws)
    assert bias.shape == (1, 3, ws * ws, ws * ws)
    np.testing.assert_array_equal(bias, j_swin.gather_rel_pos_bias(table, ws))
    np.testing.assert_array_equal(swin.ungather_rel_pos_bias(bias, ws), table)
    np.testing.assert_array_equal(j_swin.ungather_rel_pos_bias(bias, ws),
                                  table)


@pytest.mark.parametrize("res,ws,shift", [(8, 4, 2), (56, 7, 3), (24, 12, 6)])
def test_shift_mask_equals_jax(res, ws, shift):
    got = swin.shift_attn_mask(res, ws, shift)
    assert got.shape == ((res // ws) ** 2, ws * ws, ws * ws)
    np.testing.assert_array_equal(got, j_swin.shift_attn_mask(res, ws, shift))


def test_window_partition_reverse_equal_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 5)
                                                 ).astype(np.float32)
    win = swin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        win.numpy(), np.asarray(j_swin.window_partition(jnp.asarray(x), 4)))
    back = swin.window_reverse(win, 4, 8, 8)
    np.testing.assert_array_equal(back.numpy(), x)


def test_config_window_shift_equals_jax():
    for name in ("test_tiny_swin", "swin_tiny", "swin_base_384"):
        cfg = zoo.model_spec(name).cfg
        jcfg = j_swin.SwinConfig(**dataclasses.asdict(cfg))
        for i, depth in enumerate(cfg.depths):
            assert cfg.stage_dim(i) == jcfg.stage_dim(i)
            assert cfg.stage_res(i) == jcfg.stage_res(i)
            for j in range(depth):
                assert cfg.stage_window_shift(i, j) == \
                    jcfg.stage_window_shift(i, j)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def test_raw_logits_match_jax(jax_model):
    model, _ = from_jax(SPEC.cfg, jax_model)
    x = _images(2)
    np.testing.assert_allclose(_port_logits(model, x),
                               _jax_logits(jax_model, x),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_module_keys_are_timm(jax_model):
    model, _ = from_jax(SPEC.cfg, jax_model)
    keys = set(model.state_dict())
    assert {"patch_embed.proj.weight", "patch_embed.norm.bias",
            "layers.0.blocks.0.attn.qkv.bias",
            "layers.1.blocks.1.attn.relative_position_bias_table",
            "layers.1.blocks.0.mlp.fc2.weight",
            "layers.1.downsample.norm.weight",
            "layers.1.downsample.reduction.weight",
            "norm.bias", "head.fc.weight"} <= keys
    assert "layers.1.downsample.reduction.bias" not in keys
    assert not any(k.startswith("layers.0.downsample") for k in keys)
    assert model.layers[1].blocks[0].attn.relative_position_bias_table.shape \
        == (49, 4)


def test_layout_paths_address_the_modules(jax_model):
    """Every Linear/conv site's param_path (and norm_path) resolves in the
    port's module tree, and the site names are the JAX layout's."""
    from adalog_tpu.calib.layout import quant_layout as j_quant_layout

    model, _ = from_jax(SPEC.cfg, jax_model)
    layout = quant_layout(SPEC, Config(**W4A4))
    jl = j_quant_layout(SPEC, JConfig(**W4A4))
    assert list(layout) == list(jl)
    for name, ss in layout.items():
        js = jl[name]
        assert (ss.kind, ss.w_bits, ss.a_bits, ss.s_bits, ss.n_V, ss.heads,
                ss.post_quantizer) == \
               (js.kind, js.w_bits, js.a_bits, js.s_bits, js.n_V, js.heads,
                js.post_quantizer), name
        if ss.param_path:
            mod = tree_get(model, ss.param_path)
            assert mod is model.get_submodule(name), name
        if ss.norm_path is not None:
            assert isinstance(tree_get(model, ss.norm_path),
                              torch.nn.LayerNorm), name


def test_init_qstate_matches_jax(jax_model):
    """The port's init_qstate equals the JAX package's leaf by leaf (per-stage
    head counts, the bias-free reduction), and the quantized logits agree
    with the fused attention path on or off."""
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
    assert tq["layers.0.blocks.0.attn.matmul1"].Bq.scale.shape == (1, 2, 1, 1)
    assert tq["layers.1.blocks.1.attn.matmul1"].Bq.scale.shape == (1, 4, 1, 1)
    x = _images(3)
    want = _jax_logits(jax_model, x, jq, {"*": "quant"})
    for kernels in (False, True):
        np.testing.assert_allclose(
            _port_logits(model, x, tq, {"*": "quant"}, kernels), want,
            rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("kernels", [False, True])
def test_calibrated_logits_match_jax(jax_calibrated, kernels):
    """JAX-calibrated params + qstate carried over: reparam'd LayerNorms, a
    reduction that gained a bias, folded post-GeLU bias, searched bases."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    assert model.layers[1].downsample.reduction.bias is not None
    m2 = tq[f"{SHIFTED}.attn.matmul2"]
    assert m2.Aq.kind == "adalog"
    assert bool(tq[f"{SHIFTED}.mlp.fc2"].aq.bias_reparamed)
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
    """Every site's and unit's taps, the shifted block's (roll, mask, roll
    back) and the patch merging's among them."""
    model, _ = from_jax(SPEC.cfg, jax_model)
    x = _images(6, n=2)
    _, jt = j_swin.swin_forward(SPEC.cfg, jax_model, jnp.asarray(x),
                                capture=True, capture_blocks=True)
    with torch.no_grad():
        _, tt = swin_forward(SPEC.cfg, model, torch.from_numpy(x),
                             capture=True, capture_blocks=True)
    assert set(tt) == set(jt)
    assert {f"{SHIFTED}.attn.matmul2", SHIFTED, "layers.1.downsample",
            "layers.1.downsample.reduction", "head.fc"} <= set(tt)
    for name in jt:
        assert len(tt[name]) == len(jt[name]), name
        for a, b in zip(tt[name], jt[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# Kernel routing (plain versions on the CPU)
# ---------------------------------------------------------------------------

def _real_state(post="adalog"):
    """test_tiny_swin JAX params and init_qstate with matmul quantizers that
    do real work (unit scales would clip q, k, v to a few codes)."""
    _, params = j_build_model("test_tiny_swin", seed=0)
    qstate = j_init_qstate(SPEC, JConfig(**W4A4, post_softmax_quantizer=post),
                           params)
    for nm, site in list(qstate.items()):
        if hasattr(site, "Aq"):
            def real(qs):
                return qs.replace(scale=jnp.full_like(qs.scale, 0.02),
                                  zero_point=jnp.full_like(qs.zero_point, 8.0))
            Aq = real(site.Aq) if site.Aq.kind == "uniform" else site.Aq
            qstate[nm] = site.replace(Aq=Aq, Bq=real(site.Bq))
    return _np_tree((params, qstate))


M1 = ["layers.0.blocks.0.attn.matmul1", "layers.1.blocks.0.attn.matmul1",
      f"{SHIFTED}.attn.matmul1"]
# name: (post_softmax_quantizer, modes, capture, calls of (K1, K2, K3))
CHAIN = {
    "shipped": ("adalog", {"*": "quant"}, False, (3, 0, 0)),
    "log2": ("log2", {"*": "quant"}, False, (0, 0, 3)),
    "matmul1_raw": ("adalog", {"*": "quant", **{m: "raw" for m in M1}},
                    False, (0, 3, 0)),
    "capture": ("adalog", {"*": "quant"}, True, (0, 0, 6)),
}


@pytest.mark.parametrize("name", list(CHAIN))
def test_swin_fallback_chain_matches_jax(name, monkeypatch):
    """Which kernel each window attention reaches, by the wrappers' call
    counts (depths (1, 2): three attentions, one shifted, whose rel-pos bias
    and mask fold into the flash kernel's period-P bias), and logits equal
    to the JAX forward's with its kernels forced on in interpret mode."""
    post, modes, capture, want_calls = CHAIN[name]
    params, qstate = _real_state(post)
    model, tq = from_jax(SPEC.cfg, params, qstate)
    x = _images(7, n=2)

    jcalls = {"K1": 0, "K2": 0, "K3": 0}
    for key, attr in (("K1", "run_flash"), ("K2", "run_softmax"),
                      ("K3", "run")):
        def counted(*a, _real=getattr(jfa, attr), _key=key, **k):
            jcalls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(jfa, attr, counted)
    monkeypatch.setattr(jfa, "enabled", lambda: True)
    monkeypatch.setattr(jfa, "INTERPRET", True)
    want = j_swin.swin_forward(SPEC.cfg, params, jnp.asarray(x), qstate,
                               modes, capture=capture)
    want = np.asarray(want[0] if capture else want)
    assert tuple(jcalls.values()) == want_calls

    wrappers = (fq_attn.fq_flash_attn, fq_attn.fq_softmax_attn_matmul,
                fq_attn.fq_attn_matmul)
    before = [w.calls for w in wrappers]
    with torch.no_grad(), routes.activate(routes.build(SPEC, model, tq)):
        got = swin_forward(SPEC.cfg, model, torch.from_numpy(x), tq, modes,
                           capture=capture)
    got = (got[0] if capture else got).numpy()
    assert tuple(w.calls - b for w, b in zip(wrappers, before)) == want_calls
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)

    # kernels off: the plain ops give the same logits
    np.testing.assert_allclose(_port_logits(model, x, tq, modes), want,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_flash_bias_period(jax_model):
    """The flash bias of a shifted block is (nW*heads, N, N) with heads the
    fastest axis, so slice g = (b*nW + w)*heads + h reads row g % P."""
    model, _ = from_jax(SPEC.cfg, jax_model)
    ap = model.layers[1].blocks[1].attn
    mask = torch.from_numpy(swin.shift_attn_mask(4, 2, 1))     # nW = 4
    ap2 = swin.WindowAttention(32, 4, 2)
    with torch.no_grad():
        ap2.relative_position_bias_table.copy_(torch.randn(9, 4))
    bias = swin.flash_bias(ap2, mask)
    assert bias.shape == (16, 4, 4)
    rpb = swin.rel_pos_bias(ap2)[0]
    for w in range(4):
        for h in range(4):
            assert torch.equal(bias[w * 4 + h], rpb[h] + mask[w])
    assert swin.flash_bias(ap, None).shape == (4, 16, 16)


# ---------------------------------------------------------------------------
# Checkpoints and serving
# ---------------------------------------------------------------------------

def test_jax_checkpoint_serves_in_port(jax_calibrated, tmp_path):
    """A Swin .ckpt written by adalog_tpu loads through the port's
    load_quantized and serves the JAX package's logits, with the attention
    kernels' switch on or off and with the GEMM switch on."""
    params, qstate = jax_calibrated
    path = str(tmp_path / "jax.ckpt")
    j_checkpoint.save_checkpoint(path, params, qstate,
                                 {"model": "test_tiny_swin"})
    x = _images(8)
    want = _jax_logits(params, x, qstate, {"*": "quant"})
    for on, gemm in ((True, False), (False, False), (True, True)):
        before = fq_gemm.fq_gemm.calls
        predict, spec, model, tq = load_quantized(
            "test_tiny_swin", path, device="cpu", use_pallas=on,
            config=Config(**W4A4, use_pallas_gemm=gemm))
        assert spec.name == "test_tiny_swin"
        y = predict(x)
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), want, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        # 4 Linear sites a block, the reduction and head.fc
        assert fq_gemm.fq_gemm.calls - before == (4 * 3 + 2 if gemm else 0)


def test_gemm_dispatch_mma_formulation_matches_jax(jax_calibrated,
                                                   monkeypatch):
    """The fp32 Swin forward with every Linear site (the bias-free reduction
    and head.fc among them) computed as variant "mma" of the GEMM kernel
    computes it, from the plan's weight codes: the JAX package's logits."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    x = _images(9)
    plan = routes.build(SPEC, model, tq, Config(**W4A4),
                        use_gemm_kernels=True)
    table = {n: r.gemm for n, r in plan.linear.items() if r.kind == "fq_gemm"}
    assert len(table) == len(plan.linear) == 4 * 3 + 2
    assert all(site.mma_fp32 for site in table.values())

    def mma_formulation(site, x2, w, bias=None):
        fq_gemm.fq_gemm.calls += 1
        return fq_gemm._gemm_mma_plain(x2, w, site.params, bias,
                                       kind=site.kind, bits=site.bits,
                                       codes=site.codes)

    monkeypatch.setattr(fq_gemm, "run", mma_formulation)
    before = fq_gemm.fq_gemm.calls
    with torch.no_grad(), routes.activate(plan):
        y = swin_forward(SPEC.cfg, model, torch.from_numpy(x), tq,
                         {"*": "quant"}).numpy()
    assert fq_gemm.fq_gemm.calls - before == len(table)
    np.testing.assert_allclose(y, _jax_logits(params, x, qstate,
                                              {"*": "quant"}),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_port_checkpoint_loads_in_jax(jax_calibrated, tmp_path):
    """A Swin .ckpt written by the port loads in adalog_tpu with the same
    arrays (tables gathered back to the JAX package's biases) and the same
    quantized logits."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    path = str(tmp_path / "port.ckpt")
    checkpoint.save_checkpoint(path, model, tq, {"model": "test_tiny_swin"})
    jp, jq, meta = j_checkpoint.load_checkpoint(path)
    assert meta == {"model": "test_tiny_swin"}
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(jp)),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    x = _images(9)
    np.testing.assert_allclose(
        _jax_logits(jp, x, jq, {"*": "quant"}),
        _port_logits(model, x, tq, {"*": "quant"}),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # and the port reads its own file back bit for bit
    m2, q2, _ = checkpoint.load_checkpoint(path, SPEC.cfg)
    assert list(m2.state_dict()) == list(model.state_dict())
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k
    assert float(q2[f"{SHIFTED}.attn.matmul2"].Aq.log_q) == \
        float(tq[f"{SHIFTED}.attn.matmul2"].Aq.log_q)


def test_predictor_matches_forward_and_keeps_module(jax_calibrated):
    """Load-time weight prep gives the per-call forward's logits; the
    caller's module stays float32 and untouched by a bf16 predictor."""
    params, qstate = jax_calibrated
    model, tq = from_jax(SPEC.cfg, params, qstate)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = _images(10)
    y = make_predictor(SPEC, model, tq, cfg=Config(**W4A4),
                       device="cpu")(x)
    np.testing.assert_array_equal(y.numpy(),
                                  _port_logits(model, x, tq, {"*": "quant"},
                                               kernels=True))
    for kernels in (True, False):
        y16 = make_predictor(SPEC, model, tq, eval_dtype="bfloat16",
                             use_kernels=kernels, device="cpu")(x)
        assert y16.dtype == torch.float32 and y16.shape == (4, 10)
        assert torch.isfinite(y16).all()
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k


def test_load_swin_from_npz(jax_model, tmp_path):
    """timm-keyed .npz -> read_state_dict -> load_swin; an older file's
    ``head`` key serves as ``head.fc``, extra keys are ignored, missing ones
    raise."""
    model, _ = from_jax(SPEC.cfg, jax_model)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    sd["layers.0.blocks.0.attn.relative_position_index"] = \
        swin.relative_position_index(4)
    sd["head.weight"] = sd.pop("head.fc.weight")
    sd["head.bias"] = sd.pop("head.fc.bias")
    path = str(tmp_path / "w.npz")
    np.savez(path, **sd)
    m2 = load_swin(SPEC.cfg, read_state_dict(path))
    assert m2.layers[1].downsample.reduction.bias is None
    x = _images(11)
    np.testing.assert_array_equal(_port_logits(m2, x), _port_logits(model, x))
    _, m3 = zoo.build_model("test_tiny_swin", checkpoint_path=path)
    np.testing.assert_array_equal(_port_logits(m3, x), _port_logits(model, x))
    del sd["layers.1.downsample.norm.weight"]
    with pytest.raises(KeyError):
        load_swin(SPEC.cfg, sd)


def test_build_model_random_init():
    """zoo.build_model initializes a Swin from an explicit seed."""
    _, m0 = zoo.build_model("test_tiny_swin", seed=0)
    _, m0b = zoo.build_model("test_tiny_swin", seed=0)
    _, m1 = zoo.build_model("test_tiny_swin", seed=1)
    assert torch.equal(m0.head.fc.weight, m0b.head.fc.weight)
    assert not torch.equal(m0.head.fc.weight, m1.head.fc.weight)
    assert torch.equal(m0.layers[1].downsample.norm.weight.detach(),
                       torch.ones(64))
    assert m0.layers[1].downsample.reduction.bias is None
    assert m0.layers[0].downsample is None
    assert float(m0.layers[0].blocks[0].attn.relative_position_bias_table
                 .detach().abs().max()) > 0
    assert zoo.model_forward_fn(SPEC) is swin_forward
    y = _port_logits(m0, _images(12, n=2))
    assert y.shape == (2, 10) and np.isfinite(y).all()


def test_unported_swin_paths_raise(jax_calibrated, tmp_path):
    params, qstate = jax_calibrated
    path = str(tmp_path / "m.ckpt")
    j_checkpoint.save_checkpoint(path, params, qstate)
    # a mesh serves in a process group of its size (test_torch_parallel.py);
    # outside one, the error says how to launch
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        load_quantized("test_tiny_swin", path, device="cpu", mesh_devices=2)


def test_load_quantized_int8_matches_jax(jax_calibrated, tmp_path):
    """Config(eval_int8=True) serves: every site of JAX's int8 table runs as
    an integer product (int8_gemm), once a call, and the logits match the
    JAX package's predictor with its int8 table and switch."""
    from adalog_tpu.models.zoo import model_spec as j_model_spec
    from adalog_tpu.ops import int8_linear as j_int8
    from adalog_tpu.serve import make_predictor as j_make_predictor
    from adalog_tpu_torch.ops import int8_linear

    params, qstate = jax_calibrated
    path = str(tmp_path / "m.ckpt")
    j_checkpoint.save_checkpoint(path, params, qstate)
    x = _images(15)
    predict, *_ = load_quantized("test_tiny_swin", path, device="cpu",
                                 config=Config(**W4A4, eval_int8=True))
    calls = int8_linear.int8_gemm.calls
    got = predict(x).numpy()
    n = int8_linear.int8_gemm.calls - calls
    jspec = j_model_spec("test_tiny_swin")
    jp, jq = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, qstate))
    table = j_int8.prepare(jspec, jp, jq, JConfig(**W4A4))
    j_int8.set_enabled(True)
    try:
        want = np.asarray(j_make_predictor(jspec, jp, jq, int8_prep=table,
                                           cfg=JConfig(**W4A4))(
            jnp.asarray(x)))
    finally:
        j_int8.set_enabled(False)
    assert n == len(table) > 0, (n, sorted(table))
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
