"""The port's whole calibrator (calib/calibrator.py) on the CPU: against
adalog_tpu's QuantCalibrator at test_tiny and test_tiny_swin, then on its
own terms (the cases of tests/test_calib_e2e.py).

Weights go across with utils/interop.py; both packages calibrate the same
batch at a small W4A4 configuration (eq_n 32, steps 2, one search round,
FPCS, LayerNorm reparam, post-GeLU AdaLog, head-wise matmuls). Gates, site
by site: kinds, bits and flags equal; integer picks (zero points, AdaLog
bases) exact or adjacent, the adjacent share reported; scales to
SCALE_RTOL (measured 3.3e-7); the reparameterized model's tensors to
PARAM_RTOL of each tensor's largest value (a folded LayerNorm bias b/r -
shift is a difference of nearly equal numbers); the quantized logits to LOGIT_TOL (measured 6e-8).
"""

import dataclasses
import logging
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adalog_tpu.calib.calibrator import QuantCalibrator as JQuantCalibrator
from adalog_tpu.models import zoo as j_zoo
from adalog_tpu.utils import resume as j_resume
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu_torch.calib import calibrator as C
from adalog_tpu_torch.calib.calibrator import QuantCalibrator
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.models.layers import LinearSite
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.interop import from_jax, qstate_from_tree
from adalog_tpu_torch.utils.resume import RESUME_MAGIC

torch.set_num_threads(1)

SCALE_RTOL = 1e-5
PARAM_RTOL = 1e-5
LOGIT_TOL = 1e-5
SMALL = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4, eq_n=32, steps=2,
             search_round=1, fpcs=True, calib_size=8, calib_batch_size=8)
ADJACENT = {"picks": 0, "adjacent": 0}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, n=8):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _logits(spec, model, qstate, x, modes=None):
    with torch.no_grad():
        return zoo.model_forward_fn(spec)(spec.cfg, model,
                                          torch.from_numpy(x), qstate,
                                          modes).numpy()


def _quant(spec, model, qstate, x):
    return _logits(spec, model, qstate, x, {"*": "quant"})


def _jax_params(name):
    return _np_tree(j_zoo.build_model(name, seed=0)[1])


@pytest.fixture(scope="module", params=["test_tiny", "test_tiny_swin"])
def both(request, tmp_path_factory):
    """One calibration by each package on the same weights and batch; the
    JAX run also writes a resume file."""
    name = request.param
    spec = zoo.model_spec(name)
    jp = _jax_params(name)
    x = _images(1)
    resume = str(tmp_path_factory.mktemp(name) / "jax_resume.bin")
    jc = JQuantCalibrator(j_zoo.model_spec(name),
                          jax.tree_util.tree_map(jnp.asarray, jp),
                          JConfig(**SMALL), resume_path=resume)
    jc.calibrate([x])
    j_params, j_qstate = (_np_tree(t) for t in jc.finish_calibration())
    model, _ = from_jax(spec.cfg, jp)
    tc = QuantCalibrator(spec, model, Config(**SMALL), device="cpu")
    tc.calibrate([x])
    t_params, t_qstate = tc.finish_calibration()
    return dict(spec=spec, jp=jp, x=x, model=model, resume=resume,
                j=(j_params, j_qstate), t=(t_params, t_qstate), tc=tc)


def _fields(site, prefix=""):
    for f in dataclasses.fields(site):
        v = getattr(site, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


INTEGER_FIELDS = ("wq.zero_point", "aq.zero_point", "aq.log_q",
                  "Aq.zero_point", "Bq.zero_point", "Aq.log_q")


def _assert_sites_match(got: dict, want: dict):
    """want: the JAX package's qstate carried into the port's classes."""
    assert set(got) == set(want)
    for name in want:
        a, b = dict(_fields(got[name])), dict(_fields(want[name]))
        assert a.keys() == b.keys(), name
        for k, va in a.items():
            vb = b[k]
            if not isinstance(va, torch.Tensor):
                assert va == vb, (name, k)
                continue
            assert va.shape == vb.shape and va.dtype == vb.dtype, (name, k)
            if va.dtype == torch.bool:
                assert torch.equal(va, vb), (name, k)
            elif k in INTEGER_FIELDS:
                d = (va - vb).abs()
                assert bool((d <= 1).all()), (name, k, va, vb)
                ADJACENT["picks"] += d.numel()
                ADJACENT["adjacent"] += int((d != 0).sum())
            else:
                np.testing.assert_allclose(va.numpy(), vb.numpy(),
                                           rtol=SCALE_RTOL, atol=0,
                                           err_msg=f"{name} {k}")


def test_sites_match_jax(both):
    _assert_sites_match(both["t"][1], qstate_from_tree(both["j"][1]))
    assert set(both["t"][1]) == set(both["tc"].layout)


def test_reparameterized_model_matches_jax(both):
    """The folded LayerNorms, the rescaled qkv / fc1 weights and biases
    and the fc2 biases with the GeLU shift folded in."""
    model_j, _ = from_jax(both["spec"].cfg, both["j"][0])
    want = model_j.state_dict()
    for k, v in both["t"][0].state_dict().items():
        w = want[k].numpy()
        np.testing.assert_allclose(v.numpy(), w, rtol=PARAM_RTOL,
                                   atol=PARAM_RTOL * np.abs(w).max(),
                                   err_msg=k)


def test_quantized_logits_match_jax(both):
    spec, x = both["spec"], _images(2)
    model_j, q_j = from_jax(spec.cfg, *both["j"])
    want = _quant(spec, model_j, q_j, x)
    got = _quant(spec, *both["t"], x)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_jax_resume_file_resumes_in_port(both):
    """The JAX run's resume file, cut mid-record as a killed run leaves it:
    the port takes its folds and sites and searches the rest, to the state
    of its own uninterrupted run. A file the port writes reads back through
    the JAX package's reader."""
    with open(both["resume"], "rb") as f:
        data = f.read()
    ends, pos = [], 0              # frame: magic (6), u64 length, record
    while pos < len(data):
        pos += 14 + int.from_bytes(data[pos + 6:pos + 14], "little")
        ends.append(pos)
    cut = both["resume"] + ".cut"
    with open(cut, "wb") as f:     # two thirds of the frames, and a torn one
        f.write(data[:ends[2 * len(ends) // 3 - 1] + 20])
    tc = QuantCalibrator(both["spec"], both["model"], Config(**SMALL),
                         device="cpu", resume_path=cut)
    recs = tc._resume_scan()
    assert any(t == "fold" for t, _, _ in recs)
    n_sites = sum(t == "site" for t, _, _ in recs)
    assert 0 < n_sites < len(tc.layout)
    tc.calibrate([both["x"]])
    params, qstate = tc.finish_calibration()
    assert len(tc._folded) > 0
    _assert_sites_match(qstate, both["t"][1])
    x = _images(3)
    np.testing.assert_allclose(_quant(both["spec"], params, qstate, x),
                               _quant(both["spec"], *both["t"], x),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # the port cut the torn tail and appended its records after JAX's: the
    # JAX package reads them all
    j_recs = j_resume.resume_scan(cut)
    assert len(j_recs) > len(recs)
    assert {m for t, m, _ in j_recs if t == "site"} == set(tc.layout)


def test_adjacent_share_reported(both):
    share = ADJACENT["adjacent"] / max(1, ADJACENT["picks"])
    print(f"integer picks so far: {ADJACENT['picks']}, adjacent "
          f"{ADJACENT['adjacent']} (share {share:.4f})")
    assert share <= 0.1


# ---------------------------------------------------------------------------
# the port on its own, at test_tiny (the cases of tests/test_calib_e2e.py)
# ---------------------------------------------------------------------------

SPEC = zoo.model_spec("test_tiny")


@pytest.fixture(scope="module")
def tiny():
    _, model = zoo.build_model("test_tiny", seed=0)
    return model, [_images(4)]


def _run(model, batches, **cfg_kw):
    tc = QuantCalibrator(SPEC, model, Config(**dict(SMALL, **cfg_kw)),
                         device="cpu")
    prefold, _ = tc.calibrate(batches)
    params, qstate = tc.finish_calibration()
    return tc, prefold, params, qstate


@pytest.fixture(scope="module")
def calibrated(tiny):
    return _run(*tiny)


def _same_state(q1, q2, rtol=1e-5, atol=1e-6):
    assert set(q1) == set(q2)
    for name in q1:
        a, b = dict(_fields(q1[name])), dict(_fields(q2[name]))
        for k, va in a.items():
            if isinstance(va, torch.Tensor):
                np.testing.assert_allclose(va.float().numpy(),
                                           b[k].float().numpy(), rtol=rtol,
                                           atol=atol, err_msg=f"{name} {k}")
            else:
                assert va == b[k], (name, k)


def test_all_sites_calibrated(calibrated):
    tc, _, _, qstate = calibrated
    assert set(qstate) == set(tc.layout)
    site = qstate["blocks.0.attn.qkv"]
    assert site.aq.scale.shape == (1,) and site.n_V == 3
    fc2 = qstate["blocks.0.mlp.fc2"]
    assert fc2.aq.kind == "adalog" and fc2.aq.shifted
    assert 10 <= float(fc2.aq.log_q) < 10 + 32
    assert bool(fc2.aq.bias_reparamed)
    mm2 = qstate["blocks.1.attn.matmul2"]
    assert float(mm2.Aq.scale.reshape(-1)[0]) == 1.0
    assert mm2.Aq.kind == "adalog"
    assert set(tc.seconds) >= {"capture", "reparam", "linear", "postgelu",
                               "matmul", "matmul_post", "conv"}


def test_calibrator_leaves_the_callers_model(tiny, calibrated):
    model, _ = tiny
    _, m_ref = zoo.build_model("test_tiny", seed=0)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              m_ref.state_dict().items()):
        assert torch.equal(a, b), k


def test_reparam_preserves_fp32_forward(tiny, calibrated):
    """The LayerNorm channel reparam keeps the FP32 function (the model
    before the GeLU bias fold, which changes the raw function by design)."""
    model, batches = tiny
    _, prefold, _, _ = calibrated
    np.testing.assert_allclose(_logits(SPEC, prefold, None, batches[0]),
                               _logits(SPEC, model, None, batches[0]),
                               rtol=5e-3, atol=5e-3)


def test_calibrated_beats_minmax_baseline(tiny, calibrated):
    """The FPCS search beats min/max activation ranges taken from the same
    captured calibration inputs, on end-to-end quantized output error."""
    model, batches = tiny
    _, _, params, qstate = calibrated
    x = batches[0]
    y_raw = _logits(SPEC, model, None, x)
    y_q = _quant(SPEC, params, qstate, x)
    taps = C.capture_all_sites(SPEC, params, batches)
    base = {}
    for nm, site in qstate.items():
        if isinstance(site, LinearSite) and site.aq.kind == "uniform":
            xin = taps[nm][0]
            N = 2 ** (site.aq.bits - 1)
            lo, hi = float(xin.min()), float(xin.max())
            s = max((hi - lo) / (2 * N - 1), 1e-8)
            base[nm] = dataclasses.replace(site, aq=dataclasses.replace(
                site.aq, scale=torch.full((1,), s),
                zero_point=torch.full((1,), float(round(-lo / s)))))
        else:
            base[nm] = site
    y_b = _quant(SPEC, params, base, x)
    err_q = np.linalg.norm(y_q - y_raw)
    err_b = np.linalg.norm(y_b - y_raw)
    assert err_q <= err_b * 1.15, (err_q, err_b)


def test_batched_equals_sequential(tiny, calibrated):
    model, batches = tiny
    _, _, p1, q1 = calibrated
    _, _, p0, q0 = _run(model, batches, batch_sites=False)
    _same_state(q0, q1)
    np.testing.assert_allclose(_quant(SPEC, p0, q0, batches[0]),
                               _quant(SPEC, p1, q1, batches[0]),
                               rtol=1e-5, atol=1e-5)


class Boom(Exception):
    pass


@pytest.mark.parametrize("where", ["matmul", "fold_then_search",
                                   "batched_first_flush"])
def test_resume_after_interruption(tiny, calibrated, tmp_path, where):
    """An interrupted calibration resumes from its file to the state of an
    uninterrupted run: killed at the third matmul site (per-site flow);
    between a LayerNorm fold and that site's search (no double fold); and,
    layer-batched, at the first per-tensor group flush, after every fold
    was recorded."""
    model, batches = tiny
    batch_sites = where == "batched_first_flush"
    resume = str(tmp_path / "resume.bin")
    tc = QuantCalibrator(SPEC, model,
                         Config(**dict(SMALL, batch_sites=batch_sites)),
                         device="cpu", resume_path=resume)
    calls = {"n": 0}
    if where == "matmul":
        orig = tc._do_matmul

        def bomb(*a, **k):
            calls["n"] += 1
            if calls["n"] == 3:
                raise Boom()
            return orig(*a, **k)

        tc._do_matmul = bomb
    elif where == "fold_then_search":
        orig = tc._set_linear_state

        def bomb(name, *a, **k):
            if name == "blocks.0.attn.qkv":
                raise Boom()
            return orig(name, *a, **k)

        tc._set_linear_state = bomb
    else:
        orig = tc._flush_one_group

        def bomb(*a, **k):
            raise Boom()

        tc._flush_one_group = bomb
    with pytest.raises(Boom):
        tc.calibrate(batches)
    assert len(tc.qstate) < len(tc.layout)

    tc2 = QuantCalibrator(SPEC, model,
                          Config(**dict(SMALL, batch_sites=batch_sites)),
                          device="cpu", resume_path=resume)
    tc2.calibrate(batches)
    p2, q2 = tc2.finish_calibration()
    assert set(q2) == set(tc2.layout)
    if where != "matmul":
        assert "blocks.0.attn.qkv" in tc2._folded
    p3, q3 = (calibrated[2:] if batch_sites else
              _run(model, batches, batch_sites=False)[2:])
    np.testing.assert_allclose(_quant(SPEC, p2, q2, batches[0]),
                               _quant(SPEC, p3, q3, batches[0]),
                               rtol=1e-5, atol=1e-6)


def test_resume_file_format(tiny, tmp_path):
    """Framed npz records (the JAX package's magic), a torn tail tolerated,
    a pickle file refused."""
    model, batches = tiny
    resume = str(tmp_path / "resume.bin")
    QuantCalibrator(SPEC, model, Config(**dict(SMALL, batch_sites=False)),
                    device="cpu", resume_path=resume).calibrate(batches)
    with open(resume, "rb") as f:
        data = f.read()
    assert data[:6] == RESUME_MAGIC == j_resume.RESUME_MAGIC == b"ALRS2\x00"
    assert b"cnumpy" not in data
    with open(resume, "wb") as f:
        f.write(data[:-7])
    tc = QuantCalibrator(SPEC, model, Config(**SMALL), device="cpu",
                         resume_path=resume)
    assert len(tc._resume_scan()) > 0
    legacy = str(tmp_path / "legacy.pkl")
    with open(legacy, "wb") as f:
        pickle.dump(("site", {}), f)
    tc = QuantCalibrator(SPEC, model, Config(**SMALL), device="cpu",
                         resume_path=legacy)
    with pytest.raises(ValueError, match="not a v2 resume file"):
        tc.calibrate(batches)


def _budget(model, batches, frac=0.25):
    tc = QuantCalibrator(SPEC, model, Config(**SMALL), device="cpu")
    total = sum(tc._tap_bytes(batches, list(tc.layout)).values())
    return max(1, int(total * frac))


def test_tap_shapes_from_meta_equal_capture(tiny):
    model, batches = tiny
    taps = C.capture_all_sites(SPEC, model, batches)
    shapes = C.tap_shapes(SPEC, model, batches[0].shape)
    assert {k: tuple(tuple(t.shape) for t in v) for k, v in taps.items()} \
        == shapes


def test_streaming_matches_one_pass(tiny, calibrated):
    """Streaming waves (capture a budget-sized slice of sites, search,
    free, recapture) give the one-pass calibration."""
    model, batches = tiny
    budget = _budget(model, batches)
    tc = QuantCalibrator(SPEC, model, Config(
        **dict(SMALL, capture_device_budget_bytes=budget)), device="cpu")
    waves = tc._streaming_waves(batches, list(tc.layout))
    assert waves is not None and len(waves) >= 3
    tc.calibrate(batches)
    p_s, q_s = tc.finish_calibration()
    _, _, p_o, q_o = calibrated
    _same_state(q_s, q_o)
    np.testing.assert_allclose(_quant(SPEC, p_s, q_s, batches[0]),
                               _quant(SPEC, p_o, q_o, batches[0]),
                               rtol=1e-5, atol=1e-5)
    tc1 = QuantCalibrator(SPEC, model, Config(
        **dict(SMALL, streaming_calib="on")), device="cpu")
    assert len(tc1._streaming_waves(batches, list(tc1.layout))) == 1


def test_streaming_resume_between_fold_and_search(tiny, tmp_path):
    """Streaming + resume across the fold/search window: the restored fold
    is applied before the wave captures, so the recaptured tap is already
    rewritten and must not be rewritten again."""
    model, batches = tiny
    cfg = Config(**dict(SMALL, batch_sites=False,
                        capture_device_budget_bytes=_budget(model, batches)))
    resume = str(tmp_path / "resume.bin")
    tc = QuantCalibrator(SPEC, model, cfg, device="cpu", resume_path=resume)
    orig = tc._set_linear_state

    def bomb(name, *a, **k):
        if name == "blocks.0.attn.qkv":
            raise Boom()
        return orig(name, *a, **k)

    tc._set_linear_state = bomb
    with pytest.raises(Boom):
        tc.calibrate(batches)
    tc2 = QuantCalibrator(SPEC, model, cfg, device="cpu", resume_path=resume)
    tc2.calibrate(batches)
    p2, q2 = tc2.finish_calibration()
    assert "blocks.0.attn.qkv" in tc2._taps_post_fold
    tc3 = QuantCalibrator(SPEC, model, cfg, device="cpu")
    tc3.calibrate(batches)
    p3, q3 = tc3.finish_calibration()
    np.testing.assert_allclose(_quant(SPEC, p2, q2, batches[0]),
                               _quant(SPEC, p3, q3, batches[0]),
                               rtol=1e-5, atol=1e-6)


def test_capture_budget_groups_and_dtypes(tiny):
    """A budget below one batch's taps splits the capture into groups of
    sites (the same taps); spill_dtype casts only a spilling capture,
    capture_dtype every one."""
    model, batches = tiny
    whole = C.capture_all_sites(SPEC, model, batches)
    total = sum(t.numel() * 4 for v in whole.values() for t in v)
    grouped = C.capture_all_sites(SPEC, model, batches, total // 3,
                                  spill_dtype=torch.bfloat16)
    for nm, tup in whole.items():
        for a, b in zip(tup, grouped[nm]):
            assert b.dtype == torch.bfloat16
            assert torch.equal(a.to(torch.bfloat16), b), nm
    fits = C.capture_all_sites(SPEC, model, batches, 4 * total,
                               spill_dtype=torch.bfloat16)
    assert all(t.dtype == torch.float32 for v in fits.values() for t in v)
    half = C.capture_all_sites(SPEC, model, batches, 4 * total,
                               capture_dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for v in half.values() for t in v)


def test_bf16_capture_calibrates_close(tiny, calibrated):
    """capture_dtype='bfloat16' halves the taps; the searches upcast them,
    and the result stays near the fp32 capture's."""
    model, batches = tiny
    _, _, p, q = _run(model, batches, capture_dtype="bfloat16")
    assert set(q) == set(calibrated[3])
    y_raw = _logits(SPEC, model, None, batches[0])
    err_bf16 = np.linalg.norm(_quant(SPEC, p, q, batches[0]) - y_raw)
    err_fp32 = np.linalg.norm(_quant(SPEC, *calibrated[2:], batches[0])
                              - y_raw)
    assert err_bf16 <= 1.5 * err_fp32, (err_bf16, err_fp32)


def test_device_and_mesh(tiny, monkeypatch):
    """The calibrator runs on CUDA unless asked for the CPU: with no CUDA
    device the default raises; a mesh without a process group raises (no
    rank calibrates alone; tests/test_torch_calib_mesh.py runs meshes)."""
    model, _ = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QuantCalibrator(SPEC, model, Config(**SMALL))
    with pytest.raises(RuntimeError, match="process group"):
        QuantCalibrator(SPEC, model, Config(**SMALL), device="cpu",
                        mesh=object())
    with pytest.raises(RuntimeError, match="process group"):
        C.capture_all_sites(SPEC, model, [_images(5)], mesh=object())


def test_degenerate_fpcs_warns_through_the_calibrator(tiny, caplog):
    """eq_n 32 makes the post-GeLU joint FPCS (width 32) degenerate: the
    port warns, as the JAX package does."""
    model, batches = tiny
    with caplog.at_level(logging.WARNING, logger="adalog_tpu_torch"):
        _run(model, batches)
    assert any("diverging scale walk" in r.message for r in caplog.records)
