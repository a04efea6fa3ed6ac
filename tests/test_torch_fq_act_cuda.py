"""The CUDA kernel K6 (adalog_tpu_torch/csrc/fq_act.cu) against its plain
version, ``apply_quantizer``, on an NVIDIA GPU. Skipped without a CUDA
device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_fq_act_cuda.py

Every case compares K6's output with ``apply_quantizer`` on the same CUDA
tensor bit for bit, NaN where it gives NaN: uniform (asymmetric and
symmetric) and AdaLog at 3, 4 and 6 bits and every base q in 1..36, shifted
with ``bias_reparamed`` 0 and 1, in float32 and bfloat16, at lengths that
are no multiple of a 16-byte piece, from unaligned pointers and on strided
rows, and over every float32 bit pattern (and every bfloat16 one) for an
AdaLog and two uniform sites. Then served forwards: a tiny deit_small,
swin_tiny and deit_small with ``eval_int8`` launch K6 once at every Linear
site that fake-quantizes its input (49, 52, 12), leave none on the eager
chain, and give the same logits bit for bit as with an empty
table; a calibration and a reconstruction on the card launch no K6.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from adalog_tpu_torch.models import layers
from adalog_tpu_torch.models.layers import LinearSite
from adalog_tpu_torch.ops import fq_act
from adalog_tpu_torch.quantizers.apply import apply_quantizer
from adalog_tpu_torch.quantizers.state import GELU_MIN, QuantizerState


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the activation fake-quant kernel "
                    "has no CPU mode")
    return torch.device("cuda")


def _one(v, device):
    return torch.tensor([v], dtype=torch.float32, device=device)


def _state(kind, bits, device, *, scale=0.05, zp=7.0, symmetric=False,
           q=29.0, shifted=False, reparamed=False):
    if kind == "uniform":
        return QuantizerState(scale=_one(scale, device),
                              zero_point=None if symmetric
                              else _one(zp, device),
                              kind="uniform", bits=bits, symmetric=symmetric)
    return QuantizerState(
        scale=_one(scale, device), log_q=torch.tensor(q, device=device),
        shift=_one(GELU_MIN, device) if shifted else None,
        bias_reparamed=torch.tensor(reparamed, device=device)
        if shifted else None,
        kind="adalog", bits=bits, shifted=shifted)


def _site(qs):
    site = fq_act.act_site(qs)
    assert site is not None, fq_act.refusal(qs)
    return site


def _assert_same(got, want, what=""):
    """Bit for bit, NaN where NaN."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    assert torch.equal(nan_g, nan_w), f"{what}: NaN at other places"
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    g = got.contiguous().view(ints[got.dtype])
    w = want.contiguous().view(ints[want.dtype])
    bad = (g != w) & ~nan_g
    n = int(bad.sum())
    if n:
        i = torch.nonzero(bad.reshape(-1))[:5, 0]
        raise AssertionError(
            f"{what}: {n} outputs differ, e.g. "
            f"{got.reshape(-1)[i].tolist()} vs {want.reshape(-1)[i].tolist()}")


def _check(qs, x, what=""):
    """One K6 launch against apply_quantizer on x; x is left unwritten."""
    site = _site(qs)
    keep = x.clone()
    before = fq_act.fq_act_quant.launches
    got = fq_act.fq_act_quant(site, x)
    torch.cuda.synchronize()
    assert fq_act.fq_act_quant.launches == before + 1
    _assert_same(x, keep, f"{what}: the input was written")
    _assert_same(got, apply_quantizer(qs, x), what)


def _inputs(qs, n, device, seed, dtype=torch.float32):
    """Values around every code of ``qs``: for AdaLog scale * 2^-u over the
    codes' whole range, for uniform normal values over the grid and past
    it, with zeros, negatives and exact grid points mixed in."""
    g = torch.Generator(device=device).manual_seed(seed)
    s = float(qs.scale)
    if qs.kind == "adalog":
        top = 2 ** qs.bits * float(qs.log_q) / 37.0 + 2
        u = torch.rand(n, generator=g, device=device) * top
        x = s * torch.exp2(-u)
        x = torch.where(torch.rand(n, generator=g, device=device) < 0.1,
                        -x, x)
        if qs.shifted:
            x = x - GELU_MIN
    else:
        N = 2 ** (qs.bits - 1)
        x = torch.randn(n, generator=g, device=device) * (s * N)
        grid = (torch.randint(-2 * N, 2 * N, (n,), generator=g,
                              device=device) + 0.5) * s
        x = torch.where(torch.rand(n, generator=g, device=device) < 0.2,
                        grid, x)
    x[::97] = 0.0
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [3, 4, 6])
def test_adalog_every_base(cuda_device, bits, dt):
    """AdaLog at every base q in 1..36, unshifted."""
    for q in range(1, 37):
        qs = _state("adalog", bits, cuda_device, scale=0.7, q=float(q))
        _check(qs, _inputs(qs, 100_003, cuda_device, q, getattr(torch, dt)),
               f"q={q}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("reparamed", [False, True])
@pytest.mark.parametrize("bits", [3, 4, 6])
def test_adalog_shifted(cuda_device, bits, reparamed, dt):
    """The post-GeLU site: x + shift quantized, the shift subtracted back
    unless it was folded into the bias."""
    for q in (1, 11, 20, 26, 29, 36):
        qs = _state("adalog", bits, cuda_device, scale=3.1, q=float(q),
                    shifted=True, reparamed=reparamed)
        _check(qs, _inputs(qs, 65_537, cuda_device, q, getattr(torch, dt)),
               f"q={q}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("bits", [3, 4, 6, 8])
def test_uniform(cuda_device, bits, symmetric, dt):
    for i, (scale, zp) in enumerate(((0.05, 7.0), (0.013, 3.0),
                                     (1.7, 0.0), (0.3, -2.0))):
        qs = _state("uniform", bits, cuda_device, scale=scale, zp=zp,
                    symmetric=symmetric)
        _check(qs, _inputs(qs, 65_539, cuda_device, i, getattr(torch, dt)))


def _three(device):
    return (_state("uniform", 4, device, scale=0.05, zp=7.0),
            _state("uniform", 4, device, scale=0.05, symmetric=True),
            _state("adalog", 4, device, scale=3.1, q=29.0, shifted=True,
                   reparamed=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 3, 5, 7, 9, 15, 17, 1023, 4099, 65_541])
def test_ragged_lengths(cuda_device, n, dt):
    for i, qs in enumerate(_three(cuda_device)):
        _check(qs, _inputs(qs, n, cuda_device, i, getattr(torch, dt)))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [1, 2, 3, 5])
def test_unaligned_pointer(cuda_device, offset, dt):
    """A storage offset that leaves x's base off 16 bytes: the scalar
    loop."""
    for i, qs in enumerate(_three(cuda_device)):
        x = _inputs(qs, 40_000 + offset, cuda_device, i, getattr(torch, dt))
        _check(qs, x[offset:].reshape(100, 400))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_strided_rows(cuda_device, dt):
    """Rows read in place by their stride: the class token's slice, a slice
    of columns (rows not 16-byte multiples), every third row, columns from
    the ninth on; a transposed x is refused by ``row_layout`` and raises in
    the wrapper."""
    for i, qs in enumerate(_three(cuda_device)):
        x = _inputs(qs, 50 * 197 * 384, cuda_device, i,
                    getattr(torch, dt)).reshape(50, 197, 384)
        for view in (x[:, 0], x[:, :, :383], x.reshape(-1, 384)[::3],
                     x[:, :, 8:]):
            assert fq_act.row_layout(view) is not None
            _check(qs, view)
        t = x[0].t()
        assert fq_act.row_layout(t) is None
        with pytest.raises(ValueError):
            fq_act.fq_act_quant(_site(qs), t)


def _every_float32(device, chunk=1 << 26):
    for lo in range(-2 ** 31, 2 ** 31, chunk):
        yield torch.arange(lo, lo + chunk, dtype=torch.int32,
                           device=device).view(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["uniform", "symmetric", "adalog"])
def test_every_float32_bit_pattern(cuda_device, which):
    """All 2^32 patterns in chunks: code boundaries, 0 and -0, subnormals,
    values past the scale, ±inf and NaN."""
    qs = dict(zip(("uniform", "symmetric", "adalog"),
                  _three(cuda_device)))[which]
    site = _site(qs)
    for x in _every_float32(cuda_device):
        _assert_same(fq_act.fq_act_quant(site, x), apply_quantizer(qs, x),
                     f"chunk from {x[0].item()!r}")


@pytest.mark.cuda
def test_every_bfloat16_bit_pattern(cuda_device):
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                     device=cuda_device).to(torch.int16).view(torch.bfloat16)
    for qs in _three(cuda_device):
        _check(qs, x, qs.kind)


# ---------------------------------------------------------------------------
# Served forwards
# ---------------------------------------------------------------------------

def _served(name, device, batch=2):
    """(spec, model, qstate, images) of ``name`` at full width with random
    weights and chip_smoke's smoke state, fc2 folded."""
    from adalog_tpu_torch.models.load import load_state_dict
    from adalog_tpu_torch.models.zoo import model_spec

    spec = model_spec(name)
    cfg = spec.cfg
    weights = chip_smoke.timm_weights if spec.family == "vit" \
        else chip_smoke.swin_weights
    model = load_state_dict(spec, weights(cfg, chip_smoke.SEED)).to(device)
    rng = np.random.default_rng(5)
    shape = (batch, cfg.img_size, cfg.img_size, cfg.in_chans)
    calib = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    qstate = chip_smoke.smoke_qstate(torch, spec, model, calib, device)
    chip_smoke.fold_fc2(torch, model, qstate)
    images = rng.standard_normal(shape).astype(np.float32)
    return spec, model, qstate, images


# Linear sites of one forward: deit_small 4 a block and the head;
# swin_tiny 4 a block (2 + 2 + 6 + 2), 3 reductions and head.fc
LINEAR_SITES = {"deit_small": 49, "swin_tiny": 52}


@pytest.mark.cuda
@pytest.mark.parametrize("name,int8,dt", [
    ("deit_small", False, "float32"), ("deit_small", False, "bfloat16"),
    ("swin_tiny", False, "float32"), ("deit_small", True, "float32")])
def test_served_forward_takes_k6_at_every_site(cuda_device, monkeypatch,
                                               name, int8, dt):
    from adalog_tpu_torch.serve import make_predictor

    spec, model, qstate, images = _served(name, cuda_device)
    n_sites = sum(isinstance(s, LinearSite) for s in qstate.values())
    assert n_sites == LINEAR_SITES[name]
    want = 12 if int8 else n_sites
    predict = make_predictor(spec, model, qstate, device=cuda_device,
                             eval_dtype=dt, use_int8=int8)
    predict(images)
    named = []
    real = layers._act_quant

    def spy(qs, x, training, act=None):
        before = fq_act.fq_act_quant.launches
        y = real(qs, x, training, act)
        named.append((act, fq_act.fq_act_quant.launches - before))
        return y

    monkeypatch.setattr(layers, "_act_quant", spy)
    eager = []
    monkeypatch.setattr(layers, "apply_quantizer",
                        lambda *a, **k: eager.append(a[0].kind)
                        or apply_quantizer(*a, **k))
    fq_act.fq_act_quant.variant_launches.update(uniform=0, adalog=0)
    got = predict(images)
    torch.cuda.synchronize()
    linear = [(n, k) for n, k in named if n is not None]
    assert len(linear) == want and all(k == 1 for _, k in linear), linear
    assert eager == [], eager          # no fake quantizer left eager
    # 12 post-GeLU fc2 sites in both models (swin_tiny: 2 + 2 + 6 + 2)
    assert fq_act.fq_act_quant.variant_launches == {
        "adalog": 12, "uniform": want - 12}
    monkeypatch.setattr(fq_act, "act_site", lambda aq: None)  # all eager
    plain = make_predictor(spec, model, qstate, device=cuda_device,
                           eval_dtype=dt, use_int8=int8)
    before = fq_act.fq_act_quant.launches
    _assert_same(got, plain(images), f"{name} logits")
    assert fq_act.fq_act_quant.launches == before


@pytest.mark.cuda
def test_calibration_and_reconstruction_launch_no_k6(cuda_device):
    from adalog_tpu_torch.calib.calibrator import QuantCalibrator
    from adalog_tpu_torch.calib.layout import quant_layout
    from adalog_tpu_torch.models import zoo
    from adalog_tpu_torch.recon import brecq
    from adalog_tpu_torch.utils.config import Config

    spec, model = zoo.build_model("test_tiny", seed=0)
    x = np.random.default_rng(3).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    cfg = Config(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4, eq_n=32, steps=2,
                 search_round=1, fpcs=True, recon_iters=5,
                 optim_batch_size=8)
    before = fq_act.fq_act_quant.calls
    p, q = QuantCalibrator(spec, model, cfg,
                           device=cuda_device).calibrate([x])
    brecq.BlockReconstructor(spec, p, model, q, quant_layout(spec, cfg), cfg,
                             device=cuda_device).reconstruct([x])
    torch.cuda.synchronize()
    assert fq_act.fq_act_quant.calls == before
