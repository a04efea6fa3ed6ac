"""The port's calibration on an NVIDIA GPU against the same code on the CPU.
Skipped without a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_calib_cuda.py

  - adalog_fq_search at every code of every base of the search grid: the
    card's values equal the CPU's bit for bit (PyTorch's CUDA kernels divide
    by a Python number as a multiply by its reciprocal; the search divides
    by tensors, so floor(code * q / 37) and the remainder stay exact);
  - the quantile helper, bit for bit, past 2^24 elements too;
  - the scorers, with TF32 allowed for the process beforehand: the
    calibrator pins exact fp32 products, and the scores equal the CPU's to
    SCORE_RTOL (TF32 would be off by about 1e-3);
  - fpcs keeps the lower index first among tied scores on the card;
  - a test_tiny calibration on the card against one on the CPU, on
    chip_smoke.py's terms (compare_qstates).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from adalog_tpu_torch.calib import candidates as C
from adalog_tpu_torch.calib import search as S
from adalog_tpu_torch.calib.calibrator import QuantCalibrator
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.ops import scoring as SC
from adalog_tpu_torch.utils.config import Config

SCORE_RTOL = 1e-5
SMALL = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4, eq_n=32, steps=2,
             search_round=1, fpcs=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the search runs there by default")
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("clamp_upper", [True, False])
def test_adalog_fq_search_card_equals_cpu(cuda_device, bits, clamp_upper):
    qs = np.arange(10, 138, dtype=np.float32)
    codes = np.arange(2 ** bits, dtype=np.float32)
    centre = np.exp2(-codes[None, :] * qs[:, None] / 37.0)
    rng = np.random.default_rng(0)
    x = np.concatenate([centre, 0.93 * centre,
                        rng.uniform(0, 1, (128, 64)),
                        np.zeros((128, 1)), np.full((128, 1), 1.7)],
                       axis=1).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (128, 1)).astype(np.float32)
    for sc in (None, scale):
        if sc is None and clamp_upper:
            continue
        args = [(_t(x, d), None if sc is None else _t(sc, d),
                 _t(qs[:, None], d)) for d in ("cpu", cuda_device)]
        want = SC.adalog_fq_search(*args[0], bits, clamp_upper)
        got = SC.adalog_fq_search(*args[1], bits, clamp_upper)
        assert torch.equal(got.cpu(), want)
    # the hazard: by a Python number the card multiplies by 1/37, and the
    # floor of an exact multiple of 37 may land one lower; by a tensor not
    k = torch.arange(1, 4097, dtype=torch.float32)
    prod = k.to(cuda_device) * 37.0
    r = torch.tensor(37.0, device=cuda_device)
    assert torch.equal(torch.floor(prod / r).cpu(), k)
    print("multiples of 37 floored one lower when divided by a Python "
          f"number: {int((torch.floor(prod / 37.0).cpu() != k).sum())}")


@pytest.mark.cuda
def test_quantile_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(1)
    qs = torch.tensor([0.9, 1.0, 0.1, 0.0, 0.5])
    for shape, dim in (((2 ** 24 + 1001,), None), ((7, 333), -1),
                       ((640, 5), 0)):
        x = _t(rng.standard_normal(shape))
        want = C.quantile(x, qs, dim)
        got = C.quantile(x.to(cuda_device), qs, dim)
        assert torch.equal(got.cpu(), want)


def _linear_case(device, T=256, I=256, O=768):
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((T, I)), device)
    w = _t(0.1 * rng.standard_normal((O, I)), device)
    return x, w, x @ w.T


@pytest.mark.cuda
def test_scorers_pinned_fp32_with_tf32_allowed(cuda_device):
    """TF32 allowed for the process, then a calibrator built on the card:
    its pin holds, and the scoring products run exact fp32."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    _, model = zoo.build_model("test_tiny", seed=0)
    QuantCalibrator(zoo.model_spec("test_tiny"), model, Config(**SMALL))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    for dev_args in [_linear_case(d) for d in ("cpu", cuda_device)]:
        x, w, tgt = dev_args
        s, z = C.act_candidates(x, 4, 32, channel_wise=False)
        a_out = SC.score_linear_a_out(x, tgt, w, s[:, :, None],
                                      z[:, :, None], 4)
        w_v = w.reshape(3, 256, 256)
        ws, wz = C.weight_candidates(w_v, 4, 32)
        G, Cm = SC.gram_stats(x, tgt)
        w_gram = SC.score_linear_w_out_gram(
            G, Cm, w_v, ws.reshape(-1, 3, 256, 1), wz.reshape(-1, 3, 256, 1),
            4)
        dev_args += (a_out, w_gram)
        if x.device.type == "cpu":
            want = dev_args
        else:
            got = dev_args
    for g, w_ in zip(got[3:], want[3:]):
        tol = SCORE_RTOL * w_.abs().max().item()
        assert (g.cpu() - w_).abs().max().item() <= tol


@pytest.mark.cuda
def test_fpcs_tie_order_on_card(cuda_device):
    idx = S.top_k_indices(torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0] * 400,
                                       device=cuda_device), 600)
    ties = torch.arange(2000).reshape(400, 5)[:, [1, 2, 4]].reshape(-1)
    assert torch.equal(idx.cpu(), ties[:600])
    eq_n, U = 64, 3
    scales = torch.linspace(0.1, 1.0, eq_n // 8).repeat_interleave(8)[
        :, None].repeat(1, U)
    zps = torch.arange(eq_n, dtype=torch.float32)[:, None].repeat(1, U)
    target = torch.tensor([0.3, 0.5, 0.7])

    def score(s, z):
        return -torch.round(torch.abs(s - target.to(s.device)[None]) * 4) / 4

    want = S.fpcs(score, scales, zps, eq_n=eq_n, steps=4)
    got = S.fpcs(score, scales.to(cuda_device), zps.to(cuda_device),
                 eq_n=eq_n, steps=4)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_tiny_calibration_card_against_cpu(cuda_device):
    """test_tiny at the shipped search numbers (eq_n 128, steps 6, three
    rounds), 32 images: on the card (the default device) and on the CPU."""
    spec = zoo.model_spec("test_tiny")
    _, model = zoo.build_model("test_tiny", seed=0)
    x = chip_smoke.calibration_images(spec.cfg, 32, 3)
    states = {}
    for device in (None, "cpu"):
        calib = QuantCalibrator(spec, model, chip_smoke.quant_config(),
                                device=device)
        assert calib.device.type == ("cuda" if device is None else "cpu")
        calib.calibrate([x])
        states[device] = calib.finish_calibration()[1]
    n = chip_smoke.compare_qstates(torch, states[None], states["cpu"])
    print(n)
    assert n["adjacent"] <= chip_smoke.ADJACENT_SHARE * n["picks"]
    assert n["moved"] <= chip_smoke.MOVED_SHARE * n["scales"]


def _family_cases():
    """(name, function, args, kwargs) of every batched search family at
    small shapes, two sites each."""
    from adalog_tpu_torch.quantizers.state import GELU_MIN

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((2, 48, 16))).astype(np.float32)
    b = (0.1 * rng.standard_normal((2, 48))).astype(np.float32)
    y = np.einsum("lti,loi->lto", x, w) + b[:, None]
    xg = np.maximum(rng.standard_normal((2, 64, 48)), -0.17).astype(
        np.float32)
    w2 = (0.3 * rng.standard_normal((2, 16, 48))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((2, 16))).astype(np.float32)
    y2 = np.einsum("lti,loi->lto", xg, w2) + b2[:, None]
    A = rng.standard_normal((2, 2, 2, 12, 8)).astype(np.float32)
    B = rng.standard_normal((2, 2, 2, 8, 12)).astype(np.float32)
    P = rng.uniform(0, 1, (2, 2, 2, 12, 12)).astype(np.float32)
    P /= P.sum(-1, keepdims=True)
    V = rng.standard_normal((2, 2, 2, 12, 8)).astype(np.float32)
    xc = rng.standard_normal((2, 2, 16, 16, 3)).astype(np.float32)
    wc = (0.2 * rng.standard_normal((2, 8, 3, 4, 4))).astype(np.float32)
    yc = rng.standard_normal((2, 2, 4, 4, 8)).astype(np.float32)
    kw = dict(eq_n=32, steps=3, use_fpcs=True)
    lin = dict(kw, w_bits=4, a_bits=4, rounds=2)
    return [
        ("linear", S.search_linear_default_batched, (x, y, w, b),
         dict(lin, n_V=3, gram=True, a_gram=True)),
        ("act channel-wise", S.search_act_channelwise_batched, (x,),
         dict(kw, a_bits=4)),
        ("post-GeLU AdaLog", S.search_linear_postgelu_adalog_batched,
         (xg, y2, w2, b2), dict(lin, n_V=1, gram=True, shift=GELU_MIN)),
        ("post-GeLU twin", S.search_linear_postgelu_twin_batched,
         (xg, y2, w2, b2), dict(lin, n_V=1)),
        ("matmul", S.search_matmul_batched, (A, B, A @ B),
         dict(kw, A_bits=4, B_bits=4, rounds=2, head_cw=True, gram=True)),
        ("post-softmax", S.search_matmul_postsoftmax_batched, (P, V, P @ V),
         dict(kw, A_bits=4, B_bits=4, rounds=2, head_cw=True,
              a_kind="adalog")),
        ("conv", S.search_conv_batched, (xc, yc, wc, np.zeros((2, 8))),
         dict(kw, w_bits=4, conv_dims=(4, 4, 4, 0))),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(7))
def test_batched_family_card_against_cpu(cuda_device, case):
    """Each family's batched search (torch.func.vmap over the sites) runs
    on the card and picks what the CPU picks."""
    name, fn, args, kw = _family_cases()[case]
    shift = kw.pop("shift", None)
    res = {}
    for d in ("cpu", cuda_device):
        extra = () if shift is None else (shift,)
        res[d] = fn(*(_t(a, d) for a in args), *extra, **kw)
    for g, w in zip(res[cuda_device], res["cpu"]):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-7,
                                   msg=name)
