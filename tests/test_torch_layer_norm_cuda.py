"""The CUDA kernel K7 (adalog_tpu_torch/csrc/layer_norm.cu) against the
float64 LayerNorm and against its plain version, the eager chain, on an
NVIDIA GPU. Skipped without a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_layer_norm_cuda.py

Cases: every served width (128, 256, 384, 512, 1024, 2048, 2730) in float32
and bfloat16 at eps 1e-6 and 1e-5; ragged row counts and widths; 2730-wide
rows whose bases are only 8- or 4-byte aligned; strided rows (the class
token's);
rows of equal values; rows holding NaN and Inf. Tolerances, relative to a
row's largest |reference|: float32 FP32_TOL against float64 (the kernel's
sums run in another order than the chain's, and both round every step in
float32); bfloat16 half a bfloat16 unit plus FP32_TOL against float64 (the
kernel rounds once, at the store), and never farther from float64 than
the chain, which rounds every step to bfloat16. Then served forwards at the
zoo's full widths: K7 once at every LayerNorm (deit_small 25, swin_base 53,
deit_small with eval_int8 25, eva02_large_448 with eval_int8 73), the plain
version never, and 0 launches in calibration and BRECQ.
"""

import numpy as np
import pytest
import torch

from adalog_tpu_torch.models import layers
from adalog_tpu_torch.ops import layer_norm as ln

WIDTHS = (128, 256, 384, 512, 1024, 2048, 2730)
# float32: a few units of 2^-24 on each of mu, var and the four rounded
# steps, scaled by |x - mu| * rsqrt(var + eps) * |w|
FP32_TOL = 2e-6
# half a bfloat16 unit in the last place, relative to the value
BF16_HALF_ULP = 2.0 ** -8
# LayerNorm launches a served forward (tests/test_torch_layer_norm.py
# counts the modules on the CPU)
SERVED = (("deit_small", False, 25), ("swin_base", False, 53),
          ("deit_small", True, 25), ("eva02_large_448", True, 73))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LayerNorm kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _norm(D, dtype, device, eps=1e-6, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = torch.nn.LayerNorm(D, eps=eps)
    with torch.no_grad():
        m.weight.copy_(1 + 0.2 * torch.randn(D, generator=g))
        m.bias.copy_(0.2 * torch.randn(D, generator=g))
    return m.to(device=device, dtype=dtype).requires_grad_(False)


def _x(shape, dtype, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    # a per-row offset and spread, as residual streams have
    rows = torch.randn(*shape[:-1], 1, generator=g)
    x = (torch.randn(shape, generator=g) * (1 + rows.abs() * 3)
         + rows * 5)
    return x.to(device=device, dtype=dtype)


def _reference(m, x):
    """LayerNorm in float64 of x, weight and bias as they are stored."""
    x64 = x.double()
    mu = x64.mean(-1, keepdim=True)
    var = ((x64 - mu) ** 2).mean(-1, keepdim=True)
    return (x64 - mu) / torch.sqrt(var + m.eps) * m.weight.double() \
        + m.bias.double()


def _rowwise_err(got, ref):
    """max |got - ref| of each row over the row's largest |ref|."""
    d = (got.double() - ref).abs().amax(-1)
    return d / ref.abs().amax(-1).clamp_min(1e-30)


def _run(m, x):
    before = ln.layer_norm_rows.launches
    got = ln.layer_norm_rows(m, x)
    torch.cuda.synchronize()
    assert ln.layer_norm_rows.launches == before + 1
    assert got.is_contiguous() and got.dtype == x.dtype
    return got


def _check(m, x, what):
    got = _run(m, x)
    ref = _reference(m, x)
    chain = ln.layer_norm_plain(x, m.weight, m.bias, m.eps)
    err = _rowwise_err(got, ref)
    if x.dtype == torch.float32:
        assert err.max() <= FP32_TOL, (what, float(err.max()))
        assert _rowwise_err(got, chain.double()).max() <= 2 * FP32_TOL
    else:
        bound = BF16_HALF_ULP * ref.abs() + FP32_TOL * \
            ref.abs().amax(-1, keepdim=True)
        bad = (got.double() - ref).abs() > bound
        assert not bad.any(), (what, int(bad.sum()))
        assert err.max() <= _rowwise_err(chain, ref).max(), what
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", WIDTHS)
def test_served_widths(cuda_device, D, dt, eps):
    m = _norm(D, dt, cuda_device, eps)
    x = _x((3, 337, D), dt, cuda_device)
    _check(m, x, f"D={D} {dt} eps={eps}")
    layout = "warp" if D <= 1024 else "block"   # a row within one warp
    before = dict(ln.layer_norm_rows.variant_launches)
    ln.layer_norm_rows(m, x)
    assert ln.layer_norm_rows.variant_launches[layout] == before[layout] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 2, 7, 9, 33, 255, 9801])
@pytest.mark.parametrize("D", [128, 384, 2730])
def test_ragged_row_counts(cuda_device, D, rows, dt):
    """Row counts that fill no whole block (at D <= 1024, 256 / TPR rows a
    block)."""
    m = _norm(D, dt, cuda_device)
    _check(m, _x((rows, D), dt, cuda_device, seed=rows), f"{rows} rows")


@pytest.mark.cuda
@pytest.mark.parametrize("dt,offset,unit", [
    (torch.float32, 0, 8), (torch.float32, 1, 4), (torch.float32, 2, 8),
    (torch.float32, 3, 4), (torch.bfloat16, 0, 4), (torch.bfloat16, 1, 2),
    (torch.bfloat16, 2, 4), (torch.bfloat16, 3, 2)])
def test_2730_rows_at_unaligned_bases(cuda_device, dt, offset, unit):
    """eva02's sub-LN rows (10,920 bytes apart in float32, 5,460 in
    bfloat16) from a base ``offset`` elements past an allocation, read in
    the widest unit that base and rows allow. (A thread's values, and so
    the order of the sums, follow the unit: outputs of two unit widths may
    differ in the last bits.)"""
    m = _norm(2730, dt, cuda_device)
    rows = 300
    buf = _x((rows * 2730 + offset,), dt, cuda_device)
    x = buf[offset:].view(rows, 2730)
    assert ln.unit_bytes(x.element_size(), 2730, rows, 2730, x.data_ptr(),
                         256, 256, 256) == unit
    _check(m, x, f"offset {offset}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("D", [125, 381, 2727])
def test_ragged_widths(cuda_device, D, rows, dt):
    """Widths that no 8-byte unit divides take scalar loads."""
    m = _norm(D, dt, cuda_device)
    x = _x((rows, D), dt, cuda_device)
    assert ln.unit_bytes(x.element_size(), D, rows, D, x.data_ptr(), 256,
                         256, 256) == x.element_size()
    _check(m, x, f"{rows} rows of {D}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_strided_rows(cuda_device, dt):
    """The class token's rows of a (B, N, D) tensor, read in place."""
    m = _norm(384, dt, cuda_device)
    h = _x((64, 197, 384), dt, cuda_device)
    x = h[:, 0]
    assert not x.is_contiguous()
    got = _check(m, x, "class token")
    assert torch.equal(got, _run(m, x.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", WIDTHS)
def test_rows_of_equal_values(cuda_device, D, dt):
    """Variance 0: every value 0.75, whose sums are exact, so x - mu is 0
    and the output is the bias bit for bit. The chain's mean multiplies the
    sum by 1 / D, so it may miss 0.75 by a unit; its output then misses
    the bias by that difference times rsqrt(eps) * |w|."""
    m = _norm(D, dt, cuda_device)
    x = torch.full((5, D), 0.75, dtype=dt, device=cuda_device)
    got = _run(m, x)
    assert torch.equal(got, m.bias.expand(5, D))
    chain = ln.layer_norm_plain(x, m.weight, m.bias, m.eps).double()
    miss = (x.mean(-1, keepdim=True).double() - 0.75).abs()
    bound = 1.01 * miss * m.eps ** -0.5 * m.weight.double().abs() \
        + BF16_HALF_ULP * m.bias.double().abs()
    assert ((chain - m.bias.double()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [384, 2730])
def test_nan_and_inf_as_the_chain(cuda_device, D, dt):
    """Rows holding a NaN, a +Inf, a -Inf, or both infinities come out NaN
    where the chain's do; the clean rows beside them are unharmed."""
    m = _norm(D, dt, cuda_device)
    x = _x((8, D), dt, cuda_device)
    x[1, 5] = float("nan")
    x[2, D - 1] = float("inf")
    x[3, 0] = -float("inf")
    x[4, 7], x[4, 9] = float("inf"), -float("inf")
    x[5, :] = float("nan")
    got = _run(m, x)
    chain = ln.layer_norm_plain(x, m.weight, m.bias, m.eps)
    assert torch.equal(torch.isnan(got), torch.isnan(chain))
    assert torch.isnan(got[1:6]).all()
    clean = [0, 6, 7]
    err = _rowwise_err(got[clean], _reference(m, x[clean]))
    tol = FP32_TOL if dt == torch.float32 else 2 * BF16_HALF_ULP
    assert err.max() <= tol


@pytest.mark.cuda
def test_refusals_raise(cuda_device):
    m = _norm(384, torch.float32, cuda_device)
    x = _x((4, 384), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="not evenly strided"):
        ln.layer_norm_rows(m, x.t().contiguous().t())
    with pytest.raises(ValueError):
        ln.layer_norm_rows(m, x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        ln.layer_norm_rows(m, x[:, :383])
    with pytest.raises(ValueError):
        ln.layer_norm_rows(m, x.to(torch.float16))
    m.weight.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ln.layer_norm_rows(m, x)
    with torch.no_grad():
        _run(m, x)
    wide = _norm(ln.MAX_D + 1, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        ln.layer_norm_rows(wide, _x((2, ln.MAX_D + 1), torch.float32,
                                    cuda_device))


@pytest.mark.cuda
def test_cuda_graph_replay_equals_direct_call(cuda_device):
    m = _norm(1024, torch.float32, cuda_device)
    x = _x((4096, 1024), torch.float32, cuda_device)
    direct = _run(m, x)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        ln.layer_norm_rows(m, x)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = ln.layer_norm_rows(m, x)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, direct)


def _served_state(name):
    from adalog_tpu_torch.calib.init_state import init_qstate
    from adalog_tpu_torch.models import zoo
    from adalog_tpu_torch.utils.config import Config

    spec, model = zoo.build_model(name, seed=0)
    cfg = Config(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)
    return spec, model, init_qstate(spec, cfg, model)


@pytest.mark.cuda
@pytest.mark.parametrize("name,int8,want", SERVED)
def test_served_forward_takes_k7_at_every_norm(cuda_device, monkeypatch,
                                               name, int8, want):
    """The benchmark's models at full width (random weights, an initial
    state, 2 images): K7 once at every LayerNorm, the plain version never."""
    from adalog_tpu_torch.serve import make_predictor

    spec, model, qstate = _served_state(name)
    predict = make_predictor(spec, model, qstate, device=cuda_device,
                             use_int8=int8)
    x = np.random.default_rng(2).standard_normal(
        (2, spec.cfg.img_size, spec.cfg.img_size, 3)).astype(np.float32)
    predict(x)
    plain = []
    monkeypatch.setattr(layers, "layer_norm_plain",
                        lambda *a: plain.append(a) or ln.layer_norm_plain(*a))
    launches = ln.layer_norm_rows.launches
    y = predict(x)
    torch.cuda.synchronize()
    assert ln.layer_norm_rows.launches - launches == want
    assert plain == []
    assert torch.isfinite(y).all()


@pytest.mark.cuda
def test_calibration_and_reconstruction_launch_no_k7(cuda_device):
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
    before = ln.layer_norm_rows.calls
    p, q = QuantCalibrator(spec, model, cfg,
                           device=cuda_device).calibrate([x])
    brecq.BlockReconstructor(spec, p, model, q, quant_layout(spec, cfg), cfg,
                             device=cuda_device).reconstruct([x])
    torch.cuda.synchronize()
    assert ln.layer_norm_rows.calls == before
