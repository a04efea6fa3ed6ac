"""The CUDA kernel K5 (adalog_tpu_torch/csrc/int8_gemm.cu) against its plain
PyTorch version on an NVIDIA GPU. Skipped without a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_int8_cuda.py

The integer sum is exact in both, and both round the same fp32 epilogue
(the sum to float, times the row scale, plus the bias, one cast), so the
kernel equals its plain version bit for bit, in float32 and bfloat16, at
the Linear shapes of deit_small and deit_base at batch 32 and at ragged
ones. A CUDA call the kernel does not take raises; a reconstruction inside
a predictor's int8 table launches no kernel.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import INT8_SHAPES
from adalog_tpu_torch.calib.calibrator import QuantCalibrator
from adalog_tpu_torch.calib.layout import quant_layout
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.ops import fq_attn, fq_gemm, int8_linear
from adalog_tpu_torch.recon import brecq
from adalog_tpu_torch.utils.config import Config


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8 GEMM kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _kernel_vs_plain(device, T, K, O, dt, seed, bits=4, strided=False,
                     bias=True):
    dtype = getattr(torch, dt)
    x, w_int, a_params, scale_row, b = chip_smoke.int8_inputs(
        torch, T, K, O, seed, device, bits)
    x, b = x.to(dtype), b.to(dtype) if bias else None
    if strided:                      # rows of a wider tensor
        x = torch.cat([x, x], dim=1)[:, :K]
    before = int8_linear.int8_gemm.launches
    got = int8_linear.int8_gemm(x, w_int, a_params, scale_row, b, bits=bits)
    torch.cuda.synchronize()
    assert int8_linear.int8_gemm.launches == before + 1
    want = int8_linear.int8_gemm_plain(x, w_int, a_params, scale_row, b,
                                       bits=bits)
    assert got.dtype == dtype and tuple(got.shape) == (T, O)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("site,T,K,O", INT8_SHAPES)
def test_kernel_equals_plain_at_model_shapes(cuda_device, site, T, K, O, dt):
    """deit_small's and deit_base's int8 sites at batch 32, the ragged
    cases of chip_smoke.py."""
    _kernel_vs_plain(cuda_device, T, K, O, dt, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,K,O,bits,strided,bias", [
    (10, 8, 7, 4, False, True),      # smaller than one tile everywhere
    (1, 24, 9, 3, False, False),     # one row, K not a multiple of 16
    (129, 100, 130, 6, False, True),  # one past a tile, K a 4th of 16
    (200, 40, 33, 7, True, True),    # strided rows, odd O, 7 bits
    (64, 1000, 5, 4, False, True),   # K past a stage many times, odd
])
def test_kernel_equals_plain_ragged(cuda_device, T, K, O, bits, strided,
                                    bias, dt):
    _kernel_vs_plain(cuda_device, T, K, O, dt, seed=2, bits=bits,
                     strided=strided, bias=bias)


@pytest.mark.cuda
def test_unsupported_cuda_calls_raise(cuda_device):
    x, w_int, a_params, scale_row, b = chip_smoke.int8_inputs(
        torch, 16, 32, 8, 3, cuda_device)
    with pytest.raises(TypeError):
        int8_linear.int8_gemm(x.half(), w_int, a_params, scale_row,
                              bits=4)
    with pytest.raises(TypeError):
        int8_linear.int8_gemm(x, w_int, a_params, scale_row, b.double(),
                              bits=4)
    with pytest.raises(ValueError):
        int8_linear.int8_gemm(x, w_int, a_params.cpu(), scale_row, bits=4)
    with pytest.raises(ValueError):
        int8_linear.int8_gemm(x, w_int, a_params, scale_row, bits=8)
    with pytest.raises(ValueError):
        int8_linear.int8_gemm(x[:, :16], w_int, a_params, scale_row, bits=4)


@pytest.mark.cuda
def test_reconstruction_inside_the_int8_table_launches_nothing(cuda_device):
    """A whole reconstruction inside every kernel context of a predictor,
    the int8 table's included, launches no kernel; the eval forward in the
    same contexts launches K5 at every int8 site."""
    spec, model = zoo.build_model("test_tiny", seed=0)
    x = np.random.default_rng(3).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    cfg = Config(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4, eq_n=32, steps=2,
                 search_round=1, fpcs=True, recon_iters=20,
                 optim_batch_size=8)
    p, q = QuantCalibrator(spec, model, cfg, device="cpu").calibrate([x])
    r = brecq.BlockReconstructor(spec, p, model, q, quant_layout(spec, cfg),
                                 cfg, device=cuda_device)
    qs = r.qstate
    table = int8_linear.prepare(spec, r.params, qs, cfg)
    chip_smoke.zero_launches(fq_attn, fq_gemm)
    xt = torch.from_numpy(x).to(cuda_device)
    with torch.no_grad(), int8_linear.activate(table), \
            fq_attn.activate(True, fq_attn.integers_exact(qs),
                             fq_attn.prepare(qs)), \
            fq_gemm.activate(fq_gemm.prepare(qs, skip=set(table))):
        zoo.model_forward_fn(spec)(spec.cfg, r.params, xt, qs,
                                   {"*": "quant"})
        served = chip_smoke.read_launches(fq_attn, fq_gemm)
        chip_smoke.zero_launches(fq_attn, fq_gemm)
        with torch.enable_grad():
            r.reconstruct([x])
        got = chip_smoke.read_launches(fq_attn, fq_gemm)
    assert served["K5"] == len(table) > 0 and served["K1"] == 2, served
    assert not any(got.values()), got
