"""The CUDA kernel K4 (adalog_tpu_torch/csrc/fq_gemm.cu) against its plain
PyTorch version on an NVIDIA GPU. Skipped without a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_fq_gemm_cuda.py

Inputs and tolerances are chip_smoke.py's: outputs within ATOL +
GEMM_RTOL[dtype]*|ref| (the two sum in different orders; in bf16 a last-bit
difference may move the rounded output by one bf16 ulp), at most FLIP_SHARE
of them past it and none by more than FLIP_MAX; the quantized activations,
read through an identity weight, equal the plain version's bit for bit for
the uniform kind, and differ in at most FLIP_SHARE for adalog_shift.
"""

import pytest
import torch

import chip_smoke
from chip_smoke import FLIP_MAX, FLIP_SHARE, GEMM_RTOL, GEMM_SHAPES
from adalog_tpu_torch.ops import fq_gemm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fq_gemm kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_vs_plain(device, T, K, O, kind, dt, seed, bits=4, strided=False,
                     log_q=None):
    dtype = getattr(torch, dt)
    x, w, prm, b = chip_smoke.gemm_inputs(torch, T, K, O, kind, seed, device,
                                          bits)
    if log_q is not None:
        prm[3] = log_q
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    if strided:                       # rows of a wider tensor, as the head's
        x = torch.cat([x, x], dim=1)[:, :K]
    kw = dict(kind=kind, bits=bits)
    before = fq_gemm.fq_gemm.launches
    got = fq_gemm.fq_gemm(x, w, prm, **kw)
    got_b = fq_gemm.fq_gemm(x, w, prm, b, **kw)
    xq = fq_gemm.fq_gemm(x, torch.eye(K, dtype=dtype, device=device), prm,
                         **kw)
    torch.cuda.synchronize()
    assert fq_gemm.fq_gemm.launches == before + 3
    want = fq_gemm.fq_gemm_plain(x, w, prm, **kw)
    assert got.dtype == dtype and tuple(got.shape) == (T, O)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got_b, got + b)
    flips = (xq != fq_gemm.quantize_plain(x, prm, **kw).to(dtype)).float()
    if kind == "uniform":
        assert flips.sum().item() == 0
    else:
        assert flips.mean().item() <= FLIP_SHARE
    max_diff, share = chip_smoke.compare(got, want, GEMM_RTOL[dt])
    assert share <= FLIP_SHARE and max_diff <= FLIP_MAX, (max_diff, share)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("site,T,K,O,kind", GEMM_SHAPES)
def test_kernel_matches_plain_deit_small(cuda_device, site, T, K, O, kind,
                                         dt):
    """The five deit_small Linear shapes at batch 32, fc2 in both kinds."""
    _kernel_vs_plain(cuda_device, T, K, O, kind, dt, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["uniform", "adalog_shift"])
@pytest.mark.parametrize("T,K,O,bits,strided", [
    (10, 8, 7, 4, False),       # smaller than one tile in every dimension
    (129, 37, 130, 3, False),   # K off the vector width: masked loads
    (300, 200, 129, 6, False),  # ragged row, column and k tiles
    (1, 384, 1000, 4, True),    # one strided row, the head's shape
])
def test_kernel_matches_plain_ragged(cuda_device, T, K, O, bits, strided,
                                     kind, dt):
    _kernel_vs_plain(cuda_device, T, K, O, kind, dt, seed=2, bits=bits,
                     strided=strided)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("log_q", [1.0, 23.0, 37.0, 74.0, 1108378.0])
def test_kernel_matches_plain_adalog_bases(cuda_device, log_q, dt):
    """AdaLog bases across what ``prepare`` lets through: 1; multiples of
    37 (every code on the mantissa table's entry 0); the largest 4-bit base,
    whose products code * q come near 2^24 and whose shifts pass 2^-126."""
    _kernel_vs_plain(cuda_device, 300, 200, 129, "adalog_shift", dt, seed=4,
                     log_q=log_q)


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs(cuda_device):
    """Inputs on two devices raise before launching."""
    x, w, prm, _ = chip_smoke.gemm_inputs(torch, 8, 16, 8, "uniform", 3,
                                          cuda_device)
    before = fq_gemm.fq_gemm.launches
    with pytest.raises(ValueError):
        fq_gemm.fq_gemm(x, w.cpu(), prm, kind="uniform", bits=4)
    assert fq_gemm.fq_gemm.launches == before
