"""The CUDA kernel K1 (adalog_tpu_torch/csrc/fq_flash_attn.cu) against its
plain PyTorch version on an NVIDIA GPU. Skipped without a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_fq_attn_cuda.py

Inputs and tolerances are chip_smoke.py's: the two sum in different orders
and log2f/exp2f may differ by an ulp, so a probability near an AdaLog code
boundary may take the neighbouring code; at most FLIP_SHARE of the outputs
may leave ATOL + RTOL*|ref|, none by more than FLIP_MAX.
"""

import pytest
import torch

import chip_smoke
from chip_smoke import ATOL, RTOL, FLIP_SHARE, FLIP_MAX
from adalog_tpu_torch.ops import fq_attn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fq_flash_attn kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(device, G, S, D, P, dtype, with_bias, seed):
    q, kT, v, m1a, m1b, m2q, m2b, bias = chip_smoke.attention_inputs(
        torch, G, S, D, P, seed, device)
    args = [t.to(dtype) for t in (q, kT, v)] + [m1a, m1b, m2q, m2b]
    b = bias if with_bias else None
    kw = dict(m1a_bits=4, m1b_bits=4, m2a_bits=4, m2b_bits=4,
              logit_scale=D ** -0.5)
    before = fq_attn.fq_flash_attn.launches
    got = fq_attn.fq_flash_attn(*args, b, **kw)
    torch.cuda.synchronize()
    assert fq_attn.fq_flash_attn.launches == before + 1
    want = fq_attn.fq_flash_attn_plain(*args, b, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, S, D)
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    assert (diff > ATOL + RTOL * want.abs()).float().mean().item() \
        <= FLIP_SHARE
    assert diff.max().item() <= FLIP_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
def test_kernel_matches_plain_deit_small(cuda_device, dtype, with_bias):
    """deit_small attention: S=197, D=64, 6 heads, batch 2."""
    _kernel_vs_plain(cuda_device, 12, 197, 64, 6, dtype, with_bias, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("G,S,D,P", [
    (6, 16, 8, 3),          # one ragged column chunk, head dim below a warp
    (8, 49, 32, 4),         # a 7x7 Swin window
    (4, 300, 64, 2),        # more than 256 columns: two logit chunks
    (2, 65, 128, 1),        # the widest head dim the kernel takes
])
def test_kernel_matches_plain_shapes(cuda_device, G, S, D, P):
    _kernel_vs_plain(cuda_device, G, S, D, P, torch.float32, True, seed=2)


@pytest.mark.cuda
def test_kernel_refuses_oversized_shapes(cuda_device):
    """S=577 at D=64 does not fit one block's shared memory: the wrapper
    raises before launching."""
    q, kT, v, m1a, m1b, m2q, m2b, _ = chip_smoke.attention_inputs(
        torch, 1, 577, 64, 1, 3, cuda_device)
    before = fq_attn.fq_flash_attn.launches
    with pytest.raises(ValueError):
        fq_attn.fq_flash_attn(q, kT, v, m1a, m1b, m2q, m2b, m1a_bits=4,
                              m1b_bits=4, m2a_bits=4, m2b_bits=4,
                              logit_scale=0.125)
    assert fq_attn.fq_flash_attn.launches == before
