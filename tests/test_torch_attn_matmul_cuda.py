"""The CUDA kernels K2 and K3 (adalog_tpu_torch/csrc/fq_attn_matmul.cu)
against their plain PyTorch versions on an NVIDIA GPU. Skipped without a
CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_attn_matmul_cuda.py

Inputs and tolerances are chip_smoke.py's: kernel and plain version sum in
different orders and log2f/exp2f/expf may differ by an ulp, so a probability
near an AdaLog code boundary may take the neighbouring code; at most
FLIP_SHARE of the outputs may leave ATOL + RTOL*|ref|, none by more than
FLIP_MAX.
"""

import pytest
import torch

import chip_smoke
from chip_smoke import ATOL, RTOL, FLIP_SHARE, FLIP_MAX
from adalog_tpu_torch.ops import fq_attn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fq_attn_matmul kernels have no "
                    "CPU mode")
    return torch.device("cuda")


CASES = ("K3 uniform A (q @ kT)", "K3 AdaLog A (probs @ v)",
         "K2 (softmax, AdaLog, @ v)")


def _kernel_vs_plain(device, case, G, S, D, dtype, seed):
    cases, _ = chip_smoke.matmul_cases(torch, fq_attn, G, S, D, seed, device,
                                       dtype)
    fn, plain, args, kw = cases[case]
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args, **kw)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (G, S, args[1].shape[2])
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    assert (diff > ATOL + RTOL * want.abs()).float().mean().item() \
        <= FLIP_SHARE
    assert diff.max().item() <= FLIP_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_deit_small(cuda_device, case, dtype):
    """deit_small attention: S=197, D=64, 6 heads, batch 2; q @ kT writes
    197 columns, more than a warp's 32 lanes hold at 4 a lane."""
    _kernel_vs_plain(cuda_device, case, 12, 197, 64, dtype, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_swin_window(cuda_device, case, dtype):
    """A 7x7 Swin window at head dim 32, 3 heads, 64 windows, batch 2."""
    _kernel_vs_plain(cuda_device, case, 384, 49, 32, dtype, seed=2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("G,S,D", [
    (6, 16, 8),             # head dim below a warp, one short tile
    (3, 144, 32),           # a 12x12 window: three tiles of 48 rows
    (2, 300, 64),           # more than 256 columns: two output passes
    (5, 1, 40),             # one row a slice: one warp a block
])
def test_kernel_matches_plain_shapes(cuda_device, case, G, S, D):
    _kernel_vs_plain(cuda_device, case, G, S, D, torch.float32, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [3, 6, 8])
def test_kernel_matches_plain_bits(cuda_device, bits):
    """Other bit widths than 4 in both quantizers of each call."""
    q, kT, v, m1a, m1b, m2q, m2b, _ = chip_smoke.attention_inputs(
        torch, 8, 49, 32, 1, 4, cuda_device, bits)
    m2a = torch.stack([m2q, torch.zeros_like(m2q)], dim=1)
    probs = torch.softmax(torch.matmul(q, kT) * 32 ** -0.5, dim=-1)
    for fn, plain, args, kw in (
            (fq_attn.fq_attn_matmul, fq_attn.fq_attn_matmul_plain,
             (q, kT, m1a, m1b), dict(a_kind="uniform")),
            (fq_attn.fq_attn_matmul, fq_attn.fq_attn_matmul_plain,
             (probs, v, m2a, m2b), dict(a_kind="adalog")),
            (fq_attn.fq_softmax_attn_matmul,
             fq_attn.fq_softmax_attn_matmul_plain,
             (torch.matmul(q, kT) * 32 ** -0.5, v, m2a, m2b), {})):
        got = fn(*args, a_bits=bits, b_bits=bits, **kw)
        want = plain(*args, a_bits=bits, b_bits=bits, **kw)
        diff = (got - want).abs()
        assert (diff > ATOL + RTOL * want.abs()).float().mean().item() \
            <= FLIP_SHARE
        assert diff.max().item() <= FLIP_MAX


@pytest.mark.cuda
def test_softmax_kernel_lands_on_flash_kernel(cuda_device):
    """K2 on the logits of the plain matmul1 gives K1's output on the same
    q, kT, v, within the kernels' own bounds."""
    G, S, D = 12, 197, 64
    q, kT, v, m1a, m1b, m2q, m2b, _ = chip_smoke.attention_inputs(
        torch, G, S, D, 1, 5, cuda_device)
    cases, _ = chip_smoke.matmul_cases(torch, fq_attn, G, S, D, 5,
                                       cuda_device, torch.float32)
    _, _, args, kw = cases[CASES[2]]
    k2 = fq_attn.fq_softmax_attn_matmul(*args, **kw)
    k1 = fq_attn.fq_flash_attn(q, kT, v, m1a, m1b, m2q, m2b, m1a_bits=4,
                               m1b_bits=4, m2a_bits=4, m2b_bits=4,
                               logit_scale=D ** -0.5)
    diff = (k2 - k1).abs()
    assert (diff > ATOL + RTOL * k1.abs()).float().mean().item() <= FLIP_SHARE
    assert diff.max().item() <= FLIP_MAX


@pytest.mark.cuda
def test_kernel_refuses_oversized_shapes(cuda_device):
    """B of one slice at K=S=577, C=128 does not fit one block's shared
    memory: the wrapper raises before launching."""
    A = torch.rand(1, 577, 577, device=cuda_device)
    B = torch.rand(1, 577, 128, device=cuda_device)
    prm = torch.tensor([[29.0, 0.0]], device=cuda_device)
    before = fq_attn.fq_attn_matmul.launches
    with pytest.raises(ValueError):
        fq_attn.fq_attn_matmul(A, B, prm, prm, a_kind="adalog", a_bits=4,
                               b_bits=4)
    assert fq_attn.fq_attn_matmul.launches == before


@pytest.mark.cuda
def test_run_dispatch_on_device(cuda_device):
    """run / run_softmax with per-head site state on 4-D CUDA operands
    launch the kernels and return the operand's dtype."""
    from adalog_tpu_torch.models.layers import MatMulSite
    from adalog_tpu_torch.quantizers.state import QuantizerState

    N, H, S, D = 2, 3, 49, 32
    g = torch.Generator().manual_seed(0)
    probs = torch.softmax(4 * torch.randn(N, H, S, S, generator=g), -1)
    v = torch.randn(N, H, S, D, generator=g)
    site = MatMulSite(
        Aq=QuantizerState(scale=torch.ones(1, 1, 1, 1),
                          log_q=torch.tensor(29.0), kind="adalog", bits=4),
        Bq=QuantizerState(scale=torch.full((1, H, 1, 1), 0.4),
                          zero_point=torch.full((1, H, 1, 1), 7.0),
                          kind="uniform", bits=4))
    want = fq_attn.run(site, probs, v)                  # CPU: plain version
    before = fq_attn.fq_attn_matmul.launches
    dev_site = MatMulSite(
        Aq=QuantizerState(scale=site.Aq.scale.to(cuda_device),
                          log_q=site.Aq.log_q.to(cuda_device), kind="adalog",
                          bits=4),
        Bq=QuantizerState(scale=site.Bq.scale.to(cuda_device),
                          zero_point=site.Bq.zero_point.to(cuda_device),
                          kind="uniform", bits=4))
    got = fq_attn.run(dev_site, probs.to(cuda_device), v.to(cuda_device))
    assert fq_attn.fq_attn_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (N, H, S, D)
    diff = (got.cpu() - want).abs()
    assert (diff > ATOL + RTOL * want.abs()).float().mean().item() \
        <= FLIP_SHARE
