"""The CUDA kernel K1 (adalog_tpu_torch/csrc/fq_flash_attn.cu), both of its
variants, against its plain PyTorch version on an NVIDIA GPU, and the
patch-embed convolution's fp32 precision. Skipped without a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_fq_attn_cuda.py

Inputs and tolerances are chip_smoke.py's: kernel and plain version sum in
different orders (variant "mma" on the tensor cores, with exact integer sums
for fp32 inputs) and log2f/exp2f may differ by an ulp, so a probability near
an AdaLog code boundary may take the neighbouring code; at most FLIP_SHARE
of the outputs may leave ATOL + RTOL*|ref|, none by more than one
probability times the largest |uq(v)| (chip_smoke.flash_cap).
"""

import pytest
import torch

import chip_smoke
from chip_smoke import ATOL, RTOL, FLIP_SHARE
from adalog_tpu_torch.models.layers import qconv2d
from adalog_tpu_torch.ops import fq_attn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fq_flash_attn kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _case(device, G, S, D, P, dtype, with_bias, seed, bits=4, frac_base=False):
    q, kT, v, m1a, m1b, m2q, m2b, bias = chip_smoke.attention_inputs(
        torch, G, S, D, P, seed, device, bits)
    if frac_base:                     # bases that are not integers
        m2q = m2q + 0.5 * (torch.arange(G, device=device) % 2) + 0.25
    args = [t.to(dtype) for t in (q, kT, v)] + [m1a, m1b, m2q, m2b]
    # fp32 inputs of variant "mma": the probabilities' codes up to 7 bits
    kw = dict(m1a_bits=bits, m1b_bits=bits, m2a_bits=min(bits, 7),
              m2b_bits=bits, logit_scale=D ** -0.5)
    return args, (bias if with_bias else None), kw


def _hold(got, want, cap):
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    share = (diff > ATOL + RTOL * want.abs()).float().mean().item()
    assert share <= FLIP_SHARE, share
    assert diff.max().item() <= cap, (diff.max().item(), cap)


def _kernel_vs_plain(device, G, S, D, P, dtype, with_bias, seed,
                     variant="auto", took=None, **case_kw):
    """One call of ``variant`` against the plain version; ``took`` is the
    variant that must have been launched."""
    args, b, kw = _case(device, G, S, D, P, dtype, with_bias, seed, **case_kw)
    before = fq_attn.fq_flash_attn.launches
    by_variant = dict(fq_attn.fq_flash_attn.variant_launches)
    got = fq_attn.fq_flash_attn(*args, b, variant=variant, **kw)
    torch.cuda.synchronize()
    assert fq_attn.fq_flash_attn.launches == before + 1
    took = took or variant
    if took != "auto":
        by_variant[took] += 1
        assert fq_attn.fq_flash_attn.variant_launches == by_variant
    want = fq_attn.fq_flash_attn_plain(*args, b, **kw)
    assert tuple(got.shape) == (G, S, D)
    _hold(got, want, chip_smoke.flash_cap(torch, args[2], args[6],
                                          kw["m2b_bits"]))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mma", "fma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
def test_kernel_matches_plain_deit_small(cuda_device, dtype, with_bias,
                                         variant):
    """deit_small attention: S=197, D=64, 6 heads, batch 2."""
    _kernel_vs_plain(cuda_device, 12, 197, 64, 6, dtype, with_bias, seed=1,
                     variant=variant)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mma", "fma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,P", [
    (384, 192),             # stage 0: 64 windows x 3 heads, 2 images
    (96, 24),               # stage 3: 1 window x 24 heads, 4 images
    (27, 9),                # an odd count of slices
])
def test_kernel_matches_plain_swin_tiny(cuda_device, G, P, dtype, variant):
    """swin_tiny windows: S=49, D=32, the rel-pos bias of period P."""
    _kernel_vs_plain(cuda_device, G, 49, 32, P, dtype, True, seed=4,
                     variant=variant)


@pytest.mark.cuda
@pytest.mark.parametrize("G,S,D,P", [
    (6, 16, 8, 3),          # one ragged column chunk, head dim below a warp
    (8, 49, 32, 4),         # a 7x7 Swin window
    (4, 300, 64, 2),        # more than 256 columns: two logit chunks
    (2, 65, 128, 1),        # the widest head dim the kernel takes
])
def test_kernel_matches_plain_shapes(cuda_device, G, S, D, P):
    _kernel_vs_plain(cuda_device, G, S, D, P, torch.float32, True, seed=2,
                     variant="fma")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,S,D,P", [
    (6, 16, 8, 3),          # one row tile a slice, 4 slices a block
    (5, 50, 24, 5),         # ragged rows, columns and head dim
    (3, 50, 25, 1),         # an odd head dim: scalar stores
    (4, 100, 64, 2),        # 16 n8 tiles of logits, 7 row tiles
    (4, 200, 64, 2),        # 25 n8 tiles, none padded; two blocks a slice
    (3, 256, 64, 3),        # the longest row "mma" holds in registers
    (2, 65, 128, 1),        # the widest head dim
    (2, 256, 128, 2),       # both at once
])
def test_mma_matches_plain_shapes(cuda_device, G, S, D, P, dtype):
    _kernel_vs_plain(cuda_device, G, S, D, P, dtype, True, seed=5,
                     variant="mma")
    _kernel_vs_plain(cuda_device, G, S, D, P, dtype, False, seed=6,
                     variant="auto", took="mma")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [257, 300])
def test_auto_takes_fma_past_256_columns(cuda_device, S, dtype):
    """Past 256 columns "auto" takes "fma" where the long row of "mma"
    does not apply (fp32 operands of 9 bits; 512 AdaLog codes), and "fma"
    forced holds to the plain version where "mma" would take the call."""
    _kernel_vs_plain(cuda_device, 4, S, 64, 2, dtype, True, seed=7,
                     variant="fma")
    args, b, kw = _case(cuda_device, 4, S, 64, 2, dtype, True, 7)
    kw = dict(kw, m1b_bits=9) if dtype == torch.float32 \
        else dict(kw, m2a_bits=9)
    before = dict(fq_attn.fq_flash_attn.variant_launches)
    got = fq_attn.fq_flash_attn(*args, b, **kw)
    torch.cuda.synchronize()
    assert fq_attn.fq_flash_attn.variant_launches == \
        dict(before, fma=before["fma"] + 1)
    _hold(got, fq_attn.fq_flash_attn_plain(*args, b, **kw),
          chip_smoke.flash_cap(torch, args[2], args[6], kw["m2b_bits"]))
    with pytest.raises(ValueError):
        fq_attn.fq_flash_attn(*args, b, variant="mma", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mma", "fma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [3, 4, 6, 8])
def test_kernel_matches_plain_bits(cuda_device, bits, dtype, variant):
    _kernel_vs_plain(cuda_device, 6, 197, 64, 6, dtype, True, seed=8 + bits,
                     variant=variant, bits=bits)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mma", "fma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_fractional_base(cuda_device, dtype, variant):
    """AdaLog bases that are not integers: the code table is filled by the
    float arithmetic of the per-probability quantizer."""
    _kernel_vs_plain(cuda_device, 8, 49, 32, 4, dtype, True, seed=13,
                     variant=variant, frac_base=True)
    _kernel_vs_plain(cuda_device, 6, 197, 64, 6, dtype, False, seed=14,
                     variant=variant, frac_base=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,S,D,P", [(12, 197, 64, 6), (96, 49, 32, 24)])
def test_mma_matches_fma(cuda_device, G, S, D, P, dtype):
    """The two variants on the same inputs, to the tolerance each is held
    to against the plain version."""
    args, b, kw = _case(cuda_device, G, S, D, P, dtype, True, 15)
    mma = fq_attn.fq_flash_attn(*args, b, variant="mma", **kw)
    fma = fq_attn.fq_flash_attn(*args, b, variant="fma", **kw)
    torch.cuda.synchronize()
    _hold(mma, fma, chip_smoke.flash_cap(torch, args[2], args[6], 4))


@pytest.mark.cuda
def test_inexact_integers_never_reach_mma(cuda_device):
    """fp32 inputs whose integers c - z are not exact in bf16 (a zero point
    of 400; 9-bit operands; 8-bit probabilities) take "fma" under "auto",
    and a forced "mma" raises without launching."""
    args, b, kw = _case(cuda_device, 6, 49, 32, 3, torch.float32, True, 16)
    far = [a.clone() for a in args]
    far[3][1, 1] = 400.0
    cases = [(far, kw), (args, dict(kw, m1b_bits=9)), (args, dict(kw, m2a_bits=8))]
    for a, k in cases:
        before = dict(fq_attn.fq_flash_attn.variant_launches)
        got = fq_attn.fq_flash_attn(*a, b, **k)
        torch.cuda.synchronize()
        assert fq_attn.fq_flash_attn.variant_launches == \
            dict(before, fma=before["fma"] + 1)
        want = fq_attn.fq_flash_attn_plain(*a, b, **k)
        _hold(got, want, chip_smoke.flash_cap(torch, a[2], a[6], k["m2b_bits"]))
        with pytest.raises(ValueError):
            fq_attn.fq_flash_attn(*a, b, variant="mma", **k)
        # a caller's verdict is taken at its word only towards "fma"
        with pytest.raises(ValueError):
            fq_attn.fq_flash_attn(*a, b, variant="mma", exact_ints=False, **k)
        assert fq_attn.fq_flash_attn.variant_launches == \
            dict(before, fma=before["fma"] + 1)


@pytest.mark.cuda
def test_kernel_refuses_oversized_shapes(cuda_device):
    """S=577 at D=64 does not fit one block's shared memory of "fma": a
    forced "fma" raises before launching; at D=128 the long row of "mma"
    does not take it either, and "auto" raises before launching."""
    kw = dict(m1a_bits=4, m1b_bits=4, m2a_bits=4, m2b_bits=4,
              logit_scale=0.125)
    before = fq_attn.fq_flash_attn.launches
    for D, variant in ((64, "fma"), (128, "auto")):
        q, kT, v, m1a, m1b, m2q, m2b, _ = chip_smoke.attention_inputs(
            torch, 1, 577, D, 1, 3, cuda_device)
        with pytest.raises(ValueError):
            fq_attn.fq_flash_attn(q, kT, v, m1a, m1b, m2q, m2b,
                                  variant=variant, **kw)
    assert fq_attn.fq_flash_attn.launches == before


def _untied_rows(args, b, kw, window=2e-4):
    """(G, S) True where no post-softmax AdaLog code of the plain version's
    row lies within ``window`` code units of a rounding boundary that
    changes its value (as portbench/reference.py's adalog_ties): a last-bit
    difference of the probability may round such a code either way."""
    q, kT, v, m1a, m1b, m2q, m2b = args

    def per_g(a):
        return a.float().reshape(-1, 1, 1)

    qf = fq_attn._uq(q.float(), per_g(m1a[:, 0]), per_g(m1a[:, 1]),
                     kw["m1a_bits"])
    kf = fq_attn._uq(kT.float(), per_g(m1b[:, 0]), per_g(m1b[:, 1]),
                     kw["m1b_bits"])
    cd = q.dtype
    l = torch.matmul(qf.to(cd).float(), kf.to(cd).float()) * kw["logit_scale"]
    if b is not None:
        P = b.shape[0]
        l = (l.reshape(-1, P, *l.shape[1:]) + b.float()).reshape(l.shape)
    p = torch.softmax(l.double(), dim=-1)
    code = -torch.log2(p.clamp(min=1e-15)) * (37.0 / per_g(m2q).double())
    tied = ((code - code.floor() - 0.5).abs() < window) \
        & (code < 2.0 ** kw["m2a_bits"])
    return ~tied.any(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("G,S,D", [
    (4, 257, 64),           # one column past the short row; 5 key tiles
    (3, 577, 64),           # 24 x 24 patches + cls
    (2, 1025, 64),          # EVA-02 at 448 px: 32 x 32 patches + cls
    (3, 300, 32),           # a narrower head
    (2, 333, 40),           # a ragged head dim, padded to 64
])
def test_long_row_matches_plain(cuda_device, G, S, D, dtype, with_bias):
    """Past 256 columns "auto" takes the long row of "mma": one launch a
    call, counted under "mma" and in ``long_row_launches``. On every query
    row without a tied AdaLog code its output equals the plain version's to
    ATOL + RTOL |ref|; a tied row may take the neighbouring code (a row of
    up to 1,025 probabilities, and few rows: the share of flipped outputs
    that the shorter cases bound is not a fair test here), by at most a
    flipped code's worth."""
    args, b, kw = _case(cuda_device, G, S, D, 2 - G % 2, dtype, with_bias,
                        30 + S)
    before = (fq_attn.fq_flash_attn.launches,
              dict(fq_attn.fq_flash_attn.variant_launches),
              fq_attn.fq_flash_attn.long_row_launches)
    got = fq_attn.fq_flash_attn(*args, b, **kw)
    torch.cuda.synchronize()
    launches, by_variant, long_rows = before
    assert fq_attn.fq_flash_attn.launches == launches + 1
    assert fq_attn.fq_flash_attn.variant_launches == \
        dict(by_variant, mma=by_variant["mma"] + 1)
    assert fq_attn.fq_flash_attn.long_row_launches == long_rows + 1
    want = fq_attn.fq_flash_attn_plain(*args, b, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= chip_smoke.flash_cap(
        torch, args[2], args[6], kw["m2b_bits"])
    keep = _untied_rows(args, b, kw)
    assert keep.float().mean().item() > 0.5
    diff = (got - want).abs()[keep]
    assert bool((diff <= ATOL + RTOL * want.abs()[keep]).all()), \
        diff.max().item()


@pytest.mark.cuda
def test_short_rows_never_take_the_long_row(cuda_device):
    """S <= 256 takes the kernel of the short row: the long-row counter
    does not move."""
    before = fq_attn.fq_flash_attn.long_row_launches
    for G, S, D in ((12, 197, 64), (8, 49, 32), (3, 256, 64)):
        _kernel_vs_plain(cuda_device, G, S, D, 1, torch.float32, False,
                         seed=40 + S, variant="auto", took="mma")
    assert fq_attn.fq_flash_attn.long_row_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("process_tf32", [True, False])
def test_qconv2d_fp32_is_exact_whatever_cudnn_allows(cuda_device,
                                                     process_tf32):
    """The patch-embed convolution on fp32 CUDA inputs equals a float64
    reference to 1e-5 relative with cuDNN's TF32 allowed for the process
    (TF32 keeps about 1e-3), and leaves the process's setting as it was."""
    g = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(3, 384, 16, stride=16)
    x = torch.randn(8, 224, 224, 3, generator=g)
    with torch.no_grad():
        want = torch.nn.functional.conv2d(
            x.double().permute(0, 3, 1, 2), conv.weight.double(),
            conv.bias.double(), stride=16).permute(0, 2, 3, 1)
    conv = conv.to(cuda_device)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = process_tf32
    try:
        with torch.no_grad():
            got = qconv2d(conv, None, x.to(cuda_device))
        assert torch.backends.cudnn.allow_tf32 is process_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = was
    err = (got.double().cpu() - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-5, err.item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phase_cycles_of_the_instrumented_build(cuda_device, dtype):
    """The second build of the kernel, which counts its warps' cycles by
    phase: every phase ran, and the AdaLog arithmetic is not the least."""
    args, b, kw = _case(cuda_device, 12, 197, 64, 6, dtype, True, 17)
    before = fq_attn.fq_flash_attn.variant_launches["mma"]
    cycles = fq_attn.flash_phase_cycles(*args, b, **kw)
    assert fq_attn.fq_flash_attn.variant_launches["mma"] == before + 1
    assert tuple(cycles) == fq_attn.FLASH_PHASES
    assert all(c > 0 for c in cycles.values())
    assert cycles["AdaLog codes and values"] > cycles["store"]
    far = [a.clone() for a in args]
    far[4][0, 1] = 400.0
    if dtype == torch.float32:           # never "mma" past the exact range
        with pytest.raises(ValueError):
            fq_attn.flash_phase_cycles(*far, b, **kw)
