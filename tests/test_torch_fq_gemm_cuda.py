"""The CUDA kernel K4 (adalog_tpu_torch/csrc/fq_gemm.cu) against its plain
PyTorch version on an NVIDIA GPU. Skipped without a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_fq_gemm_cuda.py

The kernel has two variants ("mma" on the tensor cores, "fma"); bf16 inputs
and fp32 inputs with weight codes route to "mma", a bare fp32 call to "fma",
and each is also forced here on a served (fake-quantized) weight.

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


# ---------------------------------------------------------------------------
# The two variants, forced, on a served weight (fake-quantized, with codes)
# ---------------------------------------------------------------------------

def _inputs(device, T, K, O, kind, dt, seed, bits=4, strided=False,
            log_q=None):
    dtype = getattr(torch, dt)
    x, w, prm, b = chip_smoke.gemm_inputs(torch, T, K, O, kind, seed, device,
                                          bits)
    if log_q is not None:
        prm[3] = log_q
    w, codes = chip_smoke.weight_with_codes(torch, fq_gemm, w)
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    if strided:
        x = torch.cat([x, x], dim=1)[:, :K]
    return x, w, prm, b, codes


def _variant_vs_plain(device, T, K, O, kind, dt, seed, variant, bits=4,
                      strided=False, log_q=None):
    """One forced variant against the plain version on a served weight: the
    launch is counted under the variant, outputs within tolerance, the
    fused bias equal to the add, the quantized activations (through an
    identity weight) those of quantize_plain."""
    if variant == "mma" and kind == "adalog_shift" and dt == "float32":
        bits = min(bits, 7)       # "mma" takes fp32 AdaLog up to 7 bits
    x, w, prm, b, codes = _inputs(device, T, K, O, kind, dt, seed, bits,
                                  strided, log_q)
    kw = dict(kind=kind, bits=bits, variant=variant)
    before = dict(fq_gemm.fq_gemm.variant_launches)
    got = fq_gemm.fq_gemm(x, w, prm, codes=codes, **kw)
    got_b = fq_gemm.fq_gemm(x, w, prm, b, codes=codes, **kw)
    xq = fq_gemm.fq_gemm(
        x, torch.eye(K, dtype=x.dtype, device=device), prm,
        codes=chip_smoke.identity_codes(torch, fq_gemm, K, device), **kw)
    torch.cuda.synchronize()
    before[variant] += 3
    assert fq_gemm.fq_gemm.variant_launches == before
    want = fq_gemm.fq_gemm_plain(x, w, prm, kind=kind, bits=bits)
    assert got.dtype == x.dtype and tuple(got.shape) == (T, O)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got_b, got + b)
    flips = chip_smoke.quantized_x_flips(
        torch, fq_gemm, xq, x, prm, kind, bits,
        variant == "mma" and dt == "float32")
    assert flips == 0 if kind == "uniform" else flips <= FLIP_SHARE, flips
    max_diff, share = chip_smoke.compare(got, want, GEMM_RTOL[dt])
    assert share <= FLIP_SHARE and max_diff <= FLIP_MAX, (max_diff, share)
    return got


SWIN_SHAPES = [("stage 0 qkv", 100352, 96, 288, "uniform"),
               ("stage 3 fc2", 1568, 3072, 768, "uniform"),
               ("stage 3 fc2", 1568, 3072, 768, "adalog_shift")]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mma", "fma"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("site,T,K,O,kind",
                         list(GEMM_SHAPES) + SWIN_SHAPES)
def test_variant_matches_plain(cuda_device, site, T, K, O, kind, dt, variant):
    """Each variant at the deit_small shapes and at swin_tiny's widest and
    deepest Linear."""
    _variant_vs_plain(cuda_device, T, K, O, kind, dt, 5, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["uniform", "adalog_shift"])
@pytest.mark.parametrize("T,K,O,bits,strided", [
    (10, 8, 7, 4, False),       # smaller than one tile in every dimension
    (129, 37, 130, 3, False),   # K off the vector width: element loads
    (300, 200, 129, 6, False),  # ragged row, column and k tiles
    (1, 384, 1000, 4, True),    # one strided row, the head's shape
    (33, 384, 1000, 8, True),   # strided rows past the short tile
    (70, 1100, 50, 7, False),   # wide-N order, element loads, few columns
    (200, 2048, 400, 4, True),  # wide-N order, two column groups, strided
])
def test_mma_matches_plain_ragged(cuda_device, T, K, O, bits, strided, kind,
                                  dt):
    _variant_vs_plain(cuda_device, T, K, O, kind, dt, 6, "mma", bits=bits,
                      strided=strided)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,K,O,kind", [(100, 384, 130, "uniform"),
                                        (100, 2048, 384, "adalog_shift")])
def test_mma_takes_misaligned_rows(cuda_device, T, K, O, kind, dt):
    """x rows that start one element off a 16-byte boundary: x goes element
    by element while w keeps its 16-byte copies, in both loop orders."""
    x, w, prm, b, codes = _inputs(cuda_device, T, K, O, kind, dt, 11)
    x = torch.cat([x[:, :1], x], dim=1)[:, 1:]
    assert x.data_ptr() % 16 != 0 and x.stride(0) == K + 1
    got = fq_gemm.fq_gemm(x, w, prm, b, kind=kind, bits=4, variant="mma",
                          codes=codes)
    torch.cuda.synchronize()
    want = fq_gemm.fq_gemm_plain(x, w, prm, b, kind=kind, bits=4)
    max_diff, share = chip_smoke.compare(got, want, GEMM_RTOL[dt])
    assert share <= FLIP_SHARE and max_diff <= FLIP_MAX, (max_diff, share)


@pytest.mark.cuda
@pytest.mark.parametrize("log_q", [1.0, 23.0, 37.0, 74.0, 1108378.0])
def test_mma_fp32_matches_plain_adalog_bases(cuda_device, log_q):
    _variant_vs_plain(cuda_device, 300, 200, 129, "adalog_shift", "float32", 4,
                      "mma", log_q=log_q)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("site,T,K,O,kind", GEMM_SHAPES)
def test_mma_matches_fma(cuda_device, site, T, K, O, kind, dt):
    """The two variants on the same inputs land within the tolerance each
    has to the plain version."""
    x, w, prm, b, codes = _inputs(cuda_device, T, K, O, kind, dt, 7)
    out = {v: fq_gemm.fq_gemm(x, w, prm, b, kind=kind, bits=4, variant=v,
                              codes=codes) for v in ("mma", "fma")}
    torch.cuda.synchronize()
    max_diff, share = chip_smoke.compare(out["mma"], out["fma"],
                                         GEMM_RTOL[dt])
    assert share <= FLIP_SHARE and max_diff <= FLIP_MAX, (max_diff, share)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["no codes", "9 bits", "8-bit AdaLog",
                                  "zero point 400"])
def test_inexact_integers_never_reach_mma(cuda_device, what):
    """fp32 inputs whose staged integers would not be exact in bf16 launch
    "fma" under "auto", and a forced "mma" raises before any launch."""
    kind = "adalog_shift" if what == "8-bit AdaLog" else "uniform"
    bits = {"9 bits": 9, "8-bit AdaLog": 8}.get(what, 4)
    x, w, prm, b, codes = _inputs(cuda_device, 64, 64, 40, kind, "float32", 8,
                                  bits=bits)
    if what == "zero point 400":
        prm[1] = 400.0
    if what == "no codes":
        codes = None
    before = dict(fq_gemm.fq_gemm.variant_launches)
    got = fq_gemm.fq_gemm(x, w, prm, b, kind=kind, bits=bits, codes=codes)
    with pytest.raises(ValueError, match="refused"):
        fq_gemm.fq_gemm(x, w, prm, b, kind=kind, bits=bits, codes=codes,
                        variant="mma")
    torch.cuda.synchronize()
    before["fma"] += 1
    assert fq_gemm.fq_gemm.variant_launches == before
    want = fq_gemm.fq_gemm_plain(x, w, prm, b, kind=kind, bits=bits)
    max_diff, share = chip_smoke.compare(got, want, GEMM_RTOL["float32"])
    assert share <= FLIP_SHARE and max_diff <= FLIP_MAX, (max_diff, share)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_codes", [True, False])
def test_served_call_takes_the_tables_variant(cuda_device, dt, with_codes):
    """``run`` on a table entry launches the variant the entry names (fp32
    without codes: "fma") and returns what ``fq_gemm`` returns."""
    x, w, prm, b, codes = _inputs(cuda_device, 197, 384, 384, "uniform", dt, 9)
    exact = fq_gemm.activation_ints_exact(prm, "uniform", 4)
    site = fq_gemm.GemmSite("uniform", 4, prm, codes if with_codes else None,
                            with_codes and exact)
    want_variant = "mma" if dt == "bfloat16" or with_codes else "fma"
    assert site.variant(x.dtype) == want_variant
    before = dict(fq_gemm.fq_gemm.variant_launches)
    got = fq_gemm.run(site, x, w, b)
    torch.cuda.synchronize()
    before[want_variant] += 1
    assert fq_gemm.fq_gemm.variant_launches == before
    assert torch.equal(got, fq_gemm.fq_gemm(
        x, w, prm, b, kind="uniform", bits=4, variant=want_variant,
        codes=site.codes))


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,O,kind", [(6304, 384, 1152, "uniform"),
                                        (6304, 1536, 384, "adalog_shift")])
def test_instrumented_build_counts_phases(cuda_device, T, K, O, kind):
    """The second build of the kernel (K4_PROFILE) launches and counts
    cycles in the phases of its order: the wide-N order has a quantizer
    phase in its loop, the x-resident order quantizes in its set-up."""
    x, w, prm, b, codes = _inputs(cuda_device, T, K, O, kind, "float32", 10)
    cycles = fq_gemm.gemm_phase_cycles(x, w, prm, b, kind=kind, bits=4,
                                       codes=codes)
    assert tuple(cycles) == fq_gemm.GEMM_PHASES
    quantizer = cycles[fq_gemm.GEMM_PHASES[4]]
    assert (quantizer > 0) == (K > 1024)
    assert all(c > 0 for k, c in cycles.items()
               if k != fq_gemm.GEMM_PHASES[4])
    with pytest.raises(ValueError, match="refused"):
        fq_gemm.gemm_phase_cycles(x, w, prm, b, kind=kind, bits=4)
