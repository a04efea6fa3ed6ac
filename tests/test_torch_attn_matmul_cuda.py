"""The CUDA kernels K2 and K3 (adalog_tpu_torch/csrc/fq_attn_matmul.cu)
against their plain PyTorch versions on an NVIDIA GPU. Skipped without a
CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_attn_matmul_cuda.py

Inputs and tolerances are chip_smoke.py's: kernel and plain version sum in
different orders and log2f/exp2f/expf may differ by an ulp, so a probability
near an AdaLog code boundary may take the neighbouring code; at most
FLIP_SHARE of the outputs may leave ATOL + RTOL*|ref|, none by more than a
flipped code can move it (chip_smoke.matmul_cap: one probability times the
largest |uq(B)|; with uniform A, where no code can flip, the rounding of
the sums).

Both variants of the kernels are driven: "mma" (tensor cores) as the
wrappers route it and forced, "fma" forced and where "mma" refuses.
"""

import pytest
import torch

import chip_smoke
from chip_smoke import ATOL, RTOL, FLIP_SHARE
from adalog_tpu_torch.ops import fq_attn, routes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fq_attn_matmul kernels have no "
                    "CPU mode")
    return torch.device("cuda")


CASES = ("K3 uniform A (q @ kT)", "K3 AdaLog A (probs @ v)",
         "K2 (softmax, AdaLog, @ v)")


def _held(got, want, args, kw):
    """got within tolerance of want but for FLIP_SHARE of the outputs, and
    none further than the data allows."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    assert (diff > ATOL + RTOL * want.abs()).float().mean().item() \
        <= FLIP_SHARE
    assert diff.max().item() <= chip_smoke.matmul_cap(torch, args, kw, want)


def _kernel_vs_plain(device, case, G, S, D, dtype, seed, variant="auto",
                     took=None):
    cases, _ = chip_smoke.matmul_cases(torch, fq_attn, G, S, D, seed, device,
                                       dtype)
    fn, plain, args, kw = cases[case]
    before, by_variant = fn.launches, dict(fn.variant_launches)
    got = fn(*args, variant=variant, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    if took is not None:
        by_variant[took] += 1
        assert fn.variant_launches == by_variant
    want = plain(*args, **kw)
    assert tuple(got.shape) == (G, S, args[1].shape[2])
    _held(got, want, args, kw)
    return got


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
        kw = dict(kw, a_bits=bits, b_bits=bits)
        _held(fn(*args, **kw), plain(*args, **kw), args, kw)


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
    _held(k2, k1, args, kw)


@pytest.mark.cuda
def test_kernel_refuses_oversized_shapes(cuda_device):
    """B of one slice at K=S=577, C=128 does not fit one block's shared
    memory in fp32, as variant "fma" stages it (in bf16, as "mma" does, it
    fits); at K=S=1200 it fits neither: the wrapper raises before
    launching."""
    prm = torch.tensor([[29.0, 0.0]], device=cuda_device)
    before = fq_attn.fq_attn_matmul.launches
    for S, variant in ((577, "fma"), (1200, "auto"), (1200, "mma")):
        A = torch.rand(1, S, S, device=cuda_device)
        B = torch.rand(1, S, 128, device=cuda_device)
        with pytest.raises(ValueError):
            fq_attn.fq_attn_matmul(A, B, prm, prm, a_kind="adalog", a_bits=4,
                                   b_bits=4, variant=variant)
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


# ---------------------------------------------------------------------------
# The two variants
# ---------------------------------------------------------------------------

# (G, S, D): deit_small, a Swin window, a 12x12 window, the largest "mma"
# takes in every mode (K = 256 columns of logits, C = 128), ragged ones
VARIANT_SHAPES = [(12, 197, 64), (24, 49, 32), (3, 144, 32), (2, 256, 128),
                  (5, 100, 40), (4, 33, 16), (6, 16, 8), (3, 1, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("G,S,D", VARIANT_SHAPES)
def test_both_variants_match_plain(cuda_device, case, G, S, D, dtype):
    """"mma" as routed (asserted) and "fma" forced, each against the plain
    version, and against one another."""
    mma = _kernel_vs_plain(cuda_device, case, G, S, D, dtype, 6, "auto",
                           "mma")
    fma = _kernel_vs_plain(cuda_device, case, G, S, D, dtype, 6, "fma", "fma")
    forced = _kernel_vs_plain(cuda_device, case, G, S, D, dtype, 6, "mma",
                              "mma")
    assert torch.equal(mma, forced)
    cases, _ = chip_smoke.matmul_cases(torch, fq_attn, G, S, D, 6,
                                       cuda_device, dtype)
    _, _, args, kw = cases[case]
    _held(mma, fma, args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [3, 4, 6, 8])
def test_variants_bits(cuda_device, bits, dtype):
    """Other bit widths: "mma" wherever it applies (fp32 probabilities of 8
    bits have 510 mantissa steps, not exact in bf16: "fma" by routing, and
    "mma" forced raises), each held to the plain version."""
    q, kT, v, m1a, m1b, m2q, m2b, _ = chip_smoke.attention_inputs(
        torch, 8, 49, 32, 1, 4, cuda_device, bits)
    m2a = torch.stack([m2q, torch.zeros_like(m2q)], dim=1)
    logits = torch.matmul(q, kT) * 32 ** -0.5
    probs = torch.softmax(logits, dim=-1)
    q, kT, v, logits, probs = (t.to(dtype) for t in (q, kT, v, logits, probs))
    adalog_mma = dtype == torch.bfloat16 or bits <= 7
    for fn, plain, args, kw, mma in (
            (fq_attn.fq_attn_matmul, fq_attn.fq_attn_matmul_plain,
             (q, kT, m1a, m1b), dict(a_kind="uniform"), True),
            (fq_attn.fq_attn_matmul, fq_attn.fq_attn_matmul_plain,
             (probs, v, m2a, m2b), dict(a_kind="adalog"), adalog_mma),
            (fq_attn.fq_softmax_attn_matmul,
             fq_attn.fq_softmax_attn_matmul_plain, (logits, v, m2a, m2b), {},
             adalog_mma)):
        kw = dict(kw, a_bits=bits, b_bits=bits)
        before = dict(fn.variant_launches)
        got = fn(*args, **kw)
        before["mma" if mma else "fma"] += 1
        assert fn.variant_launches == before
        _held(got, plain(*args, **kw), args, kw)
        if not mma:
            with pytest.raises(ValueError, match="refused"):
                fn(*args, variant="mma", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mma", "fma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variants_fractional_bases(cuda_device, variant, dtype):
    """AdaLog bases that are no integers (the search's candidates are, a
    loaded state need not be): the code table and the reciprocal division
    follow the plain version."""
    G, S, D = 6, 49, 32
    cases, _ = chip_smoke.matmul_cases(torch, fq_attn, G, S, D, 8,
                                       cuda_device, dtype)
    base = torch.tensor([23.5, 29.25, 36.75, 41.125, 50.5, 37.0],
                        device=cuda_device)
    for case in CASES[1:]:
        fn, plain, (A, B, ap, bp), kw = cases[case]
        ap = torch.stack([base, torch.zeros_like(base)], dim=1)
        got = fn(A, B, ap, bp, variant=variant, **kw)
        _held(got, plain(A, B, ap, bp, **kw), (A, B, ap, bp), kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_inexact_integers_never_reach_mma(cuda_device, case):
    """fp32 inputs whose zero point puts |c - z| past 256 (8-bit codes, z =
    300) are not exact in bf16: routed to "fma", and "mma" forced raises;
    the same call in bf16 takes "mma"."""
    cases, _ = chip_smoke.matmul_cases(torch, fq_attn, 4, 49, 32, 9,
                                       cuda_device, torch.float32)
    fn, plain, (A, B, ap, bp), kw = cases[case]
    kw = dict(kw, b_bits=8)
    bp = bp.clone()
    bp[:, 0] /= 16
    bp[1, 1] = 300.0
    before = dict(fn.variant_launches)
    got = fn(A, B, ap, bp, **kw)
    before["fma"] += 1
    assert fn.variant_launches == before
    _held(got, plain(A, B, ap, bp, **kw), (A, B, ap, bp), kw)
    with pytest.raises(ValueError, match="zero point"):
        fn(A, B, ap, bp, variant="mma", **kw)
    with pytest.raises(ValueError, match="zero point"):
        fn(A, B, ap, bp, variant="mma", exact_ints=False, **kw)
    assert fn.variant_launches == before
    A16, B16 = A.to(torch.bfloat16), B.to(torch.bfloat16)
    got = fn(A16, B16, ap, bp, **kw)
    before["mma"] += 1
    assert fn.variant_launches == before
    _held(got, plain(A16, B16, ap, bp, **kw), (A16, B16, ap, bp), kw)


@pytest.mark.cuda
def test_long_rows_route_by_mode(cuda_device):
    """K = 300 columns: K2 holds a row of at most 256 logits in registers
    and goes to "fma"; K3 with AdaLog A streams A and stays "mma"; q @ kT at
    C = 300 stays "mma" too."""
    cases, _ = chip_smoke.matmul_cases(torch, fq_attn, 4, 300, 64, 10,
                                       cuda_device, torch.float32)
    for case, took in zip(CASES, ("mma", "mma", "fma")):
        fn, plain, args, kw = cases[case]
        before = dict(fn.variant_launches)
        got = fn(*args, **kw)
        before[took] += 1
        assert fn.variant_launches == before
        _held(got, plain(*args, **kw), args, kw)
    fn, _, args, kw = cases[CASES[2]]
    with pytest.raises(ValueError, match="refused"):
        fn(*args, variant="mma", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("G,S,D", [(12, 197, 64), (24, 49, 32)])
def test_softmax_fma_equals_flash_fma_bit_for_bit(cuda_device, G, S, D):
    """K2 "fma" on the plain matmul1's logits and K1 "fma" on the same q,
    kT, v run the same fp32 products and sums in the same order."""
    q, kT, v, m1a, m1b, m2q, m2b, _ = chip_smoke.attention_inputs(
        torch, G, S, D, 1, 5, cuda_device)
    cases, _ = chip_smoke.matmul_cases(torch, fq_attn, G, S, D, 5,
                                       cuda_device, torch.float32)
    _, _, args, kw = cases[CASES[2]]
    k2 = fq_attn.fq_softmax_attn_matmul(*args, variant="fma", **kw)
    k1 = fq_attn.fq_flash_attn(q, kT, v, m1a, m1b, m2q, m2b, m1a_bits=4,
                               m1b_bits=4, m2a_bits=4, m2b_bits=4,
                               logit_scale=D ** -0.5, variant="fma")
    assert torch.equal(k2, k1)


@pytest.mark.cuda
def test_periodic_site_params_on_device(cuda_device):
    """run / run_softmax hand a site's per-head rows over unrepeated, from
    the plan by the site's name when it holds them: the same output as the
    public wrappers on parameters repeated over the batch."""
    from adalog_tpu_torch.models.layers import MatMulSite
    from adalog_tpu_torch.quantizers.state import QuantizerState

    N, H, S, D = 3, 4, 49, 32
    g = torch.Generator().manual_seed(1)
    L = (3 * torch.randn(N, H, S, S, generator=g)).to(cuda_device)
    v = torch.randn(N, H, S, D, generator=g).to(cuda_device)
    site = MatMulSite(
        Aq=QuantizerState(scale=torch.ones(1, 1, 1, 1, device=cuda_device),
                          log_q=torch.tensor(31.0, device=cuda_device),
                          kind="adalog", bits=4),
        Bq=QuantizerState(
            scale=(0.3 + 0.05 * torch.arange(H, device=cuda_device)
                   ).reshape(1, H, 1, 1),
            zero_point=(6.0 + torch.arange(H, device=cuda_device)
                        ).reshape(1, H, 1, 1),
            kind="uniform", bits=4))
    ap, bp = fq_attn.site_params(site)
    assert tuple(ap.shape) == (1, 2) and tuple(bp.shape) == (H, 2)
    flat = dict(a_bits=4, b_bits=4)
    want = fq_attn.fq_softmax_attn_matmul(
        L.reshape(N * H, S, S), v.reshape(N * H, S, D), ap.repeat(N * H, 1),
        bp.repeat(N, 1), **flat).reshape(N, H, S, D)
    name = "blocks.0.attn.matmul2"
    for params in ({}, {name: (site, ap, bp)}):
        with routes.activate(routes.Plan(attn=True, exact_ints=True,
                                         attn_params=params)):
            assert torch.equal(fq_attn.run_softmax(site, L, v, name=name),
                               want)
            probs = torch.softmax(L, -1)
            got = fq_attn.run(site, probs, v, name=name)
        ref = fq_attn.fq_attn_matmul(
            probs.reshape(N * H, S, S), v.reshape(N * H, S, D),
            ap.repeat(N * H, 1), bp.repeat(N, 1), a_kind="adalog",
            **flat).reshape(N, H, S, D)
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phase_cycles_of_the_instrumented_build(cuda_device, dtype):
    """The second build of the kernels, which counts the cycles of variant
    "mma" by phase: each body counts the phases it has, the AdaLog
    arithmetic is not the least of its bodies', and a call "mma" does not
    take is refused."""
    modes = dict(zip(CASES, fq_attn.MATMUL_MODES))
    cases, _ = chip_smoke.matmul_cases(torch, fq_attn, 12, 197, 64, 11,
                                       cuda_device, dtype)
    for case, (fn, _, args, kw) in cases.items():
        before = fn.variant_launches["mma"]
        cycles = fq_attn.matmul_phase_cycles(
            modes[case], *args, a_bits=kw["a_bits"], b_bits=kw["b_bits"])
        assert fn.variant_launches["mma"] == before + 1
        assert tuple(cycles) == fq_attn.MATMUL_PHASES
        ran = {k for k, c in cycles.items() if c > 0}
        assert {"stage uq(B), code table", "loads of A", "products",
                "store"} <= ran
        assert ("exp, row sum" in ran) == (modes[case] == "softmax")
        if modes[case] != "uniform":
            assert cycles["AdaLog codes and values"] > cycles["store"]
    _, _, (L, B, ap, bp), kw = cases[CASES[2]]
    far = bp.clone()
    far[0, 1] = 400.0
    if dtype == torch.float32:           # never "mma" past the exact range
        with pytest.raises(ValueError):
            fq_attn.matmul_phase_cycles("softmax", L, B, ap, far, **kw)
