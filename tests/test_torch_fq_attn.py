"""The port's fused fake-quant attention (adalog_tpu_torch.ops.fq_attn, K1)
against adalog_tpu's Pallas fq_flash_attn run in interpret mode.

On the CPU the wrapper runs fq_flash_attn_plain. The same numpy inputs go
through both packages; outputs agree to ATOL/RTOL: both quantize the
operands identically and accumulate in fp32, so only the order of the fp32
sums differs. A probability within an ulp of an AdaLog code boundary could
take the neighbouring code; on these seeded inputs none does.

The CUDA kernel is held against the plain version in
test_torch_fq_attn_cuda.py, which imports no jax so that it runs on the GPU
machine. Its tensor-core variant ("mma") computes with other operands than
the plain version (a per-slice table of the AdaLog values; for fp32 inputs
integer codes with the scales applied to the sums): the second half of this
file holds that formulation, in plain PyTorch, to the plain version, and the
routing between the two variants.
"""

import functools
from fractions import Fraction

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from adalog_tpu.models.layers import MatMulSite as JMatMulSite
from adalog_tpu.ops import fq_attn as jfa
from adalog_tpu.quantizers.state import QuantizerState as JQS
from adalog_tpu_torch.models.layers import MatMulSite, qmatmul, \
    quant_attention
from adalog_tpu_torch.ops import fq_attn, routes
from adalog_tpu_torch.quantizers.state import QuantizerState

torch.set_num_threads(1)

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _inputs(seed, G, S, D, P, bits=4):
    """chip_smoke's seeded attention inputs as numpy: (7 arrays, bias or
    None)."""
    *arrays, bias = (t.numpy() for t in chip_smoke.attention_inputs(
        torch, G, S, D, P, seed, "cpu", bits))
    return arrays, (bias if P else None)


def _jax(arrays, bias, dtype, **kw):
    j = [jnp.asarray(a) for a in arrays]
    j[:3] = [a.astype(dtype) for a in j[:3]]
    return np.asarray(jfa.fq_flash_attn(
        *j, None if bias is None else jnp.asarray(bias), **kw))


def _torch(arrays, bias, dtype, **kw):
    t = [torch.from_numpy(a) for a in arrays]
    t[:3] = [a.to(dtype) for a in t[:3]]
    b = None if bias is None else torch.from_numpy(bias)
    return fq_attn.fq_flash_attn(*t, b, **kw).numpy()


def _kw(bits, logit_scale):
    return dict(m1a_bits=bits, m1b_bits=bits, m2a_bits=bits, m2b_bits=bits,
                logit_scale=logit_scale)


@pytest.mark.parametrize("G,S,D,P,bits", [
    (6, 16, 8, 0, 4),
    (6, 16, 8, 3, 4),           # bias with period P=3 < G
    (6, 16, 8, 0, 6),
    (6, 197, 64, 0, 4),         # deit_small: S=197, D=64, G = 6 heads
    (6, 197, 64, 6, 4),
])
def test_plain_matches_jax_flash_fp32(G, S, D, P, bits):
    arrays, bias = _inputs(G * S + P + bits, G, S, D, P, bits)
    kw = _kw(bits, 1.0 if P else D ** -0.5)
    want = _jax(arrays, bias, jnp.float32, **kw)
    got = _torch(arrays, bias, torch.float32, **kw)
    assert got.dtype == np.float32 and got.shape == (G, S, D)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("P", [0, 3])
def test_plain_matches_jax_flash_bf16(P):
    """bf16 inputs: quantized operands rounded to bf16 before each product,
    fp32 accumulation, in both packages."""
    G, S, D = 6, 16, 8
    arrays, bias = _inputs(7 + P, G, S, D, P)
    kw = _kw(4, D ** -0.5)
    want = _jax(arrays, bias, jnp.bfloat16, **kw)
    got = _torch(arrays, bias, torch.bfloat16, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _sites(rng, H, q_log):
    def uq_np():
        return dict(scale=(0.1 + 0.05 * rng.random((1, H, 1, 1))
                           ).astype(np.float32),
                    zero_point=rng.integers(6, 10, (1, H, 1, 1)
                                            ).astype(np.float32))

    m1 = (uq_np(), uq_np())
    m2b = uq_np()

    def jq(d):
        return JQS(**{k: jnp.asarray(v) for k, v in d.items()},
                   kind="uniform", bits=4)

    def tq(d):
        return QuantizerState(**{k: torch.from_numpy(v) for k, v in d.items()},
                              kind="uniform", bits=4)

    ja = JQS(scale=jnp.ones((1, 1, 1, 1)), log_q=jnp.asarray(q_log),
             kind="adalog", bits=4)
    ta = QuantizerState(scale=torch.ones((1, 1, 1, 1)),
                        log_q=torch.tensor(q_log), kind="adalog", bits=4)
    return ((JMatMulSite(Aq=jq(m1[0]), Bq=jq(m1[1])),
             JMatMulSite(Aq=ja, Bq=jq(m2b))),
            (MatMulSite(Aq=tq(m1[0]), Bq=tq(m1[1])),
             MatMulSite(Aq=ta, Bq=tq(m2b))))


def test_run_flash_matches_jax():
    """4D dispatch with per-head site state, as the ViT forward calls it."""
    rng = np.random.default_rng(3)
    N, H, S, D = 2, 3, 16, 8
    q, v = (rng.standard_normal((2, N, H, S, D)) * 2).astype(np.float32)
    kT = (rng.standard_normal((N, H, D, S)) * 2).astype(np.float32)
    (jm1, jm2), (tm1, tm2) = _sites(rng, H, 29.0)
    want = np.asarray(jfa.run_flash(jm1, jm2, jnp.asarray(q), jnp.asarray(kT),
                                    jnp.asarray(v), logit_scale=D ** -0.5))
    got = fq_attn.run_flash(tm1, tm2, torch.from_numpy(q),
                            torch.from_numpy(kT), torch.from_numpy(v),
                            logit_scale=D ** -0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_flash_matches_unfused_port_path():
    """The fused path equals the port's own unfused chain: quantized
    matmul1 -> scale -> softmax -> quantized matmul2."""
    rng = np.random.default_rng(4)
    N, H, S, D = 2, 4, 16, 8
    q, v = (torch.from_numpy((rng.standard_normal((N, H, S, D)) * 2
                              ).astype(np.float32)) for _ in range(2))
    kT = torch.from_numpy((rng.standard_normal((N, H, D, S)) * 2
                           ).astype(np.float32))
    _, (m1, m2) = _sites(rng, H, 43.0)
    attn = torch.softmax(qmatmul(m1, q, kT, mode="quant") * D ** -0.5, -1)
    want = qmatmul(m2, attn, v, mode="quant")
    got = fq_attn.run_flash(m1, m2, q, kT, v, logit_scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_flash_gate():
    """supports_flash needs both-uniform matmul1 and AdaLog matmul2, both
    sites in quant mode; ``quant_attention`` takes K1 only where the plan
    switches the kernels on, and never in training."""
    rng = np.random.default_rng(0)
    _, (m1, m2) = _sites(rng, 2, 29.0)
    call = dict(shape=(197, 64), dtype=F32)
    assert fq_attn.supports_flash(m1, m2, "quant", "quant", **call)
    assert not fq_attn.supports_flash(m1, m2, "quant", "raw", **call)
    assert not fq_attn.supports_flash(None, m2, "quant", "quant", **call)
    assert not fq_attn.supports_flash(m2, m2, "quant", "quant", **call)
    assert not fq_attn.supports_flash(m1, m1, "quant", "quant", **call)
    q = torch.zeros(1, 2, 16, 8)
    flashed = []

    def run_flash(*a, **k):
        flashed.append(k["names"])
        return fq_attn.run_flash(*a, **k)

    for plan, training, want in ((None, False, 0),
                                 (routes.Plan(attn=False), False, 0),
                                 (routes.Plan(attn=True), True, 0),
                                 (routes.Plan(attn=True), False, 1)):
        flashed.clear()
        with routes.activate(plan):
            quant_attention(q, q.transpose(-2, -1), q, m1, m2, "quant",
                            "quant", None, ("m1", "m2"), training=training,
                            logit_scale=1.0, run_flash=run_flash)
        assert flashed == [("m1", "m2")] * want


def test_wrapper_cpu_runs_plain_and_counts_nothing():
    arrays, bias = _inputs(11, 6, 16, 8, 3)
    t = [torch.from_numpy(a) for a in arrays]
    kw = _kw(4, 0.5)
    before = fq_attn.fq_flash_attn.launches
    got = fq_attn.fq_flash_attn(*t, torch.from_numpy(bias), **kw)
    want = fq_attn.fq_flash_attn_plain(*t, torch.from_numpy(bias), **kw)
    assert torch.equal(got, want)
    assert fq_attn.fq_flash_attn.launches == before


def test_wrapper_rejects_bad_inputs():
    arrays, _ = _inputs(12, 6, 16, 8, 0)
    t = [torch.from_numpy(a) for a in arrays]
    kw = _kw(4, 0.5)
    with pytest.raises(ValueError):          # kT given as (G, S, D)
        fq_attn.fq_flash_attn(t[0], t[0], *t[2:], **kw)
    with pytest.raises(TypeError):           # mixed dtypes
        fq_attn.fq_flash_attn(t[0].to(torch.bfloat16), *t[1:], **kw)
    with pytest.raises(ValueError):          # P must divide G
        fq_attn.fq_flash_attn(*t, torch.zeros(4, 16, 16), **kw)
    with pytest.raises(ValueError):
        fq_attn.fq_flash_attn(*t, **{**kw, "m2a_bits": 32})


def test_kernel_shape_limits():
    """The kernel stages uq(kT) and uq(v) of a slice in shared memory:
    deit_small fits; S=577 at D=64 (a 384-px ViT, which the zoo does not
    have) does not."""
    fq_attn.check_kernel_shape(197, 64)
    fq_attn.check_kernel_shape(144, 32)
    with pytest.raises(ValueError):
        fq_attn.check_kernel_shape(577, 64)
    with pytest.raises(ValueError):
        fq_attn.check_kernel_shape(64, 256)


# ---------------------------------------------------------------------------
# The formulation of the kernel's tensor-core variant ("mma")
# ---------------------------------------------------------------------------

# the integer-operand product against the plain version: exact integer sums
# against rounded fp32 products, so a probability at a code boundary may
# take the neighbouring code; at most FLIP_SHARE of the outputs may leave
# ATOL + RTOL*|ref| (on these seeded inputs none does: the largest |diff|
# is 3.6e-6)
FLIP_SHARE = 1e-3
BASES = [float(b) for b in range(23, 52)] + [29.5, 40.25]


def _reachable(q, n_codes):
    """(G, 2N) mask of the codes a probability can take: x is clamped at
    1e-15, so codes past round(-log2(1e-15) * 37 / q) never occur and their
    table entries are never read."""
    last = torch.round(-torch.log2(torch.tensor(1e-15)) * 37.0 / q)
    return torch.arange(n_codes).reshape(1, -1) <= last.reshape(-1, 1)


@pytest.mark.parametrize("bits", range(2, 9))
def test_code_table_value_mode_matches_adalog_unit(bits):
    """The table's entry equals _adalog_unit bit for bit: for a probability
    at the centre of every reachable code 0..2N-1, for probabilities whose
    codes lie past 2N (value 0), and for a dense random sample, at integer
    bases 23..51 and two non-integer ones."""
    q = torch.tensor(BASES)
    n_codes = 2 ** bits
    table = fq_attn._adalog_table(q, bits, steps_only=False)
    assert table.shape == (len(BASES), n_codes) and table.dtype == torch.float32
    code = torch.arange(n_codes + 40, dtype=torch.float32).reshape(1, 1, -1)
    qg = q.reshape(-1, 1, 1)
    rng = np.random.default_rng(bits)
    for x in (torch.exp2(-code * qg / 37.0),
              torch.from_numpy(rng.random((len(BASES), 64, 257)
                                          ).astype(np.float32)),
              torch.from_numpy(np.exp(-20 * rng.random((len(BASES), 64, 257))
                                      ).astype(np.float32))):
        want = fq_attn._adalog_unit(x, qg, bits)
        got = fq_attn._adalog_lookup(x, table, qg)
        assert torch.equal(got, want)
    # the first sample did visit every reachable code and codes past 2N
    x = torch.exp2(-code * qg / 37.0)
    seen = torch.round(-torch.log2(torch.clamp(x, min=1e-15)) * 37.0 / qg)
    for g in range(len(BASES)):
        reach = _reachable(q[g:g + 1], n_codes)[0]
        assert set(range(n_codes)) & set(seen[g, 0].int().tolist()) \
            >= set(torch.nonzero(reach).flatten().tolist())
    if bits <= 5:
        assert (seen >= n_codes).any()
        assert (fq_attn._adalog_lookup(x, table, qg)[seen >= n_codes] == 0).all()


@pytest.mark.parametrize("bits", range(2, 9))
def test_code_table_steps_mode(bits):
    """fp32 inputs: the table holds steps * 2^-shift. Times ts it is the
    value bit for bit, and up to 7 bits (4N - 2 <= 254 steps) every entry is
    exact in bf16, for every reachable code."""
    q = torch.tensor(BASES)
    values = fq_attn._adalog_table(q, bits, steps_only=False)
    steps = fq_attn._adalog_table(q, bits, steps_only=True)
    reach = _reachable(q, 2 ** bits)
    ts = torch.tensor(1.0 / (2 ** (bits + 1) - 2), dtype=torch.float32)
    assert torch.equal((steps * ts)[reach], values[reach])
    assert (steps[reach] > 0).all() and torch.isfinite(steps[reach]).all()
    if bits <= 7:
        assert torch.equal(steps.to(torch.bfloat16).float()[reach],
                           steps[reach])


def _mma_case(G, S, D, P, bits, dtype, seed):
    arrays, bias = _inputs(seed, G, S, D, P, bits)
    t = [torch.from_numpy(a) for a in arrays]
    t[:3] = [a.to(dtype) for a in t[:3]]
    t[5] = t[5] + torch.tensor([0.0, 0.5, 0.25])[torch.arange(G) % 3]
    b = None if bias is None else torch.from_numpy(bias)
    # the probabilities' codes are exact in bf16 up to 7 bits only
    kw = dict(_kw(bits, D ** -0.5), m2a_bits=min(bits, 7))
    return t, b, kw


@pytest.mark.parametrize("bits", [3, 4, 6, 8])
@pytest.mark.parametrize("P", [0, 3])
@pytest.mark.parametrize("G,S,D", [(6, 197, 64), (9, 49, 32), (3, 50, 24)])
def test_integer_operand_product_matches_plain_fp32(G, S, D, P, bits):
    """fp32: integer operands c - z in bf16, exact integer sums, the scales
    sq*sk and ts*sv on the sums, AdaLog values from the table (some bases
    not integers) equal the plain version's rounded fp32 products to
    ATOL/RTOL, up to a bounded share of flipped codes."""
    t, b, kw = _mma_case(G, S, D, P, bits, torch.float32, S + D + P + bits)
    want = fq_attn.fq_flash_attn_plain(*t, b, **kw)
    got = fq_attn._flash_mma_plain(*t, b, **kw)
    assert got.dtype == torch.float32 and got.shape == (G, S, D)
    diff = (got - want).abs()
    share = (diff > ATOL + RTOL * want.abs()).float().mean().item()
    assert share <= FLIP_SHARE, share
    # one flipped code moves an output by less than one probability times
    # the largest |uq(v)|
    ops = fq_attn._mma_operands(*t, **{k: v for k, v in kw.items()
                                       if k != "logit_scale"})
    cap = (ops["v"].float().abs().amax()
           * t[6][:, 0].abs().amax()).item()
    assert diff.max().item() <= cap
    for k in ("q", "kT", "v"):       # integers, exact in bf16
        o = ops[k].float()
        assert torch.equal(o, torch.round(o)) and o.abs().max() <= 256


@pytest.mark.parametrize("P", [0, 3])
@pytest.mark.parametrize("G,S,D", [(6, 197, 64), (9, 49, 32), (3, 50, 24)])
def test_bf16_operands_are_the_plain_versions(G, S, D, P):
    """bf16: the staged operands are the plain version's rounded operands
    bit for bit, the table's probabilities round to the plain version's,
    and so the whole product equals the plain version."""
    t, b, kw = _mma_case(G, S, D, P, 4, torch.bfloat16, S + D + P)
    ops = fq_attn._mma_operands(*t, **{k: v for k, v in kw.items()
                                       if k != "logit_scale"})

    def per_g(a):
        return a.reshape(-1, 1, 1)

    for k, x, prm in (("q", t[0], t[3]), ("kT", t[1], t[4]), ("v", t[2], t[6])):
        want = fq_attn._uq(x.float(), per_g(prm[:, 0]), per_g(prm[:, 1]), 4)
        assert ops[k].dtype == torch.bfloat16
        assert torch.equal(ops[k], want.to(torch.bfloat16))
    assert torch.equal(ops["logit_scale"], torch.ones(G, 1, 1))
    assert torch.equal(ops["out_scale"], torch.ones(G, 1, 1))
    sm = torch.softmax(torch.from_numpy(
        np.random.default_rng(S).standard_normal((G, S, S)).astype(np.float32)
        * 3), -1)
    assert torch.equal(
        fq_attn._adalog_lookup(sm, ops["table"], per_g(t[5])).to(torch.bfloat16),
        fq_attn._adalog_unit(sm, per_g(t[5]), kw["m2a_bits"]).to(torch.bfloat16))
    want = fq_attn.fq_flash_attn_plain(*t, b, **kw)
    got = fq_attn._flash_mma_plain(*t, b, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("S,D,dtype,bits,exact,want", [
    (197, 64, F32, (4, 4, 4, 4), True, "mma"),       # deit_small
    (197, 64, BF16, (4, 4, 4, 4), True, "mma"),
    (49, 32, F32, (4, 4, 4, 4), True, "mma"),        # swin_tiny
    (49, 32, BF16, (4, 4, 4, 4), False, "mma"),      # bf16 needs no integers
    (256, 128, F32, (8, 8, 7, 8), True, "mma"),      # the widest it takes
    (300, 64, F32, (4, 4, 4, 4), True, "mma"),       # the long row
    (257, 64, BF16, (4, 4, 4, 4), True, "mma"),
    (300, 32, F32, (9, 4, 4, 4), True, "fma"),       # long, 9-bit operands
    (197, 64, F32, (9, 4, 4, 4), True, "fma"),       # 9-bit fp32 operands
    (197, 64, F32, (4, 4, 4, 9), True, "fma"),
    (197, 64, F32, (4, 4, 8, 4), True, "fma"),       # 510 mantissa steps
    (197, 64, BF16, (9, 9, 8, 9), True, "mma"),      # values, not integers
    (197, 64, BF16, (4, 4, 9, 4), True, "fma"),      # 512 codes: no table
    (197, 64, F32, (4, 4, 4, 4), False, "fma"),      # a zero point of 400
])
def test_flash_variant_routing(S, D, dtype, bits, exact, want):
    assert fq_attn.flash_variant(S, D, dtype, bits, exact) == want
    if (S, D) == (256, 128):         # bf16 staging fits a block, fp32 does not
        with pytest.raises(ValueError):
            fq_attn.flash_variant(S, D, dtype, bits, exact, "fma")
    else:
        assert fq_attn.flash_variant(S, D, dtype, bits, exact, "fma") == "fma"
    if want == "mma":
        assert fq_attn.flash_variant(S, D, dtype, bits, exact, "mma") == "mma"
    else:
        with pytest.raises(ValueError):
            fq_attn.flash_variant(S, D, dtype, bits, exact, "mma")
    with pytest.raises(ValueError):
        fq_attn.flash_variant(S, D, dtype, bits, exact, "wgmma")


def test_flash_variant_raises_where_neither_takes_the_call():
    with pytest.raises(ValueError):
        fq_attn.flash_variant(577, 128, F32, (4, 4, 4, 4), True)
    with pytest.raises(ValueError):
        fq_attn.flash_variant(64, 256, BF16, (4, 4, 4, 4), True, "fma")


@pytest.mark.parametrize("S,long", [
    (49, False), (197, False), (256, False),      # a row in registers
    (257, True), (577, True), (1025, True),       # two passes over key tiles
])
def test_long_row_choice(S, long):
    """Variant "mma" holds a row of up to 256 logits in registers and takes
    longer rows in two passes (the long row), at a head dim of at most 64;
    past 256 at D=128 neither variant takes a call ("fma" stages the slice
    in one block's shared memory)."""
    bits = (4, 4, 4, 4)
    assert fq_attn.long_row(S) is long
    for dtype in (F32, BF16):
        for D in (32, 64):
            assert fq_attn.flash_variant(S, D, dtype, bits, True) == "mma"
            assert fq_attn.flash_takes(S, D, dtype, bits, True)
        assert fq_attn.flash_takes(S, 128, dtype, bits, True) is not long
        if long:
            with pytest.raises(ValueError, match="long row"):
                fq_attn.flash_variant(S, 128, dtype, bits, True, "mma")


def test_flash_gate_declines_shapes_neither_variant_takes():
    """With the call's shape, supports_flash also asks whether a variant of
    K1 takes it: D=256 (past both) and D=128 past 256 tokens are declined,
    so a forward takes the unfused path instead of raising inside K1; the
    zero points' verdict is the plan's, or read from the sites."""
    rng = np.random.default_rng(0)
    _, (m1, m2) = _sites(rng, 2, 29.0)
    for exact in (True, None):
        gate = functools.partial(fq_attn.supports_flash, m1, m2, "quant",
                                 "quant", dtype=F32, exact_ints=exact)
        assert gate(shape=(197, 64)) and gate(shape=(1025, 64))
        assert gate(shape=(49, 32)) and gate(shape=(256, 128))
        assert not gate(shape=(64, 256))
        assert not gate(shape=(1025, 128))
    gate = functools.partial(fq_attn.supports_flash, m1, m2, "quant",
                             "quant", dtype=F32, exact_ints=False)
    assert gate(shape=(197, 64)) and not gate(shape=(1025, 64))  # "fma"


def test_forward_past_both_variants_takes_the_unfused_path():
    """A ViT of head dim 256 served with the attention kernels on: no K1
    call (neither variant takes it), the unfused path's answer instead."""
    from adalog_tpu_torch.calib.init_state import init_qstate
    from adalog_tpu_torch.models.vit import ViTConfig, vit_forward, vit_init
    from adalog_tpu_torch.models.zoo import ModelSpec
    from adalog_tpu_torch.utils.config import Config

    spec = ModelSpec(name="wide_heads", family="vit", timm_id="wide_heads",
                     cfg=ViTConfig(img_size=16, patch_size=8, dim=512,
                                   depth=1, heads=2, num_classes=4))
    model = vit_init(spec.cfg, torch.Generator().manual_seed(0))
    qs = init_qstate(spec, Config(), model)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, 16, 3)).astype(np.float32))
    calls = fq_attn.fq_flash_attn.calls
    plan = routes.build(spec, model, qs)
    assert plan.attn and plan.exact_ints
    with torch.no_grad(), routes.activate(plan):
        got = vit_forward(spec.cfg, model, x, qs, {"*": "quant"})
    assert fq_attn.fq_flash_attn.calls == calls
    with torch.no_grad():
        want = vit_forward(spec.cfg, model, x, qs, {"*": "quant"})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_zero_point_range():
    """|c - round(z)| <= 256 for every code c: at 4 bits z in -241..256, at
    8 bits z in -1..256."""
    def prm(z):
        return torch.tensor([[0.1, z]])

    for bits, ok, bad in ((4, (-241.0, 0.0, 7.4, 256.0), (-242.0, 257.0, 400.0)),
                          (8, (-1.0, 128.0, 256.4), (-2.0, 256.6, 400.0))):
        for z in ok:
            assert fq_attn.zero_points_exact(prm(z), bits), (bits, z)
        for z in bad + (float("nan"),):
            assert not fq_attn.zero_points_exact(prm(z), bits), (bits, z)


def test_forced_mma_refuses_inexact_inputs():
    """A zero point of 400: "auto" would take "fma"; a forced "mma" raises,
    on the CPU too, whether the wrapper reads the zero points itself or the
    caller hands the verdict in."""
    arrays, _ = _inputs(21, 6, 16, 8, 0)
    t = [torch.from_numpy(a) for a in arrays]
    kw = _kw(4, 0.5)
    fq_attn.fq_flash_attn(*t, variant="mma", **kw)
    fq_attn.fq_flash_attn(*t, variant="mma", exact_ints=True, **kw)
    with pytest.raises(ValueError):
        fq_attn.fq_flash_attn(*t, variant="mma", exact_ints=False, **kw)
    t[4] = t[4].clone()
    t[4][2, 1] = 400.0
    with pytest.raises(ValueError):
        fq_attn.fq_flash_attn(*t, variant="mma", **kw)
    want = fq_attn.fq_flash_attn_plain(*t, **kw)
    assert torch.equal(fq_attn.fq_flash_attn(*t, **kw), want)
    assert torch.equal(fq_attn.fq_flash_attn(*t, variant="fma", **kw), want)
    bf = [a.to(torch.bfloat16) for a in t[:3]] + t[3:]
    fq_attn.fq_flash_attn(*bf, variant="mma", **kw)      # values, not integers
    with pytest.raises(ValueError):
        fq_attn.fq_flash_attn(*t, variant="tensor", **kw)


def test_integers_exact_reads_every_matmul_site():
    """The predictor's one verdict: every uniform quantizer of every matmul
    site; run_flash hands the plan's to the wrapper."""
    rng = np.random.default_rng(5)
    _, (m1, m2) = _sites(rng, 2, 29.0)
    state = {"blocks.0.attn.matmul1": m1, "blocks.0.attn.matmul2": m2}
    assert fq_attn.integers_exact(state)
    m2.Bq.zero_point = m2.Bq.zero_point.clone()
    m2.Bq.zero_point[0, 1] = -300.0
    assert not fq_attn.integers_exact(state)
    seen = []
    real = fq_attn.fq_flash_attn

    @functools.wraps(real)          # the counters live on the wrapper
    def spy(*a, exact_ints=None, **kw):
        seen.append(exact_ints)
        return real(*a, exact_ints=exact_ints, **kw)

    q = torch.zeros(1, 2, 16, 8)
    fq_attn.fq_flash_attn = spy
    try:
        for verdict in (None, True, False):
            with routes.activate(routes.Plan(attn=True, exact_ints=verdict)):
                fq_attn.run_flash(m1, m2, q, q.transpose(-2, -1), q,
                                  logit_scale=1.0)
        fq_attn.run_flash(m1, m2, q, q.transpose(-2, -1), q, logit_scale=1.0)
    finally:
        fq_attn.fq_flash_attn = real
    assert seen == [None, True, False, None]


def _rn32(x: Fraction) -> np.float32:
    """A rational rounded to the nearest float32, ties to even (normal
    range)."""
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1, -x) if x < 0 else (1, x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    ulp = Fraction(2) ** (e - 23)
    m, rem = divmod(x, ulp)
    if rem > ulp / 2 or (rem == ulp / 2 and m % 2):
        m += 1
    return np.float32(sign * float(m * ulp))


@pytest.mark.parametrize("family", ["e / sum", "-log2(p) * 37 / q", "x / s",
                                    "divisors of many ones"])
def test_reciprocal_division_is_the_ieee_quotient(family):
    """The kernel divides by a row's sum, a slice's base and a quantizer's
    scale through the divisor's rounded reciprocal y = RN(1 / b):
    q = RN(a * y), r = fma(-q, b, a), RN(q + r * y) (csrc/fq_quant.cuh,
    div_rn_by). By exact rational arithmetic that is RN(a / b), the IEEE
    quotient, on the operands the kernel meets."""
    rng = np.random.default_rng(len(family))
    n = 2500
    if family == "e / sum":
        a, b = np.exp(-30 * rng.random(n)), 1 + 200 * rng.random(n) ** 2
    elif family == "x / s":
        a, b = 4 * rng.standard_normal(n), 0.01 + rng.random(n)
    elif family == "divisors of many ones":
        a = 100 * rng.random(n)
        b = 2.0 - 2.0 ** -rng.integers(10, 24, n) * rng.integers(1, 8, n)
    else:
        a = 37 * 50 * rng.random(n)
        b = np.where(rng.random(n) < 0.5, rng.integers(23, 52, n),
                     23 + 28 * rng.random(n))
    for a32, b32 in zip(a.astype(np.float32), b.astype(np.float32)):
        fa, fb = Fraction(float(a32)), Fraction(float(b32))
        y = Fraction(float(_rn32(1 / fb)))
        q = Fraction(float(_rn32(fa * y)))
        r = Fraction(float(_rn32(fa - q * fb)))
        assert _rn32(q + r * y) == _rn32(fa / fb), (a32, b32)
