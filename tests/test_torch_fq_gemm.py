"""The port's fused activation-quant GEMM (adalog_tpu_torch.ops.fq_gemm, K4)
and its reparam transforms (adalog_tpu_torch.calib.reparam) against
adalog_tpu's, on the CPU.

On the CPU the wrapper runs fq_gemm_plain; JAX's Pallas fq_gemm runs in
interpret mode. The same numpy inputs go through both packages.

Tolerances. fp32: RTOL/ATOL, the JAX kernel test's own: both quantize
identically and accumulate in fp32, only the order of the sums differs, and
XLA's CPU exp2 is inexact at negative integers (exp2(-13) is
1.22070254e-04, up to 4e-6 relative), where the port assembles 2^-k from
exponent bits. bf16: both round the fp32 sum to bf16, and two fp32 sums in
different orders may round to neighbouring bf16 values, one bf16 ulp apart:
BF16_RTOL = 2**-7 (one ulp relative to the value), with the fp32 ATOL.

The kernel's tensor-core variant ("mma") is a second formulation of the same
function (integer operands for fp32 inputs, a value table for AdaLog); its
plain-PyTorch form, the weight codes it needs and the routing between the
variants are held here too. The CUDA kernels are held against the plain
version in test_torch_fq_gemm_cuda.py, which imports no jax.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adalog_tpu.calib import reparam as jreparam
from adalog_tpu.calib.init_state import init_qstate as j_init_qstate
from adalog_tpu.models.layers import LayerNormP, LinearP
from adalog_tpu.models.vit import vit_init as j_vit_init
from adalog_tpu.ops import fq_gemm as jfg
from adalog_tpu.quantizers.state import GELU_MIN
from adalog_tpu.quantizers.uniform import uniform_quant
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu_torch.calib import reparam
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.models.layers import LinearSite, quant_linear_weight
from adalog_tpu_torch.ops import fq_gemm, routes, weight_prep
from adalog_tpu_torch.quantizers.state import (QuantizerState,
                                               WeightQuantizerState)
from adalog_tpu_torch.utils.interop import from_jax, qstate_from_tree

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
BF16_RTOL = 2.0 ** -7
# largest share of AdaLog codes allowed to take the neighbouring code
# (log2 of XLA and of torch may differ by an ulp at a .5 boundary;
# test_torch_quantizers.py measured at most 1 code in 2**20)
FLIP_BOUND = 1e-3
# dequantized values of agreeing codes: XLA's exp2 error (see above)
DEQUANT_RTOL = 5e-6
SPEC = zoo.model_spec("test_tiny")
W4A4 = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)


@pytest.fixture(autouse=True)
def interpret_mode():
    jfg.INTERPRET = True
    yield
    jfg.INTERPRET = False


def _case(seed, kind, bits, T, K, O):
    """(x, w (O, K), params) as float32 numpy arrays: normal activations
    for uniform, post-GeLU-like ones for adalog_shift."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        x = rng.standard_normal((T, K))
        levels = 2 ** bits - 1
        params = [6.0 / levels * rng.uniform(0.8, 1.2), levels // 2, 0.0, 0.0]
    else:
        x = np.abs(rng.standard_normal((T, K))) - GELU_MIN
        params = [float(np.max(x + GELU_MIN)) * rng.uniform(0.9, 1.1), 0.0,
                  GELU_MIN, float(rng.choice([23, 29, 41, 47]))]
    w = rng.standard_normal((O, K))
    return (x.astype(np.float32), w.astype(np.float32),
            np.asarray(params, np.float32))


def _jax(x, w, params, dtype, kind, bits):
    out = jfg.fq_gemm(jnp.asarray(x).astype(dtype),
                      jnp.asarray(w).astype(dtype).T, jnp.asarray(params),
                      kind=kind, bits=bits)
    return np.asarray(out.astype(jnp.float32))


def _torch(x, w, params, dtype, kind, bits, bias=None):
    out = fq_gemm.fq_gemm(torch.from_numpy(x).to(dtype),
                          torch.from_numpy(w).to(dtype),
                          torch.from_numpy(params), bias, kind=kind, bits=bits)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("T,K,O", [(48, 32, 40), (10, 8, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [3, 4, 6])
@pytest.mark.parametrize("kind", ["uniform", "adalog_shift"])
def test_plain_matches_jax_fq_gemm(kind, bits, dtype, T, K, O):
    x, w, params = _case(T * K + bits, kind, bits, T, K, O)
    want = _jax(x, w, params, getattr(jnp, dtype), kind, bits)
    got = _torch(x, w, params, getattr(torch, dtype), kind, bits)
    assert got.shape == (T, O)
    rtol = RTOL if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL)


def _quantize_both(x, params, kind, bits):
    want = np.asarray(jfg._quantize_tile(
        jnp.asarray(x), *map(jnp.float32, params), kind, bits))
    got = fq_gemm.quantize_plain(torch.from_numpy(x), torch.from_numpy(params),
                                 kind=kind, bits=bits).numpy()
    return got, want


@pytest.mark.parametrize("bits", [3, 4, 6, 8])
def test_uniform_quantized_bitwise(bits):
    """fq_a(x) of the uniform kind equals JAX's kernel quantizer and its
    uniform_quant bit for bit (bf16 inputs are quantized from their fp32
    value in both)."""
    x, _, params = _case(bits, "uniform", bits, 64, 96, 1)
    got, want = _quantize_both(x, params, "uniform", bits)
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(uniform_quant(jnp.asarray(x), params[0], params[1],
                                   bits=bits, symmetric=False))
    np.testing.assert_array_equal(got, ref)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got16 = fq_gemm.quantize_plain(xb, torch.from_numpy(params),
                                   kind="uniform", bits=bits).numpy()
    want16, _ = _quantize_both(xb.float().numpy(), params, "uniform", bits)
    np.testing.assert_array_equal(got16, want16)


@pytest.mark.parametrize("bits", [3, 4, 6])
def test_adalog_shift_code_flips_bounded(bits):
    """fq_a(x) of the adalog_shift kind against JAX's kernel quantizer over
    2**16 post-GeLU-like inputs: values agree to DEQUANT_RTOL wherever the
    codes agree; the share of flipped codes stays under FLIP_BOUND."""
    x, _, params = _case(100 + bits, "adalog_shift", bits, 64, 1024, 1)
    got, want = _quantize_both(x, params, "adalog_shift", bits)
    differ = ~np.isclose(got, want, rtol=DEQUANT_RTOL, atol=0.0)
    share = differ.mean()
    assert share <= FLIP_BOUND, share
    assert np.all(got >= 0) and np.all(got <= params[0])


def _w4a4_qstates():
    """JAX init_qstates of test_tiny: W4A4 (uniform sites and an unfolded
    shifted-AdaLog fc2), the same with the fold flag set, and ptq4vit (twin
    fc2), with numpy leaves."""
    params = jax.jit(j_vit_init, static_argnums=0)(SPEC.cfg,
                                                   jax.random.PRNGKey(0))
    out = []
    for cfg in (JConfig(**W4A4), JConfig(**W4A4, post_gelu_quantizer="ptq4vit")):
        out.append(j_init_qstate(SPEC, cfg, params))
    folded = dict(out[0])
    for name, site in folded.items():
        if name.endswith("fc2"):
            folded[name] = site.replace(aq=site.aq.replace(
                bias_reparamed=jnp.ones((), jnp.bool_)))
    return params, [out[0], folded, out[1]]


def test_site_logic_matches_jax(monkeypatch):
    """supports / kernel_kind / site_params give JAX's answers on every site
    (JAX's enabled() needs a TPU backend, so it is patched on here), and
    the plan with the GEMM switch on routes exactly those sites to K4."""
    monkeypatch.setattr(jfg, "enabled", lambda: True)
    params, qstates = _w4a4_qstates()
    taken = []
    for jq in qstates:
        model, tq = from_jax(SPEC.cfg,
                             jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, jq))
        n = 0
        for name, jsite in jq.items():
            if not hasattr(jsite, "aq") or not hasattr(jsite, "n_V"):
                continue
            tsite = tq[name]
            for mode in ("quant", "a_only", "w_only", "raw"):
                assert fq_gemm.supports(tsite, mode) == \
                    jfg.supports(jsite, mode), (name, mode)
            if jfg.supports(jsite, "quant"):
                n += 1
                assert fq_gemm.kernel_kind(tsite) == jfg.kernel_kind(jsite)
                np.testing.assert_array_equal(
                    fq_gemm.site_params(tsite.aq).numpy(),
                    np.asarray(jfg.site_params(jsite.aq)))
        taken.append(n)
        plan = routes.build(SPEC, model, tq, use_gemm_kernels=True)
        assert plan.count("fq_gemm") == n
    depth = SPEC.cfg.depth
    # unfolded: fc2 stays plain; folded: every Linear; twin fc2: plain
    assert taken == [3 * depth + 1, 4 * depth + 1, 3 * depth + 1]


def test_fold_gelu_shift_matches_jax():
    """The post-GeLU bias fold of the port equals JAX's on the same fc2
    weights and weight quantizer; the caller's module is left as it was."""
    params, (jq, _, _) = _w4a4_qstates()
    params = jax.tree_util.tree_map(np.asarray, params)
    model, tq = from_jax(SPEC.cfg, params, jax.tree_util.tree_map(np.asarray,
                                                                  jq))
    for i in range(SPEC.cfg.depth):
        name = f"blocks.{i}.mlp.fc2"
        jp = params.blocks[i].mlp.fc2
        jp = jp.replace(b=np.random.default_rng(i).standard_normal(
            jp.b.shape).astype(np.float32))
        want = jreparam.fold_gelu_shift_into_bias(
            jax.tree_util.tree_map(jnp.asarray, jp), jq[name],
            shift=GELU_MIN)
        lin = model.blocks[i].mlp.fc2
        with torch.no_grad():
            lin.bias.copy_(torch.from_numpy(jp.b))
        before = lin.bias.clone()
        got = reparam.fold_gelu_shift_into_bias(lin, tq[name],
                                                shift=GELU_MIN)
        assert got is not lin and torch.equal(lin.bias, before)
        assert torch.equal(got.weight, lin.weight)
        np.testing.assert_allclose(got.bias.detach().numpy(), np.asarray(want.b),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_bias", [True, False])
def test_layernorm_reparam_matches_jax(with_bias):
    """LayerNorm channel reparam and the cached-input rewrite, the port
    against JAX on the same numpy params (a Linear without bias gets one)."""
    rng = np.random.default_rng(7 + with_bias)
    I, O = 24, 40
    g = (1 + 0.1 * rng.standard_normal(I)).astype(np.float32)
    b = (0.1 * rng.standard_normal(I)).astype(np.float32)
    w = (0.2 * rng.standard_normal((O, I))).astype(np.float32)
    lb = (0.1 * rng.standard_normal(O)).astype(np.float32) if with_bias \
        else None
    a_scale = rng.uniform(0.02, 0.3, I).astype(np.float32)
    a_zp = rng.integers(3, 12, I).astype(np.float32)
    x = rng.standard_normal((6, I)).astype(np.float32)

    jn, jl, jr, jb, jts, jtz = jreparam.layernorm_channel_reparam(
        LayerNormP(g=jnp.asarray(g), b=jnp.asarray(b), eps=1e-6),
        LinearP(w=jnp.asarray(w), b=None if lb is None else jnp.asarray(lb)),
        jnp.asarray(a_scale), jnp.asarray(a_zp))

    norm = torch.nn.LayerNorm(I, eps=1e-6)
    lin = torch.nn.Linear(I, O, bias=with_bias)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(g))
        norm.bias.copy_(torch.from_numpy(b))
        lin.weight.copy_(torch.from_numpy(w))
        if with_bias:
            lin.bias.copy_(torch.from_numpy(lb))
    tn, tl, tr, tb, tts, ttz = reparam.layernorm_channel_reparam(
        norm, lin, torch.from_numpy(a_scale), torch.from_numpy(a_zp))

    for got, want in ((tn.weight, jn.g), (tn.bias, jn.b), (tl.weight, jl.w),
                      (tr, jr), (tb, jb), (tts, jts), (ttz, jtz)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tl.bias.detach().numpy(), np.asarray(jl.b),
                               rtol=1e-6, atol=1e-6)
    assert (lin.bias is None) == (not with_bias)
    assert torch.equal(norm.weight, torch.from_numpy(g))
    np.testing.assert_allclose(
        reparam.rewrite_cached_input(torch.from_numpy(x), tr, tb).numpy(),
        np.asarray(jreparam.rewrite_cached_input(jnp.asarray(x), jr, jb)),
        rtol=1e-6, atol=1e-6)


def test_wrapper_cpu_runs_plain_and_counts_calls():
    x, w, params = _case(3, "uniform", 4, 10, 8, 7)
    t = [torch.from_numpy(a) for a in (x, w, params)]
    bias = torch.linspace(-1, 1, 7)
    launches, calls = fq_gemm.fq_gemm.launches, fq_gemm.fq_gemm.calls
    got = fq_gemm.fq_gemm(*t, bias, kind="uniform", bits=4)
    want = fq_gemm.fq_gemm_plain(*t, bias, kind="uniform", bits=4)
    assert torch.equal(got, want)
    assert torch.equal(got, fq_gemm.fq_gemm(*t, kind="uniform", bits=4) + bias)
    assert fq_gemm.fq_gemm.launches == launches
    assert fq_gemm.fq_gemm.calls == calls + 2
    # strided rows (the head's pooled token) give the same result
    xs = torch.cat([t[0], t[0]], dim=1)[:, :8]
    assert torch.equal(fq_gemm.fq_gemm(xs, *t[1:], kind="uniform", bits=4),
                       fq_gemm.fq_gemm(*t, kind="uniform", bits=4))


def test_wrapper_rejects_bad_inputs():
    x, w, params = (torch.from_numpy(a)
                    for a in _case(4, "uniform", 4, 10, 8, 7))
    kw = dict(kind="uniform", bits=4)
    with pytest.raises(ValueError):               # w given as (K, O)
        fq_gemm.fq_gemm(x, w.t(), params, **kw)
    with pytest.raises(TypeError):                # mixed dtypes
        fq_gemm.fq_gemm(x.to(torch.bfloat16), w, params, **kw)
    with pytest.raises(ValueError):               # bias of the wrong width
        fq_gemm.fq_gemm(x, w, params, torch.zeros(8), **kw)
    with pytest.raises(ValueError):
        fq_gemm.fq_gemm(x, w, params[:3], **kw)
    with pytest.raises(ValueError):
        fq_gemm.fq_gemm(x, w, params, kind="log2", bits=4)
    with pytest.raises(ValueError):
        fq_gemm.fq_gemm(x, w, params, kind="uniform", bits=32)
    with pytest.raises(RuntimeError):             # no path for this device
        fq_gemm.fq_gemm(x.to("meta"), w.to("meta"), params.to("meta"), **kw)


def test_gemm_switch_turns_attention_kernel_on():
    """As in JAX, the GEMM switch turns the attention kernel on: a plan
    built with it alone has the attention kernels on, one built with
    neither has them off; no plan is active outside ``activate``."""
    from adalog_tpu_torch.calib.init_state import init_qstate
    from adalog_tpu_torch.utils.config import Config

    spec, model = zoo.build_model("test_tiny", seed=0)
    cfg = Config(**W4A4)
    tq = init_qstate(spec, cfg, model)
    gemm = routes.build(spec, model, tq, cfg, use_kernels=False,
                        use_gemm_kernels=True)
    off = routes.build(spec, model, tq, cfg, use_kernels=False)
    assert gemm.attn and gemm.exact_ints is not None and gemm.attn_params
    assert not off.attn and off.exact_ints is None and not off.attn_params
    assert gemm.linear["head"].kind == "fq_gemm"
    assert off.linear["head"].kind == "fq_act"
    assert routes.current() is None
    with routes.activate(gemm):
        assert routes.current() is gemm
        with routes.activate(None):
            assert routes.current() is None
        assert routes.current() is gemm
    assert routes.current() is None


# ---------------------------------------------------------------------------
# Variant "mma" of the kernel: its formulation in plain PyTorch, and routing
# ---------------------------------------------------------------------------

def _weight_site(seed, O, K, bits, n_V=1, symmetric=False, adaround=False,
                 zp_frac=0.0):
    """(nn.Linear, LinearSite) with a per-row min/max weight quantizer from
    a numpy seed; ``adaround`` adds a rounding logit, ``zp_frac`` moves the
    zero points off the integers."""
    rng = np.random.default_rng(seed)
    lin = torch.nn.Linear(K, O)
    w = (0.05 * rng.standard_normal((O, K))).astype(np.float32)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    wv = w.reshape(n_V, O // n_V, K)
    levels = 2 ** bits - 1
    if symmetric:
        scale = np.abs(wv).max(-1, keepdims=True) / (2 ** (bits - 1) - 1)
        zp = None
    else:
        lo, hi = wv.min(-1, keepdims=True), wv.max(-1, keepdims=True)
        scale = (hi - lo) / levels
        zp = torch.from_numpy((np.round(-lo / scale) + zp_frac)
                              .astype(np.float32))
    alpha = torch.from_numpy(rng.standard_normal(wv.shape).astype(np.float32)) \
        if adaround else None
    wq = WeightQuantizerState(scale=torch.from_numpy(scale.astype(np.float32)),
                              zero_point=zp, alpha=alpha, bits=bits,
                              symmetric=symmetric)
    aq = QuantizerState(scale=torch.ones(1), zero_point=torch.zeros(1),
                        bits=bits)
    return lin, LinearSite(wq=wq, aq=aq, n_V=n_V)


@pytest.mark.parametrize("bits", [3, 4, 6, 8])
@pytest.mark.parametrize("n_V", [1, 3])
@pytest.mark.parametrize("form", ["asymmetric", "symmetric", "adaround",
                                  "adaround symmetric"])
def test_weight_codes_times_scale_is_the_quantized_weight(form, n_V, bits):
    """codes * s_w[row] equals quant_linear_weight bit for bit, and the
    codes are whole numbers of magnitude at most 2^bits - 1."""
    lin, site = _weight_site(bits + 10 * n_V, 24, 16, bits, n_V,
                             symmetric="symmetric" in form,
                             adaround="adaround" in form)
    codes, scale = weight_prep.site_weight_codes(lin.weight, site)
    assert codes.shape == (24, 16) and scale.shape == (24,)
    assert torch.equal(codes * scale[:, None], quant_linear_weight(lin, site))
    assert torch.equal(codes, torch.round(codes))
    assert codes.abs().max() <= 2 ** bits - 1
    assert torch.equal(codes.to(torch.bfloat16).float(), codes)


def _adalog_params(bits, log_q, scale=3.0):
    return torch.tensor([scale, 0.0, GELU_MIN, log_q], dtype=torch.float32)


def _every_code(params, bits):
    """Inputs that land on every adalog_shift code 0..2N+3, on both sides of
    it, and a spread of ordinary ones."""
    s, _, shift, q = params.double().tolist()
    c = np.arange(0, 2 ** bits + 4, dtype=np.float64)
    hits = [s * 2.0 ** (-(c + d) * q / 37.0) - shift for d in (-0.3, 0, 0.3)]
    rnd = np.abs(np.random.default_rng(bits).standard_normal(4096)) - shift
    return torch.from_numpy(np.concatenate(hits + [rnd]).astype(np.float32))


@pytest.mark.parametrize("log_q", [1.0, 23.0, 29.0, 37.0, 74.0])
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_adalog_value_table_is_quantize_plain(bits, log_q):
    """The 2N-entry value table plus the code arithmetic equals
    quantize_plain bit for bit on inputs that hit every code and the codes
    past 2N; its steps-only form is whole numbers times a power of two,
    exact in bf16 up to 7 bits (in the normal range), and gives the same values within 2 ulp once
    scaled by ts * s."""
    params = _adalog_params(bits, log_q)
    x = _every_code(params, bits)
    want = fq_gemm.quantize_plain(x, params, kind="adalog_shift", bits=bits)
    table = fq_gemm._adalog_value_table(params, bits, False)
    assert table.shape == (2 ** bits,)
    got = fq_gemm._adalog_lookup(x, params, table)
    assert torch.equal(got, want)
    # every code whose input survives fp32's x + shift is hit, and codes
    # past 2N where they can be reached
    scaled = torch.clamp((x + params[2]) / params[0], 1e-15, 1.0)
    hit = set(torch.round(-torch.log2(scaled) * 37.0 / log_q).int().tolist())
    reach = [c for c in range(2 ** bits + 4) if 2.0 ** (-c * log_q / 37) > 1e-4]
    assert set(reach) <= hit and (max(reach) < 2 ** bits or (want == 0).any())
    steps = fq_gemm._adalog_value_table(params, bits, True)
    if bits <= 7:       # subnormal entries (below 2^-126) are as good as 0
        normal = steps >= 2.0 ** -126
        assert torch.equal(steps.to(torch.bfloat16).float()[normal],
                           steps[normal])
    ts_s = torch.tensor(1.0 / (2 ** (bits + 1) - 2)) * params[0]
    np.testing.assert_allclose(
        (fq_gemm._adalog_lookup(x, params, steps) * ts_s).numpy(),
        want.numpy(), rtol=2.5e-7, atol=0.0)


def _mma_case(seed, kind, T, K, O, bits=4, w_bits=4):
    """(x, w_q, params, bias, codes): activations as _case's, a weight
    fake-quantized per row at ``w_bits`` with its codes."""
    x, _, params = _case(seed, kind, bits, T, K, O)
    lin, site = _weight_site(seed + 1, O, K, w_bits)
    codes, scale = weight_prep.site_weight_codes(lin.weight, site)
    w_q = quant_linear_weight(lin, site).detach()
    bias = torch.from_numpy(np.random.default_rng(seed + 2).standard_normal(O)
                            .astype(np.float32))
    return (torch.from_numpy(x), w_q, torch.from_numpy(params), bias,
            fq_gemm.WeightCodes(codes.to(torch.bfloat16), scale))


# share of outputs the integer-operand product may leave ATOL + 1e-5 |ref|
# of the plain version by: both are fp32 roundings of the same exact sum
# (measured 0 at these shapes)
MMA_SHARE = 1e-4


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("kind", ["uniform", "adalog_shift"])
@pytest.mark.parametrize("T,K,O", [(197, 384, 1152), (64, 1536, 384),
                                   (50, 100, 72)])
def test_integer_operand_product_matches_plain(T, K, O, kind, with_bias):
    """fp32 inputs through variant "mma"'s formulation (integers c - z or
    steps * 2^-shift times c_w - z_w, the sum scaled by s * s_w) against
    fq_gemm_plain, and both against the float64 product of the plain
    version's operands: the integer form is no farther from it."""
    x, w, params, bias, codes = _mma_case(T + K, kind, T, K, O)
    b = bias if with_bias else None
    kw = dict(kind=kind, bits=4)
    a, bop, scale = fq_gemm._mma_operands(x, w, params, codes=codes, **kw)
    assert a.dtype == bop.dtype == torch.bfloat16 and scale.shape == (O,)
    got = fq_gemm._gemm_mma_plain(x, w, params, b, codes=codes, **kw)
    want = fq_gemm.fq_gemm_plain(x, w, params, b, **kw)
    past = ((got - want).abs() > 1e-5 + 1e-5 * want.abs()).float().mean()
    assert past.item() <= MMA_SHARE, past
    ref = fq_gemm.quantize_plain(x, params, **kw).double() @ w.double().t()
    if with_bias:
        ref = ref + bias.double()
    err_mma = (got.double() - ref).abs().max().item()
    err_plain = (want.double() - ref).abs().max().item()
    assert err_mma <= max(err_plain, 1e-6 * ref.abs().max().item()), \
        (err_mma, err_plain)


@pytest.mark.parametrize("bits", [3, 4, 6, 8])
@pytest.mark.parametrize("kind", ["uniform", "adalog_shift"])
def test_bf16_operands_are_the_plain_versions(kind, bits):
    """bf16 inputs: variant "mma" multiplies the plain version's own
    operands, bit for bit, and has no scale."""
    x, w, params = _case(bits, kind, bits, 64, 96, 8)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    p = torch.from_numpy(params)
    a, b, scale = fq_gemm._mma_operands(xb, wb, p, kind=kind, bits=bits)
    want = fq_gemm.quantize_plain(xb, p, kind=kind, bits=bits)
    assert torch.equal(a, want.to(torch.bfloat16))
    assert b is wb and scale is None
    assert torch.equal(
        fq_gemm._gemm_mma_plain(xb, wb, p, kind=kind, bits=bits),
        fq_gemm.fq_gemm_plain(xb, wb, p, kind=kind, bits=bits))


@pytest.mark.parametrize("dtype,kind,bits,zp,with_codes,want", [
    ("bfloat16", "uniform", 4, 7.0, False, "mma"),
    ("bfloat16", "adalog_shift", 8, 0.0, False, "mma"),
    ("bfloat16", "uniform", 9, 400.0, False, "mma"),
    ("float32", "uniform", 4, 7.0, True, "mma"),
    ("float32", "uniform", 8, 255.0, True, "mma"),
    ("float32", "adalog_shift", 7, 0.0, True, "mma"),
    ("float32", "uniform", 4, 7.0, False, "fma"),       # no weight codes
    ("float32", "uniform", 9, 7.0, True, "fma"),        # 9-bit activations
    ("float32", "adalog_shift", 8, 0.0, True, "fma"),   # 8-bit AdaLog
    ("float32", "uniform", 4, 400.0, True, "fma"),      # |c - z| > 256
    ("float32", "uniform", 4, -300.0, True, "fma"),
])
def test_variant_routing(dtype, kind, bits, zp, with_codes, want):
    """gemm_variant routes from dtype, bits, the codes and the zero point;
    a forced "mma" on a call it cannot take raises (on the CPU too), a
    forced "fma" always goes."""
    dt = getattr(torch, dtype)
    x, w, params, _, codes = _mma_case(5, kind, 6, 16, 8, bits=min(bits, 8))
    params[1] = zp
    codes = codes if with_codes else None
    exact = fq_gemm.activation_ints_exact(params, kind, bits)
    assert fq_gemm.gemm_variant(dt, kind, bits, codes, exact) == want
    assert fq_gemm.gemm_variant(dt, kind, bits, codes, exact, "fma") == "fma"
    kw = dict(kind=kind, bits=bits, codes=codes)
    args = (x.to(dt), w.to(dt), params)
    plain = fq_gemm.fq_gemm_plain(*args, kind=kind, bits=bits)
    assert torch.equal(fq_gemm.fq_gemm(*args, variant="fma", **kw), plain)
    if want == "mma":
        assert torch.equal(fq_gemm.fq_gemm(*args, variant="mma", **kw), plain)
    else:
        with pytest.raises(ValueError, match="refused"):
            fq_gemm.fq_gemm(*args, variant="mma", **kw)
    with pytest.raises(ValueError):
        fq_gemm.fq_gemm(*args, variant="wgmma", **kw)


def test_wrapper_rejects_bad_codes():
    x, w, params, _, codes = _mma_case(6, "uniform", 6, 16, 8)
    kw = dict(kind="uniform", bits=4)
    with pytest.raises(ValueError, match="codes"):
        fq_gemm.fq_gemm(x, w, params, codes=fq_gemm.WeightCodes(
            codes.codes.float(), codes.scale), **kw)
    with pytest.raises(ValueError, match="codes"):
        fq_gemm.fq_gemm(x, w, params, codes=fq_gemm.WeightCodes(
            codes.codes[:4], codes.scale), **kw)
