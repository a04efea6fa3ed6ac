"""The CUDA kernel K5 (adalog_tpu_torch/csrc/int8_gemm.cu) against its plain
PyTorch version on an NVIDIA GPU. Skipped without a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_int8_cuda.py

The integer sum is exact in all, and all round the same fp32 epilogue
(the sum to float, times the row scale, plus the bias, one cast), so the
three variants of the kernel ("wgmma", "wgmma_codes" and "mma") equal the
plain version bit for bit, in float32 and bfloat16, at the int8 Linear
shapes of chip_smoke.py (deit_small, deit_base, vit_large and
swin_base_384 at batch 32, eva02_large_448 at batch 64) and at ragged
ones, as routed and forced; the routed variant is the one int8_variant
names. A forced variant on a call it refuses raises, as does a CUDA call
no variant takes; a capture into a CUDA graph replays to the direct call's
output; a reconstruction inside a predictor's int8 table launches no
kernel.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import INT8_SHAPES
from adalog_tpu_torch.calib.calibrator import QuantCalibrator
from adalog_tpu_torch.calib.layout import quant_layout
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.ops import fq_attn, fq_gemm, int8_linear, routes
from adalog_tpu_torch.recon import brecq
from adalog_tpu_torch.utils.config import Config


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8 GEMM kernel has no CPU "
                    "mode")
    return torch.device("cuda")


VARIANTS = ("auto", "wgmma", "wgmma_codes", "mma")


def _kernel_vs_plain(device, T, K, O, dt, seed, variant, bits=4,
                     strided=False, bias=True):
    """One call of ``variant`` against the plain version: the routed
    variant launched once (by variant_launches), 0 outputs differing."""
    dtype = getattr(torch, dt)
    x, w_int, a_params, scale_row, b = chip_smoke.int8_inputs(
        torch, T, K, O, seed, device, bits)
    x, b = x.to(dtype), b.to(dtype) if bias else None
    if strided:                      # rows of a wider tensor
        x = torch.cat([x, x], dim=1)[:, :K]
    lda = x.stride(0) if T > 1 else K
    try:
        routed = int8_linear.int8_variant(T, K, O, lda, x.data_ptr() % 16,
                                          dtype, variant)
    except ValueError as refused:
        pytest.skip(str(refused))
    before = dict(int8_linear.int8_gemm.variant_launches)
    got = int8_linear.int8_gemm(x, w_int, a_params, scale_row, b, bits=bits,
                                variant=variant)
    torch.cuda.synchronize()
    after = int8_linear.int8_gemm.variant_launches
    assert {v: after[v] - before[v] for v in after} == \
        {v: int(v == routed) for v in after}
    want = int8_linear.int8_gemm_plain(x, w_int, a_params, scale_row, b,
                                       bits=bits)
    assert got.dtype == dtype and tuple(got.shape) == (T, O)
    assert bool(torch.isfinite(got).all())
    assert int((got != want).sum()) == 0, \
        (got.float() - want.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("site,T,K,O", INT8_SHAPES)
def test_kernel_equals_plain_at_model_shapes(cuda_device, site, T, K, O, dt,
                                             variant):
    """The int8 sites of deit_small, deit_base, vit_large and swin_base_384
    at batch 32, eva02_large_448's at batch 64, and the ragged cases of
    chip_smoke.py ("wgmma" refuses those)."""
    _kernel_vs_plain(cuda_device, T, K, O, dt, 1, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,K,O,bits,strided,bias", [
    (10, 8, 7, 4, False, True),      # smaller than one tile everywhere
    (1, 24, 9, 3, False, False),     # one row, K not a multiple of 16
    (129, 100, 130, 6, False, True),  # one past a tile, K a 4th of 16
    (200, 40, 33, 7, True, True),    # strided rows, odd O, 7 bits
    (64, 1000, 5, 4, False, True),   # K past a stage many times, odd
    (1, 32, 16, 4, False, True),     # one row through "wgmma"
    (130, 96, 288, 5, True, False),  # swin_tiny's stage 0 width, strided
    (300, 1024, 4096, 4, False, True),  # more k stages than the ring
    (65, 2176, 128, 4, False, True),    # the largest resident K
    (65, 2177, 128, 4, False, True),    # one past it: "wgmma_codes"
    (129, 2730, 1024, 4, True, True),   # eva02's fc2 widths, strided rows
    (300, 4100, 256, 5, False, True),   # more k stages than its ring
    (1, 40, 16, 4, False, False),       # one row, one piece past K
])
def test_kernel_equals_plain_ragged(cuda_device, T, K, O, bits, strided,
                                    bias, dt, variant):
    _kernel_vs_plain(cuda_device, T, K, O, dt, 2, variant, bits=bits,
                     strided=strided, bias=bias)


@pytest.mark.cuda
def test_forced_wgmma_refused_raises(cuda_device):
    """A forced "wgmma" on a call it refuses raises and launches nothing;
    the same call routed takes "wgmma_codes", one launch of the wrapper; a
    forced "wgmma_codes" on output rows it refuses raises too, and the
    call routed takes "mma"."""
    x, w_int, a_params, scale_row, _ = chip_smoke.int8_inputs(
        torch, 64, 40, 32, 4, cuda_device)
    before = dict(int8_linear.int8_gemm.variant_launches)
    launches = int8_linear.int8_gemm.launches
    with pytest.raises(ValueError, match="'wgmma' refused"):
        int8_linear.int8_gemm(x, w_int, a_params, scale_row, bits=4,
                              variant="wgmma")
    assert int8_linear.int8_gemm.variant_launches == before
    int8_linear.int8_gemm(x, w_int, a_params, scale_row, bits=4)
    torch.cuda.synchronize()
    assert int8_linear.int8_gemm.variant_launches["wgmma_codes"] == \
        before["wgmma_codes"] + 1
    assert int8_linear.int8_gemm.launches == launches + 1
    x, w_int, a_params, scale_row, _ = chip_smoke.int8_inputs(
        torch, 64, 40, 130, 4, cuda_device)
    before = dict(int8_linear.int8_gemm.variant_launches)
    with pytest.raises(ValueError, match="'wgmma_codes' refused"):
        int8_linear.int8_gemm(x, w_int, a_params, scale_row, bits=4,
                              variant="wgmma_codes")
    assert int8_linear.int8_gemm.variant_launches == before
    int8_linear.int8_gemm(x, w_int, a_params, scale_row, bits=4)
    torch.cuda.synchronize()
    assert int8_linear.int8_gemm.variant_launches["mma"] == before["mma"] + 1
    x, w_int, a_params, scale_row, _ = chip_smoke.int8_inputs(
        torch, 64, 48, 32, 4, cuda_device)
    wide = torch.cat([x, x[:, :1]], dim=1)[:, :48]    # row stride 49
    with pytest.raises(ValueError, match="16-byte aligned"):
        int8_linear.int8_gemm(wide, w_int, a_params, scale_row, bits=4,
                              variant="wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["wgmma", "wgmma_codes", "mma"])
def test_cuda_graph_replay_equals_direct_call(cuda_device, variant, dt):
    """Each variant captured into a CUDA graph (the table's tensor map
    passed by value; "wgmma_codes"' codes buffer and its tensor map from
    the graph's own pool) replays to the direct call's output, on new
    inputs copied into the captured ones too."""
    dtype = getattr(torch, dt)
    x, w_int, a_params, scale_row, b = chip_smoke.int8_inputs(
        torch, 6304, 384, 1152, 5, cuda_device)
    x, b = x.to(dtype), b.to(dtype)
    w_map = int8_linear.weight_map(w_int)

    def call():
        return int8_linear.int8_gemm(x, w_int, a_params, scale_row, b,
                                     bits=4, variant=variant, w_map=w_map)

    direct = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, direct)
    x.copy_(torch.flip(x, dims=[0]))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, call())


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
    """A whole reconstruction inside a predictor's plan with every switch
    on, int8 included, launches no kernel; the eval forward under the same
    plan launches K5 at every int8 site."""
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
    plan = routes.build(spec, r.params, qs, cfg, use_int8=True,
                        use_gemm_kernels=True)
    chip_smoke.zero_launches(fq_attn, fq_gemm)
    xt = torch.from_numpy(x).to(cuda_device)
    with torch.no_grad(), routes.activate(plan):
        zoo.model_forward_fn(spec)(spec.cfg, r.params, xt, qs,
                                   {"*": "quant"})
        served = chip_smoke.read_launches(fq_attn, fq_gemm)
        chip_smoke.zero_launches(fq_attn, fq_gemm)
        with torch.enable_grad():
            r.reconstruct([x])
        got = chip_smoke.read_launches(fq_attn, fq_gemm)
    assert served["K5"] == plan.count("int8") > 0 and served["K1"] == 2, \
        served
    assert not any(got.values()), got
