"""The yardstick's arithmetic against numbers worked by hand for
deit_small, and the corrected kernel classifier."""

import json
import os

import pytest

from conftest import ROOT
from portbench import counts, trace

DEIT = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                   "deit_small_w4a4.json")))
SWIN = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                   "swin_base_w4a4.json")))


def test_deit_small_flops():
    # patch 2*196*768*384; a block: qkv 2*197*384*1152, proj
    # 2*197*384*384, fc1 and fc2 2*197*384*1536 each, attention
    # 4*197*197*64 a head times 6; the head 2*384*1000
    block = (174_292_992 + 58_097_664 + 2 * 232_390_656 + 59_610_624)
    assert counts.forward_flops(DEIT) == 115_605_504 + 12 * block + 768_000
    assert counts.forward_flops(DEIT) == 9_197_764_608


def test_swin_base_flops():
    # about 15.4 GMAC an image (timm), within a percent
    assert counts.forward_flops(SWIN) == pytest.approx(30.8e9, rel=0.01)


def test_deit_small_attention_calls():
    calls = counts.attention_calls(DEIT, 200)
    assert calls == [(1200, 197, 64, 0)] * 12


def test_swin_base_attention_calls():
    calls = counts.attention_calls(SWIN, 2)
    # stage 0: 64 windows of 49 tokens, 4 heads of 32; the second block
    # shifted, its bias one row a window and head
    assert calls[0] == (2 * 64 * 4, 49, 32, 4)
    assert calls[1] == (2 * 64 * 4, 49, 32, 64 * 4)
    # the last stage: one window, never shifted
    assert calls[-1] == (2 * 1 * 32, 49, 32, 32)
    assert len(calls) == 24


def test_flash_bound_by_hand():
    # q, kT, v, out: 1200*197*64 floats of 4 bytes each (16 bytes an
    # element), 7 parameters a slice: 242,107,200 bytes at 3.35 TB/s
    ms, what = counts.flash_bound_ms(1200, 197, 64, 0, "float32")
    assert what == "bytes"
    assert ms == pytest.approx(242_107_200 / 3.35e12 * 1e3, rel=1e-12)


def test_int8_bound_by_hand():
    # deit_small's qkv at batch 200: x 39400*384 floats, codes 1152*384,
    # row scales and bias 1152 each, 8 bytes of parameters, 39400*1152
    # floats out
    ms, what = counts.int8_bound_ms(39400, 384, 1152, "float32")
    assert what == "bytes"
    assert ms == pytest.approx(242_525_192 / 3.35e12 * 1e3, rel=1e-12)


def test_linear_shapes():
    shapes = counts.linear_shapes(DEIT, 200)
    assert len(shapes) == 49
    assert sum(1 for s in shapes if s[0] != "fc2") == 37   # K5's sites
    assert shapes[-1] == ("head", 200, 384, 1000)


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::fq_flash_attn_mma_kernel<float, 25, 4>",
     "K1"),
    ("void (anonymous namespace)::fq_softmax_matmul_mma_kernel<float>", "K2"),
    ("void (anonymous namespace)::fq_adalog_matmul_mma_kernel<float>", "K3"),
    ("void (anonymous namespace)::fq_uniform_matmul_mma_kernel<float>", "K3"),
    ("fq_gemm_mma_res", "K4"),
    ("void (anonymous namespace)::int8_gemm_wgmma_kernel<float>", "K5"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8", "GEMM"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel", "GEMM"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, round>", "other"),
])
def test_kernel_class(name, cls):
    assert trace.kernel_class(name) == cls


def test_busy_and_gaps():
    dev = [("a", 0.0, 10.0), ("b", 5.0, 20.0), ("c", 30.0, 40.0)]
    host = [("outer", 0.0, 50.0), ("aten::copy_", 21.0, 29.0)]
    s = trace.summarize(dev, host, 50e-6, 1)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["idle_gaps"] == [["aten::copy_", pytest.approx(10e-6)]]
    assert s["device_ops"][0][0] == "b"
