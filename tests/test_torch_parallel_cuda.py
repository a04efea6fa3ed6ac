"""Tensor-parallel serving on an NVIDIA GPU: two gloo ranks on cuda:0 (NCCL
refuses two ranks on one card), each serving at tp=2 through
load_quantized with the attention and GEMM kernels, test_tiny and then
deit_small at full width. Skipped without a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_parallel_cuda.py

The phase is chip_smoke.py's mesh phase on these two cases: per rank the
launches a batch are asserted (K1 once a block on the local heads, K4 at
the column-parallel and replicated sites only), every launch is variant
"mma", and each rank's K1 and K4 are held to their plain versions on its
own slices (block checks, chip_smoke.py's tolerances).
"""

import pytest
import torch

import chip_smoke
from adalog_tpu_torch.ops import cuda_build, fq_attn, fq_gemm

CASES = (("test_tiny", 1, 2, "float32", False),
         ("deit_small", 1, 2, "float32", False))


@pytest.mark.cuda
def test_tp_ranks_hold_their_kernels_to_plain(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for name in ("fq_flash_attn", "fq_gemm"):   # once, before the ranks
        cuda_build.build(name)
    launches, worst = chip_smoke.mesh_phase(
        torch, fq_attn, fq_gemm, torch.device("cuda", 0), str(tmp_path),
        runs=((2, CASES),))
    per_batch = [chip_smoke.MESH_LAUNCHES[m, dp, tp, i]
                 for m, dp, tp, _, i in CASES]
    for k in ("K1", "K4"):
        assert launches[k] == 2 * chip_smoke.N_BATCHES * sum(
            n[k] for n in per_batch)
    assert launches["K2"] == launches["K3"] == launches["K5"] == 0
    assert worst["K4"] <= chip_smoke.FLIP_MAX
