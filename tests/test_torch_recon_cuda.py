"""The port's block reconstruction on an NVIDIA GPU against the same code on
the CPU. Skipped without a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_recon_cuda.py

  - a test_tiny reconstruction on the card against one on the CPU, on
    chip_smoke.py's terms (compare_recons: flipped hard decisions,
    activation scales, recs);
  - a whole reconstruction inside every kernel context a predictor enters
    (weight prep, the GEMM table, the attention kernels) launches no
    kernel, while the eval forward in the same contexts does;
  - the gradient of the patch embedding's AdaRound alphas on the card,
    with TF32 allowed for the process beforehand, against a float64
    convolution on the CPU: the reconstruction pins cuDNN to exact fp32
    for the backward pass too (TF32 would be off by about 1e-3), and
    restores the process's setting afterwards.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from adalog_tpu_torch.calib.calibrator import QuantCalibrator
from adalog_tpu_torch.calib.init_state import init_qstate
from adalog_tpu_torch.calib.layout import quant_layout
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.ops import fq_attn, fq_gemm, weight_prep
from adalog_tpu_torch.quantizers.state import map_tensors
from adalog_tpu_torch.recon import brecq as T
from adalog_tpu_torch.recon.blocks import block_units
from adalog_tpu_torch.utils.config import Config

# the patch embedding's alpha gradient against float64, relative to its
# largest element
ALPHA_GRAD_RTOL = 1e-4
SMALL = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4, eq_n=32, steps=2,
             search_round=1, fpcs=True, recon_iters=20, optim_batch_size=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: reconstruction runs there by "
                    "default")
    return torch.device("cuda")


def _tiny_state(name="test_tiny", seed=3):
    spec, model = zoo.build_model(name, seed=0)
    x = np.random.default_rng(seed).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    cfg = Config(**SMALL)
    p, q = QuantCalibrator(spec, model, cfg, device="cpu").calibrate([x])
    return spec, model, p, q, quant_layout(spec, cfg), cfg, x


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test_tiny", "test_tiny_swin"])
def test_reconstruction_card_equals_cpu(cuda_device, name):
    spec, model, p, q, layout, cfg, x = _tiny_state(name)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        r = T.BlockReconstructor(spec, p, model, q, layout, cfg, device=dev)
        pp, qq = r.reconstruct([x])
        runs.append((pp, qq, r))
    flips, total, move, rec_rel, kl = chip_smoke.compare_recons(
        torch, runs[0], runs[1], layout)
    assert flips <= chip_smoke.RECON_FLIP_SHARE * total, (flips, total)
    assert move <= chip_smoke.RECON_SCALE_SHARE, move
    assert rec_rel <= chip_smoke.RECON_REC_RTOL, rec_rel
    assert kl <= chip_smoke.RECON_KL_ATOL, kl
    assert not chip_smoke.frozen_off_grid(torch, runs[0][0], runs[0][1],
                                          layout)
    assert all(bool((s == 1.0).all()) for s in
               chip_smoke.probability_scales(runs[0][1]).values())


@pytest.mark.cuda
def test_reconstruction_launches_no_kernel(cuda_device):
    spec, model, p, q, layout, cfg, x = _tiny_state()
    r = T.BlockReconstructor(spec, p, model, q, layout, cfg,
                             device=cuda_device)
    qs = r.qstate
    chip_smoke.zero_launches(fq_attn, fq_gemm)
    wprep = weight_prep.prepare(spec, r.params, qs, cfg)
    codes = weight_prep.weight_codes(spec, r.params, qs, cfg)
    xt = torch.from_numpy(x).to(cuda_device)
    with torch.no_grad(), weight_prep.activate(wprep), \
            fq_attn.activate(True, fq_attn.integers_exact(qs),
                             fq_attn.prepare(qs)), \
            fq_gemm.activate(fq_gemm.prepare(qs, codes)):
        zoo.model_forward_fn(spec)(spec.cfg, r.params, xt, qs,
                                   {"*": "quant"})
        served = chip_smoke.read_launches(fq_attn, fq_gemm)
        chip_smoke.zero_launches(fq_attn, fq_gemm)
        with torch.enable_grad():
            r.reconstruct([x])
        got = chip_smoke.read_launches(fq_attn, fq_gemm)
    # the unfolded fc2 sites stay plain, the rest reach the kernels
    assert served["K1"] == 2 and served["K4"] > 0, served
    assert not any(got.values()), got


@pytest.mark.cuda
def test_patch_embed_alpha_gradient_exact_fp32(cuda_device):
    spec = zoo.model_spec("deit_small")
    _, model = zoo.build_model("deit_small", seed=0)
    cfg = Config(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)
    qstate = init_qstate(spec, cfg, model)
    layout = quant_layout(spec, cfg, reparam=False)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 224, 224, 3)).astype(np.float32)
    y = rng.standard_normal((8, 196, 384)).astype(np.float32) * 0.05
    unit = block_units(spec)[0]
    assert unit.name == "patch_embed"

    def grad(device, dtype):
        r = T.BlockReconstructor(spec, model, model, qstate, layout, cfg,
                                 device=device)
        params = r.params.to(dtype)
        qs = {cn: map_tensors(lambda t: t.to(device), r.qstate[nm])
              for nm, cn in unit.canon.items()}
        tr = r._init_trainables(unit, True)
        xb = torch.from_numpy(x).to(device, dtype)
        yb = torch.from_numpy(y).to(device, dtype)
        with T._exact_fp32(r.device):
            loss, _ = T._block_loss(unit.forward, unit.extract(params), qs,
                                    tr, xb, yb, r._site_modes(unit, True),
                                    1, 20, True, "mse")
            (g,) = torch.autograd.grad(loss, tr["w"]["patch_embed.proj"])
        return g.double().cpu()

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    g_card = grad(cuda_device, torch.float32)
    assert torch.backends.cudnn.allow_tf32          # restored after
    g_ref = grad(torch.device("cpu"), torch.float64)
    err = (g_card - g_ref).abs().max().item()
    assert err <= ALPHA_GRAD_RTOL * g_ref.abs().max().item(), err
