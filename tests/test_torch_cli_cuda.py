"""The port's CLI and serving entry points on an NVIDIA GPU. Skipped without
a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cli_cuda.py

  - the test_tiny CLI with its default device (the card): calibrate, then
    load the checkpoint and optimize, each run validating through the
    attention kernel (K1 launched twice a batch);
  - make_predictor with no device serves on the card;
  - load_quantized of a reference-format .pth on the card gives the logits
    of the same state loaded from a v2 .ckpt.
"""

import argparse
import glob
import os

import numpy as np
import pytest
import torch

import adalog_tpu_torch.data.imagenet as p_data
from adalog_tpu_torch import cli
from adalog_tpu_torch.calib.calibrator import QuantCalibrator
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.ops import fq_attn
from adalog_tpu_torch.serve import load_quantized, make_predictor
from adalog_tpu_torch.utils.checkpoint import save_checkpoint
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.ref_checkpoint import export_reference_state_dict

SMALL = dict(w_bit=6, a_bit=6, s_bit=6, qhead_a_bit=6, eq_n=32, steps=2,
             search_round=1, calib_size=8, calib_batch_size=8, optim_size=8,
             optim_batch_size=4, recon_iters=10)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CLI runs there by default")
    return torch.device("cuda")


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    def init(self, spec, *args, **kwargs):
        self.spec, self.val_batch_size = spec, 8
        self.n_val, self.num_classes, self.seed = 16, 10, 0

    monkeypatch.setattr(p_data.SyntheticLoader, "__init__", init)
    config = str(tmp_path / "tiny_cfg.py")
    with open(config, "w") as f:
        f.write("class Config:\n    def __init__(self):\n" + "".join(
            f"        self.{k} = {v!r}\n" for k, v in SMALL.items()))
    return str(tmp_path), config


def _args(tmp_path, config, out, *flags):
    return argparse.ArgumentParser(parents=[cli.get_args_parser()]).parse_args(
        ["--model", "test_tiny", "--config", config, "--synthetic-data",
         "--val-batch-size", "8", "--output-dir",
         os.path.join(tmp_path, out), *flags])


@pytest.mark.cuda
def test_cli_calibrate_optimize_validate_on_card(cuda_device, tiny):
    tmp_path, config = tiny
    fq_attn.fq_flash_attn.launches = 0
    params, qstate = cli.main(_args(tmp_path, config, "cal", "--calibrate"))
    assert next(params.parameters()).device.type == "cuda"
    assert fq_attn.fq_flash_attn.launches == 2 * 2     # 2 blocks, 2 batches
    ckpt, = glob.glob(os.path.join(tmp_path, "cal", "*", "*.ckpt"))
    fq_attn.fq_flash_attn.launches = 0
    params2, qstate2 = cli.main(_args(
        tmp_path, config, "opt", "--load-calibrate-checkpoint", ckpt,
        "--optimize"))
    assert sorted(qstate2) == sorted(qstate)
    assert glob.glob(os.path.join(tmp_path, "opt", "*",
                                  "test_tiny_w6_a6_s6_optimsize_8.ckpt"))
    # calibration set (2 batches of 4) and val (2 of 8)
    assert fq_attn.fq_flash_attn.launches == 2 * 4


@pytest.mark.cuda
def test_make_predictor_defaults_to_the_card(cuda_device):
    spec, model = zoo.build_model("test_tiny", seed=0)
    x = np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    _, qstate = QuantCalibrator(spec, model, Config(**SMALL),
                                device="cpu").calibrate([x])
    y = make_predictor(spec, model, qstate)(x)
    assert y.device.type == "cuda" and y.shape == (4, 10)
    assert torch.isfinite(y).all()


@pytest.mark.cuda
def test_load_quantized_pth_on_card(cuda_device, tmp_path):
    spec, model = zoo.build_model("test_tiny", seed=1)
    x = np.random.default_rng(1).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    calib = QuantCalibrator(spec, model, Config(**SMALL), device="cpu")
    calib.calibrate([x])
    params, qstate = calib.finish_calibration()
    pth, v2 = str(tmp_path / "ref.pth"), str(tmp_path / "m.ckpt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                export_reference_state_dict(spec, Config(**SMALL), params,
                                            qstate).items()}, pth)
    save_checkpoint(v2, params, qstate)
    got = load_quantized("test_tiny", pth, config=Config(**SMALL))[0](x)
    want = load_quantized("test_tiny", v2, config=Config(**SMALL))[0](x)
    assert got.device.type == "cuda"
    assert torch.equal(got, want)
