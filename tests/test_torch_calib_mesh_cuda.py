"""Calibration over a mesh on an NVIDIA GPU: two gloo ranks on cuda:0 (NCCL
refuses two ranks on one card) calibrate test_tiny through
QuantCalibrator(mesh=) and are held to the single-device calibration on the
same card. Skipped without a CUDA device.

This file imports no jax, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_calib_mesh_cuda.py

Gates (tests/test_torch_calib_mesh.py's): the ranks bit-equal; at most
max(2, total // 20) quantizer fields past rtol 1e-4 / atol 1e-5 of the
single-device state; the quantized logits' error to the raw model within
1.05x of the single-device run's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import torch_calib_mesh_ranks as ranks
from adalog_tpu_torch.calib.calibrator import QuantCalibrator
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.parallel.mesh import spawn
from adalog_tpu_torch.quantizers.state import map_tensors
from adalog_tpu_torch.utils.checkpoint import load_checkpoint
from adalog_tpu_torch.utils.config import Config


def _fields(tree, prefix=""):
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        elif isinstance(v, torch.Tensor):
            yield prefix + f.name, v


def _error(spec, model, qstate, x):
    fwd = zoo.model_forward_fn(spec)
    with torch.no_grad():
        y = fwd(spec.cfg, model, x, qstate, {"*": "quant"})
        return float(torch.linalg.norm(y - fwd(spec.cfg, model, x)))


@pytest.mark.cuda
def test_two_ranks_on_one_card_match_the_single_device_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    images = np.random.default_rng(1).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    np.save(tmp_path / "images.npy", images)
    spawn(ranks.card_calibrate, 2, (str(tmp_path),), backend="gloo",
          init_file=str(tmp_path / "rendezvous"), timeout=600)
    spec, model = zoo.build_model("test_tiny", seed=0)
    dev = torch.device("cuda", 0)
    sp, sq = QuantCalibrator(spec, model, Config(**ranks.SMALL),
                             device=dev).calibrate([images])
    states = [load_checkpoint(str(tmp_path / f"card_r{r}.ckpt"),
                              spec.cfg)[:2] for r in range(2)]
    (p0, q0), (p1, q1) = states
    for k, v in p0.state_dict().items():
        assert torch.equal(v, p1.state_dict()[k]), k
    bad = total = 0
    for nm in sq:
        a, b, c = (dict(_fields(q[nm])) for q in (q0, q1, sq))
        for k in c:
            assert torch.equal(a[k], b[k]), (nm, k)
            total += 1
            bad += not np.allclose(a[k].float().numpy(),
                                   c[k].float().cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
    assert bad <= max(2, total // 20), (bad, total)
    x = torch.from_numpy(images).to(dev)
    q0 = map_tensors(lambda t: t.to(dev), q0)
    assert _error(spec, p0.to(dev), q0, x) <= 1.05 * _error(spec, sp, sq, x)
