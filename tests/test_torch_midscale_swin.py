"""The port's Swin calibration at the real 224 px, window 7 regime against
the reference fixture of tests/test_ref_midscale_swin_differential.py, on
that file's gates.

tests/fixtures/midscale_swin_ref.npz holds the logits, the PatchMerging
reduction bias and the AdaLog bases that the reference code produced once
from a timm-structured torch Swin (embed 48, depths 2-2, heads 3-6, 64
windows a shifted block at stage 0, shift masks at 56x56 and 28x28, a
56 -> 28 PatchMerging reparam), regenerated here from its seed by
scripts/midscale_swin_differential.py::make_model (tests/ref_bridge.py: no
timm, no download). The port calibrates the same model on the same 16
images at the fixture's W4A4 configuration (eq_n 32, one round, 6 steps)
on the CPU and finishes (the post-GeLU fold):

  - FP32 logits equal the reference's to 5e-4 (mean |diff|);
  - the reduction bias the PatchMerging reparam creates is in the
    reference's regime (|diff| <= max(1, |ref|));
  - the quantized logits approximate FP32 as well as the reference's
    (q_err within 1.3x both ways);
  - FP-prediction preservation within 4/n of the reference's (n = 64);
  - post-softmax AdaLog bases exact at >= 75% of the 4 blocks, post-GeLU
    bases exact or adjacent at every block and exact at >= half.

Minutes on the CPU (marked slow).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import midscale_swin_differential as ms  # noqa: E402

from adalog_tpu_torch.calib.calibrator import QuantCalibrator  # noqa: E402
from adalog_tpu_torch.calib.layout import tree_get  # noqa: E402
from adalog_tpu_torch.models.load import load_swin  # noqa: E402
from adalog_tpu_torch.models.swin import SwinConfig, swin_forward  # noqa: E402
from adalog_tpu_torch.models.zoo import ModelSpec  # noqa: E402
from adalog_tpu_torch.utils.config import Config  # noqa: E402

CFG = SwinConfig(img_size=ms.IMG, patch_size=ms.PATCH, embed_dim=ms.EMBED,
                 depths=ms.DEPTHS, heads=ms.HEADS, window=ms.WINDOW,
                 num_classes=ms.CLASSES)
SPEC = ModelSpec(name="midscale_swin", family="swin", cfg=CFG,
                 timm_id="midscale_swin")


def _logits(model, x, qstate=None):
    with torch.no_grad():
        return swin_forward(CFG, model, torch.from_numpy(x), qstate,
                            None if qstate is None else {"*": "quant"}
                            ).numpy()


@pytest.mark.slow
def test_midscale_swin_calibration_vs_reference():
    fx = np.load(ms.FIXTURE, allow_pickle=False)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    tm = ms.make_model()
    assert abs(ms.weight_checksum(tm) - float(fx["weight_checksum"])) < 1e-3
    model = load_swin(CFG, {k: v.detach().numpy()
                            for k, v in tm.state_dict().items()})
    calib_np, val_np = ms.make_data()
    cfg = Config(w_bit=ms.BITS, a_bit=ms.BITS, s_bit=ms.BITS,
                 qhead_a_bit=ms.BITS, eq_n=ms.EQ_N, search_round=ms.ROUNDS,
                 steps=ms.STEPS)
    calib = QuantCalibrator(SPEC, model, cfg, device="cpu")
    calib.calibrate([calib_np])
    params_q, qstate = calib.finish_calibration()
    ours = _logits(params_q, val_np, qstate)
    fp_ours = _logits(model, val_np)

    fp_err = float(np.abs(fp_ours - fx["fp_ref"]).mean())
    assert fp_err < 5e-4, fp_err

    red = tree_get(params_q, calib.layout["layers.1.downsample.reduction"]
                   .param_path).bias
    assert red is not None
    red = red.numpy()
    assert np.linalg.norm(red - fx["ref_red_b"]) <= \
        max(1.0, np.linalg.norm(fx["ref_red_b"]))

    q_err_ours = float(np.abs(ours - fp_ours).mean())
    q_err_ref = float(fx["q_err_ref"])
    assert q_err_ours <= q_err_ref * 1.3 and q_err_ref <= q_err_ours * 1.3, \
        (q_err_ours, q_err_ref)

    fp_pred = fp_ours.argmax(-1)
    n = fp_pred.shape[0]
    agree_ref = float((fx["ref_logits"].argmax(-1) == fp_pred).mean())
    agree_ours = float((ours.argmax(-1) == fp_pred).mean())
    assert agree_ours >= agree_ref - 4.0 / n, (agree_ours, agree_ref)

    blocks = [(i, j) for i, d in enumerate(ms.DEPTHS) for j in range(d)]
    q_post = [float(qstate[f"layers.{i}.blocks.{j}.attn.matmul2"].Aq.log_q)
              for i, j in blocks]
    q_gelu = [float(qstate[f"layers.{i}.blocks.{j}.mlp.fc2"].aq.log_q)
              for i, j in blocks]
    post_exact = sum(a == b for a, b in zip(q_post, fx["q_post"]))
    assert post_exact >= int(np.ceil(len(blocks) * 0.75)), \
        (q_post, list(fx["q_post"]))
    gelu_exact = sum(a == b for a, b in zip(q_gelu, fx["q_gelu"]))
    gelu_adj = sum(abs(a - b) <= 1 for a, b in zip(q_gelu, fx["q_gelu"]))
    assert gelu_adj == len(blocks), (q_gelu, list(fx["q_gelu"]))
    assert gelu_exact >= int(np.ceil(len(blocks) * 0.5)), \
        (q_gelu, list(fx["q_gelu"]))
    print(f"midscale swin: fp_err {fp_err:.3e}, q_err {q_err_ours:.5f} "
          f"(reference {q_err_ref:.5f}), FP agreement {agree_ours:.4f} "
          f"(reference {agree_ref:.4f}), post-softmax bases {q_post} "
          f"(reference {list(fx['q_post'])}), post-GeLU {q_gelu} "
          f"(reference {list(fx['q_gelu'])})")
