"""The port's calibration and block reconstruction at deit-tiny shape (img
224, dim 192, depth 12, 197 tokens, 1000 classes) against the reference
fixtures of tests/test_ref_midscale_differential.py, on that file's gates.

The fixtures (tests/fixtures/midscale_ref*.npz, midscale_brecq_ref.npz)
hold the logits, AdaLog bases and per-block reconstruction errors the
reference code produced once from a torch model regenerated here from its
stored seed (scripts/midscale_differential.py). The port runs the same
reduced configuration on the CPU:

  - calibrate (two seed sets, eq_n 32): FP32 logits equal the reference's
    to 5e-4; quantized logits approximate FP32 as well as the reference's
    (q_err within 1.3x both ways); FP-prediction preservation within 4/n
    of the reference's; post-softmax AdaLog bases exact at >= 75% of the
    depths, post-GeLU bases exact or adjacent at every depth;
  - calibrate (eq_n 64) + BRECQ (300 steps a unit, optimization set ==
    batch == 16) + the post-GeLU fold: every block's final error on the
    pristine I/O within 0.5-2x of the reference's and their geometric mean
    within 0.75-1.33; q_err within 1.4x; the optimize / calibrate
    degradation factor within +-0.05 of the reference's; FP-prediction
    preservation within 4/n;
  - the port against the JAX package itself at seed set 1 (calibrate):
    integer picks site by site and the validation logits.

Each takes minutes on the CPU (marked slow).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import midscale_differential as md  # noqa: E402

from adalog_tpu_torch.calib.calibrator import QuantCalibrator  # noqa: E402
from adalog_tpu_torch.models.load import load_vit  # noqa: E402
from adalog_tpu_torch.models.vit import ViTConfig, vit_forward  # noqa: E402
from adalog_tpu_torch.models.zoo import ModelSpec  # noqa: E402
from adalog_tpu_torch.recon.blocks import block_units  # noqa: E402
from adalog_tpu_torch.recon.brecq import (  # noqa: E402
    BlockReconstructor, capture_block_io,
)
from adalog_tpu_torch.utils.config import Config  # noqa: E402

CFG = ViTConfig(img_size=md.IMG, patch_size=md.PATCH, dim=md.DIM,
                depth=md.DEPTH, heads=md.HEADS, num_classes=md.CLASSES)
SPEC = ModelSpec(name="midscale", family="vit", cfg=CFG, timm_id="midscale")


def _logits(model, x, qstate=None):
    with torch.no_grad():
        return vit_forward(CFG, model, torch.from_numpy(x), qstate,
                           None if qstate is None else {"*": "quant"}
                           ).numpy()


def _port_pipeline(seed_set, optimize, val_n, eq_n):
    """The port's calibrate (+ BRECQ) at the fixture configuration on the
    CPU, the counterpart of md._our_pipeline."""
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    seed_model, seed_data = md.SEEDS[seed_set]
    tm = md.make_model(seed_model)
    out = dict(weight_checksum=md.weight_checksum(tm))
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    calib_np, val_np = md.make_data(seed_data, val_n)
    model = load_vit(CFG, sd)
    cfg = Config(w_bit=md.BITS, a_bit=md.BITS, s_bit=md.BITS,
                 qhead_a_bit=md.BITS, eq_n=eq_n, search_round=md.ROUNDS,
                 steps=md.STEPS, recon_iters=md.RECON_ITERS,
                 optim_batch_size=md.OPT_BATCH)
    calib = QuantCalibrator(SPEC, model, cfg, device="cpu")
    params_q, qstate = calib.calibrate([calib_np])
    if optimize:
        out["logits_calib"] = _logits(params_q, val_np, qstate)
        recon = BlockReconstructor(SPEC, params_q, model, qstate,
                                   calib.layout, cfg, device="cpu")
        params_q, qstate = recon.reconstruct([calib_np], quant_act=True)
        calib.params, calib.qstate = params_q, dict(qstate)
        params_q, qstate = calib.finish_calibration()
        # each block's final error: the reconstructed block in quant mode
        # on the pristine model's I/O, as the fixture's reference side
        io = capture_block_io(SPEC, model, [calib_np])
        out["block_rec"] = {}
        with torch.no_grad():
            for u in block_units(SPEC):
                rin, rout = io[u.name]
                qsb = {cn: qstate[nm] for nm, cn in u.canon.items()
                       if nm in qstate}
                pred = u.forward(u.extract(params_q), qsb, rin,
                                 {cn: "quant" for cn in qsb}, False, False)
                out["block_rec"][u.name] = float(((pred - rout) ** 2).mean())
    else:
        params_q, qstate = calib.finish_calibration()
    out["logits"] = _logits(params_q, val_np, qstate)
    out["fp_ours"] = _logits(model, val_np)
    out["qstate"] = qstate
    return out


@pytest.mark.slow
@pytest.mark.parametrize("seed_set", sorted(md.SEEDS))
def test_midscale_calibration_vs_reference(seed_set):
    fx = np.load(md.FIXTURES[seed_set], allow_pickle=False)
    meta = json.loads(str(fx["meta"]))
    r = _port_pipeline(seed_set, False, meta["val_n"], md.EQ_N)
    assert abs(r["weight_checksum"] - float(fx["weight_checksum"])) < 1e-3
    fp_err = float(np.abs(r["fp_ours"] - fx["fp_ref"]).mean())
    assert fp_err < 5e-4, fp_err
    q_err_ours = float(np.abs(r["logits"] - r["fp_ours"]).mean())
    q_err_ref = float(fx["q_err_ref"])
    assert q_err_ours <= q_err_ref * 1.3 and q_err_ref <= q_err_ours * 1.3, \
        (q_err_ours, q_err_ref)
    fp_pred = r["fp_ours"].argmax(-1)
    n = fp_pred.shape[0]
    agree_ref = float((fx["ref_logits"].argmax(-1) == fp_pred).mean())
    agree_ours = float((r["logits"].argmax(-1) == fp_pred).mean())
    assert agree_ours >= agree_ref - 4.0 / n, (agree_ours, agree_ref)
    qs = r["qstate"]
    q_post = [float(qs[f"blocks.{i}.attn.matmul2"].Aq.log_q)
              for i in range(md.DEPTH)]
    q_gelu = [float(qs[f"blocks.{i}.mlp.fc2"].aq.log_q)
              for i in range(md.DEPTH)]
    post_exact = sum(a == b for a, b in zip(q_post, fx["q_post"]))
    assert post_exact >= int(np.ceil(md.DEPTH * 0.75)), \
        (q_post, list(fx["q_post"]))
    assert all(abs(a - b) <= 1 for a, b in zip(q_gelu, fx["q_gelu"])), \
        (q_gelu, list(fx["q_gelu"]))
    print(f"midscale calibrate seed set {seed_set}: fp_err {fp_err:.3e}, "
          f"q_err {q_err_ours:.4f} (ref {q_err_ref:.4f}), FP agreement "
          f"{agree_ours:.4f} (ref {agree_ref:.4f}), post-softmax bases exact "
          f"{post_exact}/{md.DEPTH}")


@pytest.mark.slow
def test_midscale_brecq_vs_reference():
    fx = np.load(md.BRECQ_FIXTURE, allow_pickle=False)
    meta = json.loads(str(fx["meta"]))
    assert meta["recon_iters"] == md.RECON_ITERS
    assert meta["opt_batch"] == md.OPT_BATCH == meta["calib_n"]
    r = _port_pipeline(0, True, meta["val_n"], meta["eq_n"])
    assert abs(r["weight_checksum"] - float(fx["weight_checksum"])) < 1e-3
    fp_err = float(np.abs(r["fp_ours"] - fx["fp_ref"]).mean())
    assert fp_err < 5e-4, fp_err

    ref_rec = {str(n): float(e)
               for n, e in zip(fx["block_names"], fx["block_rec"])}
    ours = r["block_rec"]
    assert set(ref_rec) == set(ours), (sorted(ref_rec), sorted(ours))
    ratios = np.array([ours[n] / ref_rec[n] for n in sorted(ref_rec)])
    gmean = float(np.exp(np.log(ratios).mean()))
    assert (ratios < 2.0).all() and (ratios > 0.5).all(), \
        dict(zip(sorted(ref_rec), ratios.round(3)))
    assert 0.75 <= gmean <= 1.33, (gmean, ratios.round(3))

    q_err_ours = float(np.abs(r["logits"] - r["fp_ours"]).mean())
    q_err_ref = float(fx["q_err_opt"])
    assert q_err_ours <= q_err_ref * 1.4 and q_err_ref <= q_err_ours * 1.4, \
        (q_err_ours, q_err_ref)
    q_err_calib = float(np.abs(r["logits_calib"] - r["fp_ours"]).mean())
    factor_ours = q_err_ours / q_err_calib
    factor_ref = float(fx["q_err_opt"]) / float(fx["q_err_calib"])
    assert abs(factor_ours - factor_ref) <= 0.05, (factor_ours, factor_ref)

    fp_pred = r["fp_ours"].argmax(-1)
    n = fp_pred.shape[0]
    agree_ref = float((fx["ref_logits_opt"].argmax(-1) == fp_pred).mean())
    agree_ours = float((r["logits"].argmax(-1) == fp_pred).mean())
    assert agree_ours >= agree_ref - 4.0 / n, (agree_ours, agree_ref)
    print(f"midscale BRECQ: block rec ratios {ratios.round(3).tolist()} "
          f"(gmean {gmean:.4f}); q_err {q_err_ours:.4f} (ref "
          f"{q_err_ref:.4f}); factor {factor_ours:.4f} (ref "
          f"{factor_ref:.4f}); FP agreement {agree_ours:.4f} (ref "
          f"{agree_ref:.4f})")


def _site_leaves(site, prefix=""):
    import dataclasses
    for f in dataclasses.fields(site):
        v = getattr(site, f.name)
        if dataclasses.is_dataclass(v):
            yield from _site_leaves(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


@pytest.mark.slow
def test_midscale_port_vs_jax_direct_diff():
    """The port against the JAX package itself (not the reference) on the
    calibrate-only fixture configuration of seed set 1: site by site, the
    integer picks (zero points, AdaLog bases) and scales, and the
    validation logits. The two differ where FPCS meets a near-tie: the
    JAX package's searches run jitted, and XLA evaluates the same formulas
    with fused multiply-adds and multiplies by reciprocals (candidate
    scales an ulp apart) and sums in other orders. Gates: at least
    PICKS_EQUAL of the picks equal, and the port's FP-prediction agreement
    within 4/n of the JAX package's. Prints the first differing site and
    both agreements."""
    import jax
    PICKS_EQUAL = 0.999
    fx = np.load(md.FIXTURES[1], allow_pickle=False)
    val_n = json.loads(str(fx["meta"]))["val_n"]
    rj = md._our_pipeline(1, optimize=False, val_n=val_n)
    rp = _port_pipeline(1, False, val_n, md.EQ_N)
    qj = jax.tree_util.tree_map(np.asarray, rj["qstate"])
    qp = rp["qstate"]
    assert sorted(qj) == sorted(qp)
    picks = differ = 0
    first = None
    for name in qp:                          # the port's: layout order
        got = dict(_site_leaves(qp[name]))
        for path, want in _site_leaves(qj[name]):
            if path.split(".")[-1] not in ("zero_point", "log_q") or \
                    want is None:
                continue
            d = int((got[path].numpy() != want).sum())
            picks += want.size
            differ += d
            if d and first is None:
                first = (name, path, d, want.size)
    fp = rp["fp_ours"].argmax(-1)
    n = fp.shape[0]
    agree_port = float((rp["logits"].argmax(-1) == fp).mean())
    agree_jax = float((rj["logits"].argmax(-1) == fp).mean())
    agree_ref = float((fx["ref_logits"].argmax(-1) == fp).mean())
    print(f"midscale seed set 1, port vs JAX: {differ} of {picks} integer "
          f"picks differ, first at {first}; logits max|diff| "
          f"{np.abs(rp['logits'] - rj['logits']).max():.4f}; FP agreement "
          f"port {agree_port:.4f}, JAX {agree_jax:.4f}, reference "
          f"{agree_ref:.4f}")
    assert np.abs(rp["fp_ours"] - rj["fp_ours"]).max() < 5e-4
    assert differ <= (1 - PICKS_EQUAL) * picks, (differ, picks, first)
    assert agree_port >= agree_jax - 4.0 / n, (agree_port, agree_jax)
