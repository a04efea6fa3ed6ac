"""Serving API: a quantized model as one batch predictor on one device.

``load_quantized`` reads a v2 .ckpt (written by this package or by
``adalog_tpu``), a round-1 pickle of ``adalog_tpu``, or a reference-format
state dict (.pth/.pt/.bin, utils/ref_checkpoint.py) and returns ``predict(images) -> logits``: NHWC float32
images in, float32 logits out. Fake-quantized Linear weights are prepared
once at load time (ops/weight_prep.py); on a CUDA device the attention of
every block (ViT/DeiT) or window (Swin) runs in the hand-written fused
kernels (ops/fq_attn.py) unless the caller turns them off, and, when the
caller turns it on (``Config``'s ``use_pallas_gemm``, off by default as in
the JAX package), every supported Linear site runs in the fused
activation-quant GEMM kernel (ops/fq_gemm.py).

Multi-device meshes and the int8 GEMM path of the JAX package are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import logging
from typing import Optional

import torch

log = logging.getLogger("adalog_tpu_torch")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pin_fp32_matmul():
    """Full-fp32 matrix products on the GPU for the rest of the process, as
    the JAX package's fp32 eval pins Precision.HIGHEST. Every fp32 CUDA
    entry point calls it (serving here; calibration's capture and scoring in
    ``calib.calibrator.QuantCalibrator``). The patch-embed convolution pins
    its own precision, inside ``models.layers.qconv2d``, and leaves the
    process's setting alone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def make_predictor(spec, params, qstate, *, eval_dtype: str = "float32",
                   cfg=None, use_kernels: bool = True,
                   use_gemm_kernels: bool = False, device=None):
    """Build ``predict(images) -> logits`` for a (model, qstate) pair.

    The model is copied to ``device`` (default: the first CUDA device,
    which raises where torch finds none; the tests pass 'cpu') in
    ``eval_dtype`` ('float32' or 'bfloat16'; quantizer math stays fp32);
    the caller's module is left as it was. ``use_kernels`` routes the
    attention through the fused kernels (the whole attention in one where
    the sites allow it, else the matmul kernels); False runs the plain
    PyTorch ops of the unfused path. ``use_gemm_kernels`` routes every
    Linear site that ``ops.fq_gemm.supports`` through the fused
    activation-quant GEMM, and the attention through its kernels too; which
    sites take it is decided here, once.
    """
    from adalog_tpu_torch.calib.calibrator import _resolve_device
    from adalog_tpu_torch.models.zoo import model_forward_fn
    from adalog_tpu_torch.ops import fq_attn, fq_gemm, weight_prep
    from adalog_tpu_torch.quantizers.state import map_tensors
    from adalog_tpu_torch.utils.config import Config

    if eval_dtype not in _DTYPES:
        raise ValueError(f"eval_dtype {eval_dtype!r}: want float32 or bfloat16")
    dtype = _DTYPES[eval_dtype]
    fwd = model_forward_fn(spec)
    device = _resolve_device(device, "make_predictor", "serve")
    if device.type == "cuda" and dtype == torch.float32:
        pin_fp32_matmul()

    model = copy.deepcopy(params).to(device=device, dtype=dtype)
    model.requires_grad_(False)
    qs = map_tensors(lambda t: t.to(device), qstate)
    wprep = weight_prep.prepare(spec, model, qs, cfg or Config())
    gemm_table = None
    if use_gemm_kernels:
        # the weights as integers let fp32 inputs take the tensor-core
        # variant of the GEMM kernel; bf16 inputs take it as they are
        codes = weight_prep.weight_codes(spec, model, qs, cfg or Config()) \
            if dtype == torch.float32 else None
        gemm_table = fq_gemm.prepare(qs, codes)
    # read once here, so that no served call waits for the device to learn
    # which variant of the attention kernel its zero points allow
    exact_ints = fq_attn.integers_exact(qs) \
        if use_kernels or use_gemm_kernels else None
    # and each attention matmul site's per-head parameters flattened once
    attn_params = fq_attn.prepare(qs) \
        if use_kernels or use_gemm_kernels else None

    def predict(x):
        x = torch.as_tensor(x).to(device=device, dtype=dtype)
        with torch.inference_mode(), weight_prep.activate(wprep), \
                fq_attn.activate(use_kernels, exact_ints, attn_params), \
                fq_gemm.activate(gemm_table):
            return fwd(spec.cfg, model, x, qs, {"*": "quant"}).float()

    return predict


def load_quantized(model: str, checkpoint: str, *, config=None,
                   eval_dtype: Optional[str] = None, device="cuda",
                   mesh_devices: int = 0, mesh_tp: int = 1,
                   use_pallas: Optional[bool] = None):
    """One-call deployment: model name + checkpoint -> predictor on
    ``device``. The checkpoint is a v2 .ckpt, a round-1 pickle, or a
    reference-format state dict (.pth/.pt/.bin).

    ``config``: a Config, a path to a config .py, or None for the shipped
    4-bit values. ``use_pallas`` (the config field's name) turns the fused
    attention kernel on or off; None takes ``config.use_pallas``, resolved
    by ops/kernel_defaults.py. ``config.use_pallas_gemm`` (default False)
    turns the fused activation-quant GEMM kernel on, and with it the
    attention kernel. Returns (predict, spec, model, qstate).
    """
    from adalog_tpu_torch.models.zoo import model_spec
    from adalog_tpu_torch.ops.kernel_defaults import resolve_kernel_config
    from adalog_tpu_torch.utils.checkpoint import load_checkpoint
    from adalog_tpu_torch.utils.config import Config, load_config

    if config is None:
        cfg = Config(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)
    elif isinstance(config, str):
        cfg = load_config(config)
    else:
        cfg = config
    if eval_dtype is None:
        eval_dtype = getattr(cfg, "eval_dtype", "float32")
    if mesh_devices == -1:
        # all local devices, as in the JAX package: one device serves
        on_cpu = torch.device(device).type == "cpu"
        mesh_devices = 1 if on_cpu else torch.cuda.device_count()
    if mesh_devices not in (0, 1) or mesh_tp != 1:
        raise NotImplementedError(
            "multi-device serving is not ported to PyTorch yet")
    spec = model_spec(model)
    resolve_kernel_config(cfg, spec)
    if cfg.eval_int8:
        raise NotImplementedError(
            "eval_int8: the int8 GEMM path is not ported to PyTorch yet")
    enable = cfg.use_pallas if use_pallas is None else use_pallas
    gemm = bool(cfg.use_pallas_gemm)

    if checkpoint.endswith((".pth", ".pt", ".bin")):
        from adalog_tpu_torch.utils.ref_checkpoint import \
            load_reference_checkpoint
        params, qstate = load_reference_checkpoint(spec, cfg, checkpoint)
    else:
        params, qstate, _ = load_checkpoint(checkpoint, spec.cfg)
    log.info("loaded %s (%s) on %s, fused attention kernel %s, fused GEMM "
             "kernel %s", spec.name, eval_dtype, device,
             "on" if enable or gemm else "off", "on" if gemm else "off")
    predict = make_predictor(spec, params, qstate, eval_dtype=eval_dtype,
                             cfg=cfg, use_kernels=bool(enable),
                             use_gemm_kernels=gemm, device=device)
    return predict, spec, params, qstate
