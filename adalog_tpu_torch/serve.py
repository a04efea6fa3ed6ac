"""Serving API: a quantized model as one batch predictor on one device.

``load_quantized`` reads a v2 .ckpt (written by this package or by
``adalog_tpu``) and returns ``predict(images) -> logits``: NHWC float32
images in, float32 logits out. Fake-quantized Linear weights are prepared
once at load time (ops/weight_prep.py); on a CUDA device the attention of
every block runs in the hand-written fused kernel (ops/fq_attn.py) unless
the caller turns it off.

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


def _pin_fp32_precision():
    """Full-fp32 products and convolutions on the GPU, as the JAX package's
    fp32 eval pins Precision.HIGHEST: cuDNN would otherwise run the
    patch-embed conv in TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def make_predictor(spec, params, qstate, *, eval_dtype: str = "float32",
                   cfg=None, use_kernels: bool = True, device=None):
    """Build ``predict(images) -> logits`` for a (model, qstate) pair.

    The model is copied to ``device`` (default: the model's) in
    ``eval_dtype`` ('float32' or 'bfloat16'; quantizer math stays fp32);
    the caller's module is left as it was. ``use_kernels`` routes the
    attention through the fused kernel; False runs the plain PyTorch ops
    of the unfused path.
    """
    from adalog_tpu_torch.models.zoo import model_forward_fn
    from adalog_tpu_torch.ops import fq_attn, weight_prep
    from adalog_tpu_torch.quantizers.state import map_tensors
    from adalog_tpu_torch.utils.config import Config

    if eval_dtype not in _DTYPES:
        raise ValueError(f"eval_dtype {eval_dtype!r}: want float32 or bfloat16")
    dtype = _DTYPES[eval_dtype]
    fwd = model_forward_fn(spec)
    device = torch.device(device) if device is not None \
        else params.head.weight.device
    if device.type == "cuda" and dtype == torch.float32:
        _pin_fp32_precision()

    model = copy.deepcopy(params).to(device=device, dtype=dtype)
    model.requires_grad_(False)
    qs = map_tensors(lambda t: t.to(device), qstate)
    wprep = weight_prep.prepare(spec, model, qs, cfg or Config())

    def predict(x):
        x = torch.as_tensor(x).to(device=device, dtype=dtype)
        with torch.inference_mode(), weight_prep.activate(wprep), \
                fq_attn.activate(use_kernels):
            return fwd(spec.cfg, model, x, qs, {"*": "quant"}).float()

    return predict


def load_quantized(model: str, checkpoint: str, *, config=None,
                   eval_dtype: Optional[str] = None, device="cuda",
                   mesh_devices: int = 0, mesh_tp: int = 1,
                   use_pallas: Optional[bool] = None):
    """One-call deployment: model name + v2 .ckpt -> predictor on ``device``.

    ``config``: a Config, a path to a config .py, or None for the shipped
    4-bit values. ``use_pallas`` (the config field's name) turns the fused
    attention kernel on or off; None takes ``config.use_pallas``, resolved
    by ops/kernel_defaults.py. Returns (predict, spec, model, qstate).
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
    if mesh_devices not in (0, 1) or mesh_tp != 1:
        raise NotImplementedError(
            "multi-device serving is not ported to PyTorch yet")
    if checkpoint.endswith((".pth", ".pt", ".bin")):
        raise NotImplementedError(
            "reference-format (.pth) checkpoints are not ported to PyTorch "
            "yet; load a v2 .ckpt")

    spec = model_spec(model)
    if spec.family != "vit":
        raise NotImplementedError(
            f"{spec.name}: the Swin family is not ported to PyTorch yet")
    resolve_kernel_config(cfg, spec)
    if cfg.eval_int8:
        raise NotImplementedError(
            "eval_int8: the int8 GEMM path is not ported to PyTorch yet")
    enable = cfg.use_pallas if use_pallas is None else use_pallas

    params, qstate, _ = load_checkpoint(checkpoint, spec.cfg)
    log.info("loaded %s (%s) on %s, fused attention kernel %s",
             spec.name, eval_dtype, device, "on" if enable else "off")
    predict = make_predictor(spec, params, qstate, eval_dtype=eval_dtype,
                             cfg=cfg, use_kernels=bool(enable), device=device)
    return predict, spec, params, qstate
