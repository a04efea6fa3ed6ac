"""Serving API: a quantized model as one batch predictor, on one device or
over a mesh of ranks.

``load_quantized`` reads a v2 .ckpt (written by this package or by
``adalog_tpu``), a round-1 pickle of ``adalog_tpu``, or a reference-format
state dict (.pth/.pt/.bin, utils/ref_checkpoint.py) and returns ``predict(images) -> logits``: NHWC float32
images in, float32 logits out. Which kernel serves each site is decided
once, at load time, into the predictor's plan (ops/routes.py), with the
fake-quantized Linear weights: on a CUDA device every Linear site's
activation quantizer that ops/fq_act.py takes runs in one hand-written
pass, the attention of every block runs in the hand-written fused kernels
(ops/fq_attn.py) unless the caller turns them off, and, when the caller
turns it on (``Config``'s ``use_pallas_gemm``, off by default as in the JAX
package), every supported Linear site runs in the fused activation-quant
GEMM kernel (ops/fq_gemm.py). With ``Config``'s ``eval_int8`` every
uniform Linear site of at most 7 bits runs as an integer product in the
int8 GEMM kernel (ops/int8_linear.py), ahead of both.

Over a mesh (parallel/mesh.py; one process per rank, each calling the same
entry point with the same batches) every rank's ``predict`` takes the whole
batch and returns the whole batch's logits:

  - dp only: each rank runs the whole model on its batch slice;
  - dp x tp: each rank runs its weight and head slices (parallel/tp.py) on
    its batch slice, its tables built from those slices, so every kernel
    sees local shapes; the row-parallel sites sum over the tp group.

Either way a batch that dp does not divide is padded with zero images to a
multiple of dp and the padding's logits dropped (the JAX package pads under
dp x tp and runs a dp remainder whole on every device; the logits are the
same).
"""

from __future__ import annotations

import copy
import logging
from typing import Optional

import torch

from adalog_tpu_torch.utils.profiling import span

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


def local_forward(spec, params, qstate, *, eval_dtype: str = "float32",
                  cfg=None, use_kernels: bool = True,
                  use_gemm_kernels: bool = False, use_int8: bool = False,
                  device=None, row_group=None, row_sites=frozenset()):
    """``forward(images) -> logits`` on one device: ``make_predictor``'s body
    without the mesh, and each rank's forward over one. ``row_group`` and
    ``row_sites`` mark the row-parallel sites of a tp rank; those take
    neither the int8 nor the fused GEMM (``ops.routes.build``)."""
    from adalog_tpu_torch.calib.calibrator import _resolve_device
    from adalog_tpu_torch.models.zoo import model_forward_fn
    from adalog_tpu_torch.ops import routes
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
    plan = routes.build(spec, model, qs, cfg or Config(), dtype,
                        use_kernels=use_kernels,
                        use_gemm_kernels=use_gemm_kernels, use_int8=use_int8,
                        row_group=row_group, row_sites=row_sites)
    if use_int8:
        log.info("int8 eval: weight codes materialized for %d sites",
                 plan.count("int8"))

    def forward(x):
        with span("serve.h2d"):
            x = torch.as_tensor(x).to(device=device, dtype=dtype)
        with span("serve.forward"), torch.inference_mode(), \
                routes.activate(plan):
            return fwd(spec.cfg, model, x, qs, {"*": "quant"}).float()

    return forward


def make_predictor(spec, params, qstate, *, eval_dtype: str = "float32",
                   cfg=None, use_kernels: bool = True,
                   use_gemm_kernels: bool = False, use_int8: bool = False,
                   device=None, mesh=None):
    """Build ``predict(images) -> logits`` for a (model, qstate) pair.

    The model is copied to ``device`` (default: the first CUDA device,
    which raises where torch finds none; the tests pass 'cpu') in
    ``eval_dtype`` ('float32' or 'bfloat16'; quantizer math stays fp32);
    the caller's module is left as it was. ``use_kernels`` routes the
    attention through the fused kernels (the whole attention in one where
    the sites allow it, else the matmul kernels); False runs the plain
    PyTorch ops of the unfused path. ``use_gemm_kernels`` routes every
    Linear site that ``ops.fq_gemm.supports`` through the fused
    activation-quant GEMM, and the attention through its kernels too.
    ``use_int8`` runs every Linear site that ``ops.int8_linear.supports``
    as an integer product (the int8 GEMM kernel on a CUDA device), with
    weight codes computed here from the cast module; those sites then take
    neither a fake-quantized weight nor the fused GEMM. Which site takes
    which kernel is decided here, once, into a plan (``ops.routes.build``)
    that belongs to this predictor alone.

    ``mesh`` (parallel/mesh.py): every rank of the mesh calls this with the
    same arguments and then ``predict`` with the same batches; the model
    runs on ``mesh.device`` (``device`` must be None or the same), over dp
    batch slices and, with tp > 1, on the rank's weight and head slices
    (``parallel.tp.tp_eval_fn``). A batch that dp does not divide is padded
    with zero images, whose logits are dropped.
    """
    kw = dict(eval_dtype=eval_dtype, cfg=cfg, use_kernels=use_kernels,
              use_gemm_kernels=use_gemm_kernels, use_int8=use_int8,
              device=device)
    if mesh is None:
        run = local_forward(spec, params, qstate, **kw)

        def predict(x):
            with span("serve.predict"):
                return run(x)

        return predict
    from adalog_tpu_torch.parallel.mesh import gather_batch, shard_batch

    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    kw["device"] = mesh.device
    if mesh.tp > 1:
        from adalog_tpu_torch.parallel.tp import tp_eval_fn

        run, plan = tp_eval_fn(spec, params, qstate, mesh, **kw)
        log.info("tp eval over dp=%d x tp=%d: %d column / %d row sites "
                 "sliced", mesh.dp, mesh.tp, len(plan.col_sites),
                 len(plan.row_sites))
    else:
        run = local_forward(spec, params, qstate, **kw)

    def predict(x):
        with span("serve.predict"):
            x = torch.as_tensor(x)
            n = x.shape[0]
            pad = (-n) % mesh.dp
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            return gather_batch(run(shard_batch(x, mesh)), mesh)[:n]

    return predict


def load_quantized(model: str, checkpoint: str, *, config=None,
                   eval_dtype: Optional[str] = None, device="cuda",
                   mesh_devices: int = 0, mesh_tp: int = 1,
                   use_pallas: Optional[bool] = None,
                   backend: Optional[str] = None):
    """One-call deployment: model name + checkpoint -> predictor on
    ``device``. The checkpoint is a v2 .ckpt, a round-1 pickle, or a
    reference-format state dict (.pth/.pt/.bin).

    ``config``: a Config, a path to a config .py, or None for the shipped
    4-bit values. ``use_pallas`` (the config field's name) turns the fused
    attention kernel on or off; None takes ``config.use_pallas``, where
    None means on. ``config.use_pallas_gemm`` (default False) turns the
    fused activation-quant GEMM kernel on, and with it the attention
    kernel. ``config.eval_int8`` (None means off) serves the uniform Linear
    sites as integer products (``make_predictor``'s ``use_int8``); see
    ``ops.routes.switches``. Returns (predict, spec, model,
    qstate).

    ``mesh_devices`` > 1 (or -1: every rank of the run) serves over a mesh
    of that many ranks, ``mesh_tp`` of them a tp group: every rank calls
    this, in a process group of exactly that size (torchrun, or one the
    caller initialized). ``device`` follows the mesh's rules ('cuda' is
    cuda:{LOCAL_RANK}) and ``backend`` None is nccl for CUDA, gloo for the
    CPU (parallel/mesh.py).
    """
    from adalog_tpu_torch.models.zoo import model_spec
    from adalog_tpu_torch.ops.routes import switches
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
    mesh = None
    if mesh_tp > 1 and not mesh_devices:
        raise ValueError("mesh_tp > 1 requires mesh_devices (the total rank "
                         "count, dp*tp)")
    if mesh_devices:
        from adalog_tpu_torch.parallel.mesh import make_mesh_2d, world_size

        n = world_size() if mesh_devices == -1 else mesh_devices
        if n % mesh_tp:
            raise ValueError(f"mesh_tp={mesh_tp} must divide "
                             f"mesh_devices={n}")
        if n > 1:
            mesh = make_mesh_2d(n // mesh_tp, mesh_tp, device=device,
                                backend=backend)
            device = mesh.device
    spec = model_spec(model)
    kernels = switches(cfg, use_pallas)

    if checkpoint.endswith((".pth", ".pt", ".bin")):
        from adalog_tpu_torch.utils.ref_checkpoint import \
            load_reference_checkpoint
        params, qstate = load_reference_checkpoint(spec, cfg, checkpoint)
    else:
        params, qstate, _ = load_checkpoint(checkpoint, spec.cfg)
    gemm, int8 = kernels["use_gemm_kernels"], kernels["use_int8"]
    log.info("loaded %s (%s) on %s, fused attention kernel %s, fused GEMM "
             "kernel %s, int8 %s", spec.name, eval_dtype, device,
             "on" if kernels["use_kernels"] or gemm else "off",
             "on" if gemm else "off", "on" if int8 else "off")
    predict = make_predictor(spec, params, qstate, eval_dtype=eval_dtype,
                             cfg=cfg, device=None if mesh else device,
                             mesh=mesh, **kernels)
    return predict, spec, params, qstate
