"""Deployment export of calibrated models.

The counterpart of ``adalog_tpu.utils.export``, on ``torch.export``: the
quantized forward is traced into an ExportedProgram with the weights and
the quantizer state as its constants, serialized to bytes
(``torch.export.save``) and loaded back without the Python model definition
(``torch.export.load(...).module()``); only image batches cross the
boundary.

The exported program is the plain PyTorch forward: the port's kernels are
ctypes calls, which ``torch.export`` cannot trace (registering them as
``torch.library`` ops would let it). The JAX package exports its XLA forward
with the process's kernel switches at their defaults. JAX's ``platforms=``
is ``device=`` here: the program holds its constants on the device it was
exported on.
"""

from __future__ import annotations

import copy
import io

import torch

from adalog_tpu_torch.models.zoo import model_forward_fn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Serving(torch.nn.Module):
    """(images NHWC float32) -> logits float32 of one quantized model."""

    def __init__(self, spec, model, qstate, dtype):
        super().__init__()
        self.model = model
        self.spec, self.qstate, self.dtype = spec, qstate, dtype
        self.fwd = model_forward_fn(spec)

    def forward(self, x):
        return self.fwd(self.spec.cfg, self.model, x.to(self.dtype),
                        self.qstate, {"*": "quant"}).float()


def make_serving_fn(spec, params, qstate, *, eval_dtype: str = "float32",
                    device=None) -> torch.nn.Module:
    """A module (images NHWC float32) -> logits float32 with the model and
    its quantizer state on ``device`` (default: the first CUDA device; the
    tests pass 'cpu'), the model cast to ``eval_dtype``; the caller's
    module is left as it was."""
    from adalog_tpu_torch.calib.calibrator import _resolve_device
    from adalog_tpu_torch.quantizers.state import map_tensors

    dtype = _DTYPES[eval_dtype]
    device = _resolve_device(device, "make_serving_fn", "export")
    model = copy.deepcopy(params).to(device=device, dtype=dtype)
    model.requires_grad_(False)
    qs = map_tensors(lambda t: t.to(device), qstate)
    return _Serving(spec, model, qs, dtype).eval()


def export_quantized(spec, params, qstate, batch_size: int, *,
                     eval_dtype: str = "float32", device=None) -> bytes:
    """Serialize the quantized forward at ``batch_size`` images to bytes.

    One eager forward runs first, so that every constant the forward
    caches (Swin's gather index and shift masks) is a real tensor before
    the trace reads it."""
    serve = make_serving_fn(spec, params, qstate, eval_dtype=eval_dtype,
                            device=device)
    s = spec.cfg.img_size
    x = torch.zeros((batch_size, s, s, 3), dtype=torch.float32,
                    device=next(serve.model.parameters()).device)
    with torch.no_grad():
        serve(x)
        program = torch.export.export(serve, (x,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob: bytes):
    """Deserialize and return a callable (images, numpy or a tensor) ->
    logits on the device the program was exported on."""
    module = torch.export.load(io.BytesIO(blob)).module()
    device = next(module.parameters()).device

    def serve(x):
        with torch.no_grad():
            return module(torch.as_tensor(x).to(device))

    return serve
