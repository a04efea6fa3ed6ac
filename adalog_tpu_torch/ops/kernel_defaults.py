"""Per-model eval-kernel defaults, to be set by measurement on the GPU.

``Config.use_pallas`` (the hand-written fused attention kernel; the field
keeps the JAX package's name so config files load) and ``Config.eval_int8``
default to None = auto, which ``resolve_kernel_config`` fills from this
module. No model has been measured end to end on an H100 yet, so the table
is empty: the attention kernel is on for every model and int8 (the int8 GEMM
kernel, ops/int8_linear.py) is off unless a config sets it. The JAX
package's int8 verdicts were measured on another device and are not copied.
An explicit True/False always wins.
"""

from __future__ import annotations

# Exact-name verdicts, measured end to end on the GPU.
MEASURED: dict[str, dict[str, bool]] = {}


def kernel_defaults(spec) -> dict[str, bool]:
    """Measured defaults for ``spec`` (a models.zoo.ModelSpec), else the
    unmeasured default: attention kernel on, int8 off."""
    hit = MEASURED.get(spec.name)
    if hit is not None:
        return dict(hit)
    return {"use_pallas": True, "eval_int8": False}


def resolve_kernel_config(cfg, spec):
    """Fill ``cfg.use_pallas`` / ``cfg.eval_int8`` in place where they are
    None (= auto); explicit bools are left untouched. Returns cfg."""
    auto = kernel_defaults(spec)
    if cfg.use_pallas is None:
        cfg.use_pallas = auto["use_pallas"]
    if getattr(cfg, "eval_int8", None) is None:
        cfg.eval_int8 = auto["eval_int8"]
    return cfg
