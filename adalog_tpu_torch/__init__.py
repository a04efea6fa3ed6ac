"""AdaLog on PyTorch and CUDA: the port of ``adalog_tpu`` to NVIDIA Hopper.

Module names mirror ``adalog_tpu/`` one for one, so each module's JAX
counterpart sits at the same path in the other package. The port imports
``torch`` and never ``jax`` or ``adalog_tpu``.

Quantizer state is plain dataclasses of tensors with the JAX package's class
and field names; model parameters live in ``nn.Module``s whose
``state_dict()`` keys are timm's; forwards are plain functions on tensors.
Each TPU kernel of the JAX package becomes a hand-written CUDA kernel under
``csrc/`` with a plain PyTorch version beside it: the wrapper runs the plain
version for CPU tensors and the kernel for CUDA tensors.

  quantizers/  uniform, twin, log2, log-sqrt2, AdaLog, AdaRound (soft and
               hard forms), straight-through rounding
  models/      layers with quant sites, the ViT and Swin forwards (eval and
               training forms), zoo, timm loading
  calib/       the quant-site layouts, the uncalibrated qstate, reparam,
               candidate grids, the FPCS search families, the calibrator
  recon/       BRECQ block reconstruction: the block units (blocks.py) and
               the reconstructor (brecq.py)
  ops/         fused fake-quant attention (K1) and its fall-backs (K2, K3),
               fused activation-quant GEMM (K4), the kernels' build, weight
               prep, kernel defaults, calibration's candidate scoring
  data/        ImageFolder scanning, the timm eval and train transforms,
               the threaded loader and its native C++ decoder, synthetic data
  utils/       Config, checkpoints (v2, the JAX package's round-1 pickles,
               the reference's state dicts), the calibration and
               reconstruction resume log, metrics, profiling, weight
               carrying from the JAX package
  serve.py     load_quantized / make_predictor on one device
  cli.py       the reference-compatible CLI (python -m adalog_tpu_torch.cli)
"""

__version__ = "0.1.0"

from adalog_tpu_torch.utils.config import Config, load_config  # noqa: F401


def __getattr__(name):
    # lazy convenience API (keeps `import adalog_tpu_torch` light)
    if name == "QuantCalibrator":
        from adalog_tpu_torch.calib.calibrator import QuantCalibrator
        return QuantCalibrator
    if name == "BlockReconstructor":
        from adalog_tpu_torch.recon.brecq import BlockReconstructor
        return BlockReconstructor
    if name == "build_model":
        from adalog_tpu_torch.models.zoo import build_model
        return build_model
    if name == "model_forward_fn":
        from adalog_tpu_torch.models.zoo import model_forward_fn
        return model_forward_fn
    if name == "load_quantized":
        from adalog_tpu_torch.serve import load_quantized
        return load_quantized
    if name == "make_predictor":
        from adalog_tpu_torch.serve import make_predictor
        return make_predictor
    raise AttributeError(name)
