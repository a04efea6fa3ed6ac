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

  quantizers/  uniform, twin, log2, log-sqrt2, AdaLog, AdaRound (hard form)
  models/      layers with quant sites, the ViT and Swin forwards, zoo, timm
               loading
  calib/       the quant-site layouts, the uncalibrated qstate, reparam,
               candidate grids, the FPCS search families, the calibrator
  ops/         fused fake-quant attention (K1) and its fall-backs (K2, K3),
               fused activation-quant GEMM (K4), the kernels' build, weight
               prep, kernel defaults, calibration's candidate scoring
  utils/       Config, v2 checkpoints, the calibration resume log, weight
               carrying from the JAX package
  serve.py     load_quantized / make_predictor on one device
"""

__version__ = "0.1.0"

from adalog_tpu_torch.utils.config import Config, load_config  # noqa: F401
