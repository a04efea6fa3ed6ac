"""Run configuration.

The same protocol as ``adalog_tpu.utils.config``: a user config is a plain
.py file defining a ``Config`` class, and ``load_config`` copies the fields
this dataclass knows from it. Field names and defaults match the JAX
package's, so every config file in ``configs/`` loads unchanged; fields that
only the JAX package's calibration or TPU paths read are kept for that reason.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from dataclasses import dataclass, fields
from typing import Optional


@dataclass
class Config:
    # calibration settings (configs/4bit.py)
    calib_size: int = 32
    optim_size: int = 1024
    calib_batch_size: int = 32
    optim_batch_size: int = 32
    w_bit: int = 4
    a_bit: int = 4
    s_bit: int = 4
    qconv_a_bit: int = 8
    qhead_a_bit: int = 4
    matmul_head_channel_wise: bool = True
    post_softmax_quantizer: str = "adalog"
    post_gelu_quantizer: str = "adalog"
    # search settings
    eq_n: int = 128
    search_round: int = 3
    fpcs: bool = True
    steps: int = 6
    # optimization settings
    keep_gpu: bool = True
    train_act: bool = True
    # calibration-search settings of the JAX package
    search_dtype: str = "float32"
    search_precision: str = "default"
    w_search_gram: bool = True
    a_search_gram: bool = False
    batch_sites: bool = True
    batch_group_bytes: int = 1 << 29
    eval_dtype: str = "float32"     # 'float32' | 'bfloat16' eval forward
    capture_device_budget_bytes: int = 8 << 30
    capture_spill_dtype: str = "float32"
    capture_dtype: str = "float32"
    streaming_calib: str = "auto"
    recon_iters: int = 20000
    recon_block_group: int = 4
    recon_group_bytes: int = 1 << 29
    recon_seg_iters: int = 1000
    # Hand-written fused attention kernel (ops/fq_attn.py). The name is the
    # JAX package's, so config files keep loading. None = auto through
    # ops/kernel_defaults.py; an explicit True/False wins.
    use_pallas: Optional[bool] = None
    use_pallas_gemm: bool = False
    # true-int8 GEMMs for uniform Linear sites; not ported yet, so the
    # serving API raises on True. None = auto (False in the port).
    eval_int8: Optional[bool] = None

    @classmethod
    def from_object(cls, obj) -> "Config":
        """Build from any object with matching attributes (e.g. a user Config)."""
        kwargs = {}
        for f in fields(cls):
            if hasattr(obj, f.name):
                kwargs[f.name] = getattr(obj, f.name)
        return cls(**kwargs)


def load_config(path: str) -> Config:
    """Import ``Config`` from a user .py file."""
    path = os.path.abspath(path)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    user_cls = getattr(module, "Config")
    return Config.from_object(user_cls())
