"""Device milliseconds a served batch spends in kernels that are none of
the port's K1-K5 and not cuBLAS or cuDNN: the elementwise work of the
forward (fake quantization of the unfused Linear sites, LayerNorm, GeLU,
softmax, rolls and window copies), by ``trace.kernel_class``. Layer: the
forward, ``adalog_tpu_torch/models/{vit,swin,layers}.py``."""

NAME = "serve.other_ms"
LAYER = "forward (models/vit.py, models/swin.py, models/layers.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "serve_img_s"


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    return t["class_ms"].get("other", 0.0) / t["batches"]
