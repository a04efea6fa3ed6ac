"""Device milliseconds a served batch spends in operations launched inside
the program's ``norm`` span: the hand-written LayerNorm
(``models/layers.py::layer_norm``). Read from a stretch with the program's
spans on (``portbench/spans.py``). Layer: the forward,
``adalog_tpu_torch/models/{vit,swin,layers}.py``."""

from portbench import spans

NAME = "serve.norm_ms"
LAYER = "forward (models/vit.py, models/swin.py, models/layers.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_img_s"


def read(ctx):
    return spans.per_batch(spans.measure(ctx), ["norm"])
