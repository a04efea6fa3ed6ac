"""Device milliseconds a served batch spends in operations whose innermost
span is the program's ``serve.forward`` itself: what the forward's spans
leave unnamed (residual adds, the class token and position embedding).
Read from a stretch with the program's spans on (``portbench/spans.py``).
Layer: the forward, ``adalog_tpu_torch/models/{vit,swin,layers}.py``."""

from portbench import spans

NAME = "serve.forward_rest_ms"
LAYER = "forward (models/vit.py, models/swin.py, models/layers.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_img_s"


def read(ctx):
    return spans.per_batch(spans.measure(ctx), ["serve.forward"])
