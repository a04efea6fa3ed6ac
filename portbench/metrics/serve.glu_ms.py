"""Device milliseconds a served batch spends in operations launched inside
the program's ``eva.glu`` span: EVA-02's gated product silu(gate) * value
of the SwiGLU MLP (its sub-LN counts under ``norm``). Read from a stretch
with the program's spans on (``portbench/spans.py``). Layer: the forward,
``adalog_tpu_torch/models/eva.py``."""

from portbench import spans

NAME = "serve.glu_ms"
LAYER = "forward (models/eva.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_img_s"


def read(ctx):
    return spans.per_batch(spans.measure(ctx), ["eva.glu"])
