"""Device milliseconds a served batch spends in operations launched inside
the program's ``serve.h2d`` span: the images' copy from the host to the
card (and their cast). Read from a stretch with the program's spans on
(``portbench/spans.py``). Layer: the predictor,
``adalog_tpu_torch/serve.py``."""

from portbench import spans

NAME = "serve.h2d_ms"
LAYER = "predictor (serve.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_img_s"


def read(ctx):
    return spans.per_batch(spans.measure(ctx), ["serve.h2d"])
