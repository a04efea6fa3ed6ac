"""Milliseconds a served batch in which the device ran nothing while the
host was inside the program's ``serve.predict`` span: the idle that the
program causes, apart from the idle while the caller copies logits and
hands over the next batch. Read from a stretch with the program's spans
on (``portbench/spans.py``). Layer: the predictor,
``adalog_tpu_torch/serve.py``."""

from portbench import spans

NAME = "serve.predict_idle_ms"
LAYER = "predictor (serve.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_img_s"


def read(ctx):
    s = spans.measure(ctx)
    if not s or spans.PREDICT not in s["seen"]:
        return None
    return s["predict_idle_ms"] / s["batches"]
