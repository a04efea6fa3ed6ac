"""Device milliseconds a served batch spends in operations launched inside
the program's ``fq.act.<kind>`` spans: the activation fake quantizers of
the sites that no kernel fuses (``models/layers.py``). Read from a stretch
with the program's spans on (``portbench/spans.py``). Layer: the forward,
``adalog_tpu_torch/models/{vit,swin,layers}.py``."""

from portbench import spans

KINDS = ("uniform", "twin", "log2", "logsqrt2", "adalog")

NAME = "serve.actq_ms"
LAYER = "forward (models/vit.py, models/swin.py, models/layers.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_img_s"


def read(ctx):
    return spans.per_batch(spans.measure(ctx),
                           ["fq.act." + k for k in KINDS])
