"""Device milliseconds a served batch spends in operations launched inside
the program's ``eva.rope`` span: EVA-02's 2D rotary position embedding, the
rotation of the patch tokens' q and k before the attention kernel, and its
sine and cosine tables. Read from a stretch with the program's spans on
(``portbench/spans.py``). Layer: the forward,
``adalog_tpu_torch/models/eva.py``."""

from portbench import spans

NAME = "serve.rope_ms"
LAYER = "forward (models/eva.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_img_s"


def read(ctx):
    return spans.per_batch(spans.measure(ctx), ["eva.rope"])
