"""Device milliseconds a served batch spends in operations launched inside
the program's ``swin.window`` and ``swin.bias`` spans: Swin's rolls,
window partition and reverse, the patch merge's gather, and the rel-pos
bias gathered (with the shift mask added) on every block. Read from a
stretch with the program's spans on (``portbench/spans.py``). Layer: the
forward, ``adalog_tpu_torch/models/swin.py``."""

from portbench import spans

NAME = "serve.window_ms"
LAYER = "forward (models/vit.py, models/swin.py, models/layers.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_img_s"


def read(ctx):
    return spans.per_batch(spans.measure(ctx), ["swin.window", "swin.bias"])
