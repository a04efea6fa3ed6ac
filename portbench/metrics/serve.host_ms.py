"""Host milliseconds a served batch spends inside ``predict`` before it
returns: call start to return, before the copy of the logits to the host
waits for the device. The mean over the window's batches of the traced
run. Layer: the predictor, ``adalog_tpu_torch/serve.py``."""

NAME = "serve.host_ms"
LAYER = "predictor (serve.py)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "serve_img_s"


def read(ctx):
    ms = ctx.get("host_ms")
    return sum(ms) / len(ms) if ms else None
