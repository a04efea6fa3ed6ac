"""The share of the traced stretch of served batches in which no operation
ran on the device: 1 - busy / window, busy the union of the device events
(``trace.busy_us``). Layer: the device."""

NAME = "idle_pct.serve"
LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_img_s"


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
