"""The whole forward's share of the card's peak: the operations of one
image's forward counted from the configuration (``counts.forward_flops``)
times the images served a second in the traced run's window, over the
dense tensor-core peak the cell's path may use (bf16's 989 TFLOP/s for the
float32 cells, whose K1 runs its exact integer operands as bf16; int8's
1979 TOP/s for the int8 cell)."""

from portbench import counts

NAME = "serve.mfu_pct"
LAYER = "whole forward"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "serve_img_s"


def read(ctx):
    if not ctx.get("img_s"):
        return None
    int8 = ctx["arch"]["serving"]["eval_int8"]
    peak = counts.PEAK_FLOPS["int8" if int8 else "bfloat16"]
    return 100.0 * counts.forward_flops(ctx["arch"]) * ctx["img_s"] / peak
