"""K5's share of its roofline: the least time its calls could take
(``counts.int8_bound_ms`` of each integer Linear site's (T, K, O) from the
configuration: every Linear but the AdaLog fc2 sites) times the calls the
wrapper launched, over K5's device time by kernel name. Layer: kernel K5,
``adalog_tpu_torch/ops/int8_linear.py``."""

from portbench import counts

NAME = "k5.roofline_pct"
LAYER = "kernel K5 (ops/int8_linear.py, csrc/int8_gemm.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_img_s"


def read(ctx):
    t, n = ctx.get("trace"), ctx.get("launches")
    if not t or not n or not n.get("K5") or not t["class_ms"].get("K5"):
        return None
    sites = [(T, K, O) for kind, T, K, O in
             counts.linear_shapes(ctx["arch"], ctx["batch"])
             if kind != "fc2"]
    dtype = ctx["arch"]["eval_dtype"]
    per_forward = sum(counts.int8_bound_ms(T, K, O, dtype)[0]
                      for T, K, O in sites)
    return 100.0 * per_forward * n["K5"] / len(sites) / t["class_ms"]["K5"]
