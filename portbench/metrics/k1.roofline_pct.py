"""K1's share of its roofline: the least time its calls could take
(``counts.flash_bound_ms`` of each attention's (G, S, D, P) from the
configuration, reckoned for the variant the wrapper counted) times the
calls the wrapper launched, over K1's device time by kernel name. Layer:
kernel K1, ``adalog_tpu_torch/ops/fq_attn.py``."""

from portbench import counts

NAME = "k1.roofline_pct"
LAYER = "kernel K1 (ops/fq_attn.py, csrc/fq_flash_attn.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_img_s"


def read(ctx):
    t, n = ctx.get("trace"), ctx.get("launches")
    if not t or not n or not n.get("K1") or not t["class_ms"].get("K1"):
        return None
    calls = counts.attention_calls(ctx["arch"], ctx["batch"])
    dtype = ctx["arch"]["eval_dtype"]
    bound = 0.0
    for variant in ("mma", "fma"):
        share = n.get(f"K1.{variant}", 0) / len(calls)
        bound += share * sum(counts.flash_bound_ms(G, S, D, P, dtype,
                                                   variant)[0]
                             for G, S, D, P in calls)
    return 100.0 * bound / t["class_ms"]["K1"]
