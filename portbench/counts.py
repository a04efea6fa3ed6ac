"""The yardstick's arithmetic: published peaks of one H100, the least time
a kernel call could take from its shapes, and the operations of a forward
pass counted from the configuration, whatever runs them.

``PEAK_*``, ``bound_ms``, ``flash_bound_ms`` and ``int8_bound_ms`` are
frozen copies of ``chip_smoke.py`` (lines 435-445, 469-481 and 977-984 at
the commit that added this benchmark): each input and output counted once,
operations at the rate of the unit that runs them. ``linear_shapes``,
``attention_calls`` and ``forward_flops`` are the benchmark's own, the
first two each model family's (``portbench/families/<family>.py``).
"""

from __future__ import annotations

from portbench import cell

# NVIDIA's published H100 SXM peaks (dense): device memory rate, fp32
# outside the tensor cores, bf16 and int8 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def bound_ms(nbytes, flops, dtype):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move nbytes once and do flops operations on inputs of dtype."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound_ms(G, S, D, P, dtype, variant="mma"):
    """(bound ms, what binds) of one K1 call: q, kT, v in ``dtype``, the
    fp32 output, parameters and (P, S, S) bias each once, against the
    4*G*S*S*D operations of its two products. Variant "mma" runs the
    products of fp32 inputs too as bf16 on the tensor cores (exact integer
    operands), so its operations are reckoned at the bf16 tensor rate
    whatever the input dtype; "fma" at the rate of its inputs' type."""
    itemsize = 2 if "bfloat16" in str(dtype) else 4
    nbytes = G * S * D * (3 * itemsize + 4) + (7 * G + P * S * S) * 4
    return bound_ms(nbytes, 4 * G * S * S * D,
                    "bfloat16" if variant == "mma" else dtype)


def int8_bound_ms(T, K, O, dtype):
    """K5's bound: x read once, the int8 codes, row scales and bias read
    once, the output written once; 2 T K O integer operations at the int8
    peak."""
    item = 4 if dtype == "float32" else 2
    nbytes = T * K * item + O * K + O * 4 + O * item + 8 + T * O * item
    return bound_ms(nbytes, 2.0 * T * K * O, "int8")


# ---------------------------------------------------------------------------
# Shapes of one forward, from the configuration
# ---------------------------------------------------------------------------

def linear_shapes(arch, batch):
    """[(site kind, T, K, O)] of every Linear of one forward of ``batch``
    images, from the configuration's family module: kinds 'qkv', 'proj',
    'fc1', 'fc2', 'reduction', 'head'."""
    return cell.family_of(arch).linear_shapes(arch, batch)


def attention_calls(arch, batch):
    """[(G, S, D, P)] of the fused attention (K1) calls of one forward,
    from the configuration's family module: G slices of S tokens and head
    width D, P rows of additive logit bias (0: none)."""
    return cell.family_of(arch).attention_calls(arch, batch)


def forward_flops(arch):
    """Operations of one image's forward: 2 T K O for every Linear and the
    patch convolution, 4 S^2 d for each head's two attention products."""
    P, C = arch["patch_size"], arch["in_chans"]
    n = (arch["img_size"] // P) ** 2
    width = arch["embed_dim"]
    total = 2.0 * n * (C * P * P) * width
    total += sum(2.0 * T * K * O for _, T, K, O in linear_shapes(arch, 1))
    total += sum(4.0 * G * S * S * D for G, S, D, _ in
                 attention_calls(arch, 1))
    return total
