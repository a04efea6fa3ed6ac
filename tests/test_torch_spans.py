"""The port's spans (``adalog_tpu_torch/utils/profiling.py``) in a served
forward, on the CPU at test_tiny, test_tiny_swin and test_tiny_eva size:
with the spans
off a profiled batch names none of them; with them on each is named as
often as the model's blocks open it, the image copy and the forward
inside ``serve.predict``; logits are bitwise the same either way; and
``spans`` restores the previous state, on an exception too."""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adalog_tpu_torch.calib.init_state import init_qstate
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.serve import make_predictor
from adalog_tpu_torch.utils import profiling
from adalog_tpu_torch.utils.config import Config

W4A4 = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)

# (blocks, patch merges) of the fixtures: test_tiny depth 2; test_tiny_swin
# depths (1, 2), one merge; test_tiny_eva depth 2
SHAPE = {"test_tiny": (2, 0), "test_tiny_swin": (3, 1), "test_tiny_eva": (2, 0)}


def expected(name, int8):
    """{span: count} of one served batch. A block opens norm twice, attn
    and gelu once and four Linear sites (qkv, proj, fc1 uniform, fc2
    AdaLog); a Swin block adds its two window spans and the rel-pos bias;
    a merge opens a window span, a norm and one uniform Linear site. Then
    the patch convolution (weight quantized at call time, activations at 8
    bits pass through), its norm in Swin, the last norm and the head.
    An EVA-02 block opens norm three times (the sub-LN), eva.rope inside
    attn and eva.glu once, no gelu, and four uniform Linear sites; the
    forward opens eva.rope once more for its tables."""
    blocks, merges = SHAPE[name]
    if name.endswith("eva"):
        uniform = 4 * blocks + 1
        want = {"serve.predict": 1, "serve.h2d": 1, "serve.forward": 1,
                "conv": 1, "fq.weight": 1, "attn": blocks,
                "norm": 3 * blocks + 1, "eva.rope": blocks + 1,
                "eva.glu": blocks}
        want.update({"linear.int8": uniform} if int8 else
                    {"fq.act.uniform": uniform, "linear": uniform})
        return want
    swin = name.endswith("swin")
    uniform = 3 * blocks + merges + 1
    want = {"serve.predict": 1, "serve.h2d": 1, "serve.forward": 1,
            "conv": 1, "fq.weight": 1, "attn": blocks, "gelu": blocks,
            "norm": 2 * blocks + merges + 1 + swin,
            "fq.act.adalog": blocks, "linear": blocks}
    if int8:
        want["linear.int8"] = uniform
    else:
        want["fq.act.uniform"] = uniform
        want["linear"] += uniform
    if swin:
        want["swin.window"] = 2 * blocks + merges
        want["swin.bias"] = blocks
    return want


@pytest.fixture(scope="module",
                params=["test_tiny", "test_tiny_swin", "test_tiny_eva"])
def served(request):
    torch.manual_seed(0)
    spec, model = zoo.build_model(request.param, seed=0)
    cfg = Config(**W4A4)
    qstate = init_qstate(spec, cfg, model)
    x = torch.randn(3, spec.cfg.img_size, spec.cfg.img_size, 3)
    return request.param, spec, model, qstate, cfg, x


def traced(predict, x, on):
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            (profiling.spans() if on else contextlib.nullcontext()):
        y = predict(x)
    return y, [e for e in prof.events() if e.is_user_annotation]


def test_spans_off_name_nothing(served):
    _, spec, model, qstate, cfg, x = served
    predict = make_predictor(spec, model, qstate, cfg=cfg, device="cpu")
    _, names = traced(predict, x, False)
    assert names == []


@pytest.mark.parametrize("int8", [False, True])
def test_spans_on_name_each_layer(served, int8):
    name, spec, model, qstate, cfg, x = served
    predict = make_predictor(spec, model, qstate, cfg=cfg, device="cpu",
                             use_int8=int8)
    _, events = traced(predict, x, True)
    assert dict(collections.Counter(e.name for e in events)) == \
        expected(name, int8)
    for e in events:
        if e.name in ("serve.h2d", "serve.forward"):
            assert e.cpu_parent.name == "serve.predict"
        if e.name == "swin.bias":
            assert e.cpu_parent.name == "attn"
        if e.name == "eva.rope" and e.cpu_parent.name != "serve.forward":
            assert e.cpu_parent.name == "attn"


@pytest.mark.parametrize("int8", [False, True])
def test_logits_bitwise_equal_with_spans(served, int8):
    _, spec, model, qstate, cfg, x = served
    predict = make_predictor(spec, model, qstate, cfg=cfg, device="cpu",
                             use_int8=int8)
    off, _ = traced(predict, x, False)
    on, _ = traced(predict, x, True)
    assert torch.equal(off, on)
    assert torch.equal(predict(x), on)


def test_spans_restore_the_previous_state():
    off = profiling.span("norm")
    with profiling.spans():
        assert profiling.span("norm") is not off
        with profiling.spans():
            assert profiling.span("norm") is not off
        assert profiling.span("norm") is not off
    assert profiling.span("norm") is off
    with pytest.raises(ValueError):
        with profiling.spans():
            raise ValueError("inside")
    assert profiling.span("norm") is off
