"""``portbench/spans.py`` on synthetic event lists: each device operation
goes under the innermost span open at the runtime call that launched it,
the
profiler's device-side copies of the spans count neither as device time
nor as busy time, idle splits into the part inside ``serve.predict`` and
the rest, and the readers give per-batch numbers, or nothing where their
span was never entered. One CPU profile of a tiny served model checks the
spans read from real events."""

import contextlib

import pytest
import torch

from portbench import cell as cells, spans

# host: (correlation id, name, start, end, is a span); times in ns
MS = 1_000_000


def _span(name, a, b, cid=0):
    return (cid, name, a * MS, b * MS, True)


def _op(cid, a, b, name="cudaLaunchKernel"):
    """A runtime call: its id is the one the device operation carries."""
    return (cid, name, a * MS, b * MS, False)


def _dev(cid, a, b, name="kernel", note=False):
    return (name, a * MS, b * MS, cid, note)


def one_batch(t0=0):
    """One served batch: predict [0, 100) holding h2d [1, 11) and forward
    [12, 90) with a norm [20, 30) and an activation quantizer [40, 50); the
    logits' copy after predict."""
    host = [_span("serve.predict", t0, t0 + 100, cid=t0 + 50),
            _span("serve.h2d", t0 + 1, t0 + 11, cid=t0 + 51),
            _op(t0 + 1, t0 + 2, t0 + 10, name="cudaMemcpyAsync"),
            _span("serve.forward", t0 + 12, t0 + 90, cid=t0 + 52),
            _span("norm", t0 + 20, t0 + 30, cid=t0 + 53),
            _op(t0 + 2, t0 + 21, t0 + 22),
            _op(t0 + 3, t0 + 31, t0 + 32),          # a residual add
            _span("fq.act.adalog", t0 + 40, t0 + 50, cid=t0 + 54),
            _op(t0 + 4, t0 + 41, t0 + 42),
            _op(t0 + 5, t0 + 101, t0 + 102, name="cudaMemcpyAsync")]
    dev = [_dev(t0 + 1, t0 + 3, t0 + 11, "Memcpy HtoD"),
           _dev(t0 + 2, t0 + 22, t0 + 26),
           _dev(t0 + 3, t0 + 32, t0 + 34),
           _dev(t0 + 4, t0 + 42, t0 + 60),
           _dev(t0 + 5, t0 + 102, t0 + 103, "Memcpy DtoH")]
    return host, dev


def test_kernel_goes_to_innermost_span():
    host, dev = one_batch()
    s = spans.summarize(host, dev, 0.2, 1)
    assert s["span_ms"] == {"serve.h2d": 8.0, "norm": 4.0,
                            "serve.forward": 2.0, "fq.act.adalog": 18.0,
                            spans.NONE: 1.0}
    assert s["outside_ms"] == {"Memcpy DtoH": 1.0}
    assert s["device_ms"] == 33.0
    assert set(s["seen"]) == {"serve.predict", "serve.h2d",
                              "serve.forward", "norm", "fq.act.adalog"}


def test_annotations_count_neither_as_device_nor_busy_time():
    host, dev = one_batch()
    plain = spans.summarize(host, dev, 0.2, 1)
    noted = dev + [_dev(0, 0, 100, "serve.predict", note=True),
                   _dev(0, 20, 30, "norm", note=True),
                   # a copy not flagged but named as a span: still one
                   _dev(0, 40, 50, "fq.act.adalog")]
    s = spans.summarize(host, noted, 0.2, 1)
    assert s["span_ms"] == plain["span_ms"]
    assert s["busy_s"] == plain["busy_s"] == 0.033
    assert s["idle_ms"] == plain["idle_ms"]
    assert s["annotation_ms"] == 120.0


def test_idle_inside_and_outside_predict():
    host, dev = one_batch()
    h2, d2 = one_batch(t0=110)
    s = spans.summarize(host + h2, dev + d2, 0.3, 2)
    # extent [0, 213): busy 33 + 33, idle the rest; inside predict
    # [0, 100) and [110, 210): gaps 0-3, 11-22, 26-32, 34-42, 60-100 each
    assert s["idle_ms"] == pytest.approx(213 - 66)
    assert s["predict_idle_ms"] == pytest.approx(2 * (3 + 11 + 6 + 8 + 40))
    assert spans.per_batch(s, ["serve.h2d"]) == 8.0


def test_forward_rest_and_prefixes():
    host, dev = one_batch()
    s = spans.summarize(host, dev, 0.2, 1)
    assert spans.per_batch(s, ["serve.forward"]) == 2.0
    assert spans.per_batch(s, ["fq.act.uniform", "fq.act.adalog"]) == 18.0
    assert spans.per_batch(s, ["norm", "fq.act.adalog"]) == 22.0
    assert spans.per_batch(s, ["swin.window", "swin.bias"]) is None
    assert spans.per_batch(None, ["norm"]) is None


def test_launch_after_a_span_and_unlinked_ops():
    host = [_span("norm", 0, 10, cid=1), _op(1, 2, 3), _op(2, 10, 11)]
    dev = [_dev(1, 3, 4), _dev(2, 11, 12), _dev(99, 12, 13)]
    s = spans.summarize(host, dev, 0.1, 1)
    assert s["span_ms"] == {"norm": 1.0, spans.NONE: 1.0,
                            "(unlinked)": 1.0}


def test_ids_of_spans_never_stand_for_launches():
    """Span ids and runtime-call ids are separate counters: a device
    operation whose id equals a span's goes by its runtime call."""
    host = [_span("serve.forward", 0, 50, cid=7),
            _span("attn", 5, 20, cid=8), _op(7, 6, 7),
            _span("linear.int8", 25, 30, cid=9), _op(8, 26, 27)]
    dev = [_dev(7, 9, 12, "fq_flash_attn"), _dev(8, 27, 29, "int8_gemm")]
    s = spans.summarize(host, dev, 0.1, 1)
    assert s["span_ms"] == {"attn": 3.0, "linear.int8": 2.0}


def test_run_seed():
    assert spans.run_seed(["--workload", "a.b", "--seed", "2147495993",
                           "--seconds", "30", "--trace", "1"]) == 2147495993
    assert spans.run_seed(["-q", "tests/"]) is None


@pytest.mark.parametrize("name", ["serve.h2d_ms", "serve.actq_ms",
                                  "serve.norm_ms", "serve.window_ms",
                                  "serve.forward_rest_ms",
                                  "serve.predict_idle_ms"])
def test_readers_read_the_summary(monkeypatch, name):
    host, dev = one_batch()
    s = spans.summarize(host, dev, 0.2, 1)
    monkeypatch.setattr(spans, "measure", lambda ctx: s)
    want = {"serve.h2d_ms": 8.0, "serve.actq_ms": 18.0,
            "serve.norm_ms": 4.0, "serve.window_ms": None,
            "serve.forward_rest_ms": 2.0,
            "serve.predict_idle_ms": 3 + 11 + 6 + 8 + 40}[name]
    assert cells.reader(name).read({"trace": {}}) == want


def test_program_without_spans_is_not_measured(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    monkeypatch.setattr("sys.argv", ["run.py", "--seed", "7"])
    assert spans.measure({"trace": {"window_s": 1.0}}) is None


def test_spans_of_a_served_tiny_model():
    """A CPU profile of test_tiny served with the spans on: ``events``
    reads the program's spans (no runtime call or device operation on the
    CPU), and a launch inside a LayerNorm goes to ``norm``; with the spans
    off, it reads nothing."""
    from torch.profiler import ProfilerActivity, profile

    from adalog_tpu_torch.calib.init_state import init_qstate
    from adalog_tpu_torch.models import zoo
    from adalog_tpu_torch.serve import make_predictor
    from adalog_tpu_torch.utils.config import Config

    spec, model = zoo.build_model("test_tiny", seed=0)
    cfg = Config(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)
    predict = make_predictor(spec, model, init_qstate(spec, cfg, model),
                             cfg=cfg, device="cpu")
    x = torch.randn(2, 32, 32, 3)
    for on in (False, True):
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                (spans.program_spans()() if on
                 else contextlib.nullcontext()):
            predict(x)
        host, dev = spans.events(prof)
        assert dev == []
        if not on:
            assert host == []
            continue
        names = [h[1] for h in host]
        assert all(h[4] for h in host)
        assert names.count("serve.predict") == 1 and names.count("norm") == 5
        norm = next(h for h in host if h[1] == "norm")
        mid = (norm[2] + norm[3]) // 2
        launch = (-1, "cudaLaunchKernel", mid, mid + 1, False)
        assert spans.innermost(host + [launch]) == {-1: "norm"}
