"""The EVA-02 family (``portbench/families/eva02.py``) in the benchmark: its
cell, run on the tiny stand-in (the program's test_tiny_eva) on the CPU,
prints the contract and is correct; the faults EVA-02 brings fail
``correct`` (a program that skips RoPE, one that turns the class token
too, one whose gated product is off); the control fails the limits; and
the real configuration's sites, shapes and operations are the model's."""

import io
import json
import math

import pytest
import torch

from portbench import cell as cells, counts, readings, run, state

REAL = "eva02_large_w4a4.serve_int8_b64"
SEED = 2 ** 31 + 777


def execute(tiny_root, trace=0, wrap=None, seed=SEED):
    root, names = tiny_root
    cell = cells.load(names[REAL], root)
    return cell, run.execute(cell, seed, 0.3, trace, torch.device("cpu"),
                             wrap=wrap)


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_prints_the_contract(tiny_root, cpu_threads, trace):
    cell, res = execute(tiny_root, trace)
    out, err = io.StringIO(), io.StringIO()
    run.emit(res, out, err)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    want = [m["name"] for m in (cell["per_layer"] if trace
                                else cell["end_to_end"])]
    if trace:       # the device readers find nothing on the CPU
        assert set(res["metrics"]) <= set(want)
        assert {"serve.host_ms", "serve.mfu_pct"} <= set(res["metrics"])
        assert {"serve.rope_ms", "serve.glu_ms"} <= set(want)
        assert "serve.actq_ms" not in want and "serve.window_ms" not in want
    else:
        assert sorted(want) == ["serve_batch_ms_p95", "serve_img_s",
                                "setup_s"]
        assert sorted(res["metrics"]) == sorted(want)
    for name, c in res["check"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("turn_cls", [False, True],
                         ids=["rope_skipped", "cls_turned"])
def test_rope_faults_fail(tiny_root, cpu_threads, monkeypatch, turn_cls):
    """A forward that skips RoPE, or that turns the class token too, fails
    ``correct``: the attention's inputs are off (patch 0's angles are all
    0, so the class token is turned by patch 1's)."""
    from adalog_tpu_torch.models import eva

    if turn_cls:
        apply = eva.apply_rope

        def faulty(x, rope):
            y = apply(x, rope)
            two = torch.cat([x[..., :1, :]] * 2, -2)
            return torch.cat([apply(two, rope[1:2])[..., 1:, :],
                              y[..., 1:, :]], -2)
    else:
        def faulty(x, rope):
            return x
    monkeypatch.setattr(eva, "apply_rope", faulty)
    _, res = execute(tiny_root)
    assert res["correct"] is False
    assert res["check"]["site_rel_err_max"]["value"] > \
        res["check"]["site_rel_err_max"]["limit"]


def test_broken_gate_fails(tiny_root, cpu_threads, monkeypatch):
    """A gate of x (sigmoid(x) + 1e-3) for SiLU's x sigmoid(x): the gated
    product off by about a thousandth, unevenly (the sub-LN that follows
    would take out an even scale)."""
    from adalog_tpu_torch.models import eva

    silu = eva.F.silu
    monkeypatch.setattr(eva, "F", type("F", (), {
        "silu": staticmethod(lambda x: silu(x) + 1e-3 * x)}))
    _, res = execute(tiny_root)
    assert res["correct"] is False


def test_altered_answer_fails(tiny_root, cpu_threads):
    def wrap(predict):
        def f(x):
            y = predict(x).clone()
            y[1] += 0.01 * y[1].norm() / y.shape[1] ** 0.5
            return y
        return f

    _, res = execute(tiny_root, wrap=wrap)
    assert res["correct"] is False


@pytest.mark.parametrize("seed", [11, 12])
def test_control_fails_the_limits(tiny_root, cpu_threads, seed):
    root, names = tiny_root
    cell = cells.load(names[REAL], root)
    got = readings.read_seed(cell, seed, torch.device("cpu"))
    limits = cell["limits"]
    assert all(got["program"][k] <= v for k, v in limits.items())
    assert any(got["control"][k] > v for k, v in limits.items())


def test_real_configuration():
    """eva02_large_448: 146 sites (the patch convolution, six a block, the
    head), 97 Linear calls a forward (96 of the blocks' and the head), 24
    attentions of 1,025 tokens, 305.1 M parameters, about 0.7235 TFLOP an
    image (619 G in Linears, 103 G in attention products, 1.2 G in the
    patch convolution); fc2 is kind 'glu_fc2', so k5.roofline_pct counts
    it."""
    arch = cells.load(REAL)["arch"]
    sites = state.sites(arch)
    assert len(sites) == 2 + 6 * 24
    assert not any(k == "postgelu" for _, k, _ in sites)
    shapes = counts.linear_shapes(arch, 64)
    assert len(shapes) == 97 and len([s for s in shapes if s[0] != "fc2"]) == 97
    T = 64 * 1025
    assert shapes[:4] == [("qkv", T, 1024, 3072), ("proj", T, 1024, 1024),
                          ("fc1", T, 1024, 5460), ("glu_fc2", T, 2730, 1024)]
    assert counts.attention_calls(arch, 64) == [(1024, 1025, 64, 0)] * 24
    # the program's 305,104,808 less k's bias, which no leaf holds
    assert sum(math.prod(s[1]) for s in state.leaves(arch)) == \
        305_104_808 - 24 * 1024
    lin = 24 * 2 * 1025 * 1024 * (3072 + 1024 + 5460) \
        + 24 * 2 * 1025 * 2730 * 1024 + 2 * 1024 * 1000
    att = 24 * 4 * 16 * 1025 ** 2 * 64
    conv = 2 * 1024 * 588 * 1024
    assert counts.forward_flops(arch) == lin + att + conv
    assert 0.72e12 < lin + att + conv < 0.73e12
