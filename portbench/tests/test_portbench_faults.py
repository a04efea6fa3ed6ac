"""The comparison that decides ``correct`` fails the faults a served cell
can have, and its control: each test skips the look for a chip and drives
the rest of a run on a tiny stand-in, with the timed path broken
underneath, and sees ``correct`` come out false. The control, the
reference in float32 with TF32 products put in the program's place, fails
the real limits at this size too (its readings at the cells' own sizes are
taken on the card: test_portbench_control_cuda.py)."""

import pytest
import torch

from portbench import cell as cells, readings, run

SEED = 7


def run_cell(tiny_root, real, wrap=None):
    root, names = tiny_root
    cell = cells.load(names[real], root)
    return run.execute(cell, SEED, 0.3, 0, torch.device("cpu"), wrap=wrap)


@pytest.mark.parametrize("real", ["deit_small_w4a4.serve_b200",
                                  "swin_base_w4a4.serve_b200"])
def test_sound_run_is_correct(tiny_root, cpu_threads, real):
    assert run_cell(tiny_root, real)["correct"] is True


def altered_answer(predict):
    """One image's logits moved by a hundredth of their norm where they
    are produced."""
    def f(x):
        y = predict(x).clone()
        y[1] += 0.01 * y[1].norm() / y.shape[1] ** 0.5
        return y
    return f


def stale_answer(predict):
    """Each call answers with the logits of the call before."""
    last = []

    def f(x):
        y = predict(x)
        out = last[0] if last else y
        last[:] = [y]
        return out
    return f


@pytest.mark.parametrize("fault", [altered_answer, stale_answer])
@pytest.mark.parametrize("real", ["deit_small_w4a4.serve_b200",
                                  "swin_base_w4a4.serve_b200",
                                  "deit_small_w4a4.serve_int8_b200"])
def test_broken_answers_fail(tiny_root, cpu_threads, fault, real):
    assert run_cell(tiny_root, real, wrap=fault)["correct"] is False


def every_group(out):
    return out * 1.001


def last_quarter(out):
    """Only the last quarter of the groups, the images at the batch's end,
    none of them among the images that the Linear sites follow here."""
    out = out.clone()
    out[3 * out.shape[0] // 4:] *= 1.001
    return out


@pytest.mark.parametrize("hit", [every_group, last_quarter])
@pytest.mark.parametrize("real", ["deit_small_w4a4.serve_b200",
                                  "swin_base_w4a4.serve_b200"])
def test_broken_attention_fails(tiny_root, cpu_threads, monkeypatch, hit,
                                real):
    """The fused attention's output off by a thousandth."""
    from adalog_tpu_torch.ops import fq_attn

    plain = fq_attn.fq_flash_attn_plain
    monkeypatch.setattr(fq_attn, "fq_flash_attn_plain",
                        lambda *a, **k: hit(plain(*a, **k)))
    res = run_cell(tiny_root, real)
    assert res["correct"] is False
    assert res["check"]["attention_rel_err_max"]["value"] > \
        res["check"]["attention_rel_err_max"]["limit"]


def test_ties_are_rounding_boundaries():
    """A post-softmax code half a step from a boundary is decided, one a
    hundred-thousandth from it is tied, and so is the last boundary
    before every code gives 0, but not the ones past it."""
    from portbench import reference

    q, r = torch.tensor(16.0), reference.ADALOG_R

    def p(code):        # the probability whose unrounded code is ``code``
        return torch.tensor([2.0 ** (-code * 16.0 / r)], dtype=torch.float64)

    tied = [bool(reference.adalog_ties(p(c), 1.0, q, 4))
            for c in (3.0, 3.5 + 1e-5, 15.5 - 1e-5, 16.5, 20.5)]
    assert tied == [False, True, True, False, False]


def test_bypassed_seam_stops_the_run(tiny_root, cpu_threads, monkeypatch):
    """A forward that calls the fused attention other than through
    ``fq_attn.run_flash`` leaves the check nothing to follow: the run
    stops, naming that function."""
    import types

    from adalog_tpu_torch.models import vit
    from adalog_tpu_torch.ops import fq_attn

    monkeypatch.setattr(vit, "fq_attn", types.SimpleNamespace(
        **{k: getattr(fq_attn, k) for k in dir(fq_attn)
           if not k.startswith("__")}))
    with pytest.raises(RuntimeError, match="fq_attn.run_flash: 0 fused"):
        run_cell(tiny_root, "deit_small_w4a4.serve_b200")


def test_broken_quantizer_fails(tiny_root, cpu_threads, monkeypatch):
    """Every fake-quantized activation off by a ten-thousandth: those of
    the Linear sites, which go through ``fq_act.fq_act_quant`` (K6 on the
    card, ``apply_quantizer`` bound in ``ops.fq_act`` here), and the
    others."""
    from adalog_tpu_torch.models import layers
    from adalog_tpu_torch.ops import fq_act

    apply = layers.apply_quantizer
    for mod in (layers, fq_act):
        monkeypatch.setattr(mod, "apply_quantizer",
                            lambda *a, **k: apply(*a, **k) * 1.0001)
    res = run_cell(tiny_root, "deit_small_w4a4.serve_b200")
    assert res["correct"] is False
    assert res["check"]["site_rel_err_max"]["value"] > \
        res["check"]["site_rel_err_max"]["limit"]


def test_broken_int8_product_fails(tiny_root, cpu_threads, monkeypatch):
    """The int8 product's output off by a ten-thousandth."""
    from adalog_tpu_torch.ops import int8_linear

    qlinear = int8_linear.int8_qlinear
    monkeypatch.setattr(int8_linear, "int8_qlinear",
                        lambda *a, **k: qlinear(*a, **k) * 1.0001)
    res = run_cell(tiny_root, "deit_small_w4a4.serve_int8_b200")
    assert res["correct"] is False


@pytest.mark.parametrize("real", ["deit_small_w4a4.serve_b200",
                                  "swin_base_w4a4.serve_b200"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_the_limits(tiny_root, cpu_threads, real, seed):
    root, names = tiny_root
    cell = cells.load(names[real], root)
    got = readings.read_seed(cell, seed, torch.device("cpu"))
    limits = cell["limits"]
    assert all(got["program"][k] <= v for k, v in limits.items())
    assert any(got["control"][k] > v for k, v in limits.items())
