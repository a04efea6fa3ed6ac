"""The port's CLI (adalog_tpu_torch.cli) end to end on the CPU, at test_tiny
size with synthetic data and ``--device cpu``: the cases of tests/test_cli.py
(calibrate -> load -> optimize, the run dir, Swin calibrate, a reference
.pth load), the flags the port refuses, the profiling trace, and one run of
the JAX package's CLI beside the port's on the same weights, configuration,
data and seed: top-1/top-5 equal and the loss within LOSS_RTOL; every
integer pick equal, scales within SCALE_RTOL, but for weight rows where the
two packages' picks tie: FPCS keeps the best-scored candidates, both
packages score in fp32 (the Gram form of the weight search cancels a large
energy down to a small residual), and where two candidates' output errors
lie closer than that noise the packages may keep different ones. Such a row
passes only when the float64 output errors of the two picks agree within
TIE_RTOL, and at most TIE_SHARE of the rows may be such ties (measured: one
row of 618, its two errors 2.1e-4 apart relative, the port's the lower;
the two losses then 1.0e-4 apart, held to TIE_LOSS_RTOL, while the port's
state validated by the JAX package's predictor and metrics gives the
port's loss within LOSS_RTOL).
"""

import argparse
import dataclasses
import glob
import json
import os
import pickle

import numpy as np
import jax
import pytest
import torch

import adalog_tpu.cli as j_cli
import adalog_tpu.data.imagenet as j_data
import adalog_tpu.ops.int8_linear as j_int8
import adalog_tpu.utils.cache as j_cache
import adalog_tpu.utils.metrics as j_metrics
import adalog_tpu_torch
import adalog_tpu_torch.data.imagenet as p_data
import adalog_tpu_torch.utils.metrics as p_metrics
from adalog_tpu_torch import cli
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.models.zoo import model_forward_fn
from adalog_tpu_torch.ops import int8_linear
from adalog_tpu_torch.serve import make_predictor
from adalog_tpu_torch.utils import profiling
from adalog_tpu_torch.utils.config import load_config
from adalog_tpu_torch.utils.ref_checkpoint import export_reference_state_dict
from test_cli import _write_tiny_config

torch.set_num_threads(2)

SCALE_RTOL = 1e-5
LOSS_RTOL = 1e-5
TIE_RTOL = 1e-3
TIE_SHARE = 0.01
TIE_LOSS_RTOL = 1e-3


def _small_synthetic(monkeypatch, module, n_val=16):
    """A synthetic val set of ``n_val`` images and 10 classes (test_tiny's),
    so losses are finite."""
    def init(self, spec, *args, **kwargs):
        self.spec, self.val_batch_size = spec, 8
        self.n_val, self.num_classes, self.seed = n_val, 10, 0

    monkeypatch.setattr(module.SyntheticLoader, "__init__", init)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    _small_synthetic(monkeypatch, p_data)
    config = str(tmp_path / "tiny_cfg.py")
    _write_tiny_config(config)
    return str(tmp_path), config


def _args(tmp_path, config, parser=cli.get_args_parser, **overrides):
    args = argparse.ArgumentParser(parents=[parser()]).parse_args([])
    args.model = "test_tiny"
    args.config = config
    args.synthetic_data = True
    args.val_batch_size = 8
    args.output_dir = os.path.join(tmp_path, "out")
    if parser is cli.get_args_parser:
        args.device = "cpu"
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def _record_validate(monkeypatch, module):
    """Record every (loss, top1, top5) ``validate`` of ``module`` returns."""
    seen, real = [], module.validate

    def validate(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(module, "validate", validate)
    return seen


def _logits(spec, model, qstate, x):
    with torch.no_grad():
        return model_forward_fn(spec)(spec.cfg, model, torch.from_numpy(x),
                                      qstate, {"*": "quant"})


def test_cli_calibrate_then_load_then_optimize(tiny, monkeypatch):
    tmp_path, config = tiny
    seen = _record_validate(monkeypatch, p_metrics)
    params, qstate = cli.main(_args(tmp_path, config, calibrate=True))
    assert qstate and len(seen) == 1
    assert all(p.device.type == "cpu" for p in params.parameters())
    ckpts = glob.glob(os.path.join(tmp_path, "out", "*", "*.ckpt"))
    assert len(ckpts) == 1 and "test_tiny_w6_a6_s6_calibsize_8" in ckpts[0]
    log_text = open(os.path.join(os.path.dirname(ckpts[0]),
                                 "output.log")).read()
    assert "calibration finished" in log_text and " * Prec@1" in log_text

    params2, qstate2 = cli.main(_args(
        tmp_path, config, load_calibrate_checkpoint=ckpts[0],
        test_calibrate_checkpoint=True,
        output_dir=os.path.join(tmp_path, "load")))
    assert set(qstate2) == set(qstate) and len(seen) == 2
    assert seen[1] == seen[0]          # the loaded state validates the same

    params3, qstate3 = cli.main(_args(
        tmp_path, config, load_calibrate_checkpoint=ckpts[0], optimize=True,
        output_dir=os.path.join(tmp_path, "opt")))
    opt = glob.glob(os.path.join(tmp_path, "opt", "*", "*optimsize*.ckpt"))
    assert len(opt) == 1 and "test_tiny_w6_a6_s6_optimsize_8" in opt[0]
    assert len(seen) == 4              # calibration set, then val
    assert all(np.isfinite(v).all() for v in seen)


def test_cli_calibrate_and_optimize_in_one_run(tiny):
    tmp_path, config = tiny
    params, qstate = cli.main(_args(tmp_path, config, calibrate=True,
                                    optimize=True, mesh_devices=-1))
    names = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(tmp_path, "out", "*", "*.ckpt")))
    assert names == ["test_tiny_w6_a6_s6_calibsize_8.ckpt",
                     "test_tiny_w6_a6_s6_optimsize_8.ckpt"]
    assert all(bool(s.aq.bias_reparamed) for n, s in qstate.items()
               if n.endswith("mlp.fc2"))


def test_run_dir_creation(tmp_path):
    d = cli.make_run_dir(str(tmp_path))
    assert os.path.isdir(d) and os.path.dirname(d) == str(tmp_path)


def test_cli_swin_calibrate(tiny):
    tmp_path, config = tiny
    params, qstate = cli.main(_args(tmp_path, config, calibrate=True,
                                    model="test_tiny_swin"))
    assert "layers.1.downsample.reduction" in qstate


@pytest.mark.parametrize("fmt", ["pth", "round1"])
def test_cli_loads_other_checkpoint_formats(tiny, monkeypatch, fmt):
    """--load-calibrate-checkpoint of a reference state dict (.pth, written
    as the JAX package's test writes it) or of a round-1 pickle of the JAX
    package's dataclasses: the loaded model reproduces the exporter's
    quantized forward."""
    tmp_path, config = tiny
    params, qstate = cli.main(_args(tmp_path, config, calibrate=True))
    spec = zoo.model_spec("test_tiny")
    if fmt == "pth":
        sd = export_reference_state_dict(spec, load_config(config), params,
                                         qstate)
        path = os.path.join(tmp_path, "ref.pth")
        torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()},
                   path)
    else:
        from adalog_tpu.utils.checkpoint import load_checkpoint as j_load
        from adalog_tpu_torch.utils.checkpoint import save_checkpoint
        v2 = os.path.join(tmp_path, "v2.ckpt")
        save_checkpoint(v2, params, qstate)
        jp, jq, _ = j_load(v2)
        path = os.path.join(tmp_path, "round1.ckpt")
        with open(path, "wb") as f:
            pickle.dump(jax.tree_util.tree_map(
                np.asarray, {"params": jp, "qstate": jq, "meta": {}}), f)
    seen = _record_validate(monkeypatch, p_metrics)
    params2, qstate2 = cli.main(_args(
        tmp_path, config, load_calibrate_checkpoint=path,
        test_calibrate_checkpoint=True,
        output_dir=os.path.join(tmp_path, "load")))
    assert sorted(qstate2) == sorted(qstate) and len(seen) == 1
    x = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    torch.testing.assert_close(_logits(spec, params2, qstate2, x),
                               _logits(spec, params, qstate, x),
                               rtol=2e-5, atol=2e-5)


def test_cli_matches_jax_cli(tmp_path, monkeypatch):
    """The JAX package's CLI and the port's on the same timm-keyed weights
    (--checkpoint-path), tiny configuration, synthetic data and seed."""
    tmp_path = str(tmp_path)
    config = os.path.join(tmp_path, "tiny_cfg.py")
    _write_tiny_config(config)
    weights = os.path.join(tmp_path, "test_tiny.npz")
    np.savez(weights, **{k: v.numpy() for k, v in zoo.build_model(
        "test_tiny", seed=7)[1].state_dict().items()})
    for module in (p_data, j_data):
        _small_synthetic(monkeypatch, module)
    monkeypatch.setattr(j_cache, "enable_compilation_cache", lambda: None)
    p_seen = _record_validate(monkeypatch, p_metrics)
    j_seen = _record_validate(monkeypatch, j_metrics)

    common = dict(calibrate=True, checkpoint_path=weights, seed=3)
    pp, qp = cli.main(_args(tmp_path, config, **common,
                            output_dir=os.path.join(tmp_path, "p")))
    _, qj = j_cli.main(_args(tmp_path, config, parser=j_cli.get_args_parser,
                             **common, output_dir=os.path.join(tmp_path, "j")))
    qj = jax.tree_util.tree_map(np.asarray, qj)

    assert sorted(qp) == sorted(qj)
    picks, rows, ties = 0, 0, []
    for name in qj:
        got_site = dict(_fields(qp[name]))
        tied = _tied_weight_rows(got_site, dict(_fields(qj[name])))
        rows += got_site["wq.scale"].numel() if "wq.scale" in got_site else 0
        ties += [(name, r) for r in tied]
        for path, want in _fields(qj[name]):
            got = got_site[path]
            if want is None or isinstance(want, (str, bool, int, float)):
                assert got == want, (name, path)
                continue
            got = got.numpy().copy()
            if path in ("wq.scale", "wq.zero_point"):
                for r in tied:        # checked below, by their errors
                    got.reshape(-1)[r] = want.reshape(-1)[r]
            if path.split(".")[-1] in ("zero_point", "log_q") or \
                    got.dtype == bool:
                np.testing.assert_array_equal(got, want, err_msg=name)
                picks += got.size
            else:
                np.testing.assert_allclose(got, want, rtol=SCALE_RTOL,
                                           atol=0, err_msg=f"{name}.{path}")
    assert picks > 0 and len(ties) <= TIE_SHARE * rows, ties
    spec = zoo.model_spec("test_tiny")
    x = p_data.SyntheticLoader(spec).calib_batches(8, 8, seed=3)[0]
    for name, r in ties:
        err_p, err_j = (_row_out_error(spec, pp, qp[name], name, r, x, q)
                        for q in (qp[name].wq, j_wq(qj[name].wq)))
        print(f"tied weight row {name}[{r}]: float64 output errors, port's "
              f"pick {err_p:.6e}, JAX's {err_j:.6e}")
        assert abs(err_p - err_j) <= TIE_RTOL * min(err_p, err_j), \
            (name, r, err_p, err_j)
    (lp, t1p, t5p), = p_seen
    (lj, t1j, t5j), = j_seen
    assert (t1p, t5p) == (t1j, t5j)
    # a tied row makes the two quantized models differ a little: the loss
    # then moves by TIE_LOSS_RTOL at most; the port's own state validated by
    # the JAX package's predictor and metrics gives the port's loss
    np.testing.assert_allclose(lp, lj, rtol=TIE_LOSS_RTOL if ties
                               else LOSS_RTOL)
    from adalog_tpu.models.zoo import model_spec as j_model_spec
    from adalog_tpu.serve import make_predictor as j_make_predictor
    from adalog_tpu.utils.checkpoint import load_checkpoint as j_load
    from adalog_tpu.utils.config import load_config as j_load_config
    jspec = j_model_spec("test_tiny")
    jp2, jq2, _ = j_load(glob.glob(os.path.join(tmp_path, "p", "*",
                                                "*.ckpt"))[0])
    j_metrics.validate(j_data.SyntheticLoader(jspec, 8).val_loader(),
                       j_make_predictor(jspec, jp2, jq2,
                                        cfg=j_load_config(config)), 10)
    lj2, t1j2, t5j2 = j_seen[-1]
    assert (t1j2, t5j2) == (t1p, t5p)
    np.testing.assert_allclose(lp, lj2, rtol=LOSS_RTOL)


def j_wq(wq):
    """A JAX weight quantizer state (numpy leaves) as the port's."""
    from adalog_tpu_torch.quantizers.state import WeightQuantizerState
    return WeightQuantizerState(
        scale=torch.from_numpy(np.asarray(wq.scale)),
        zero_point=torch.from_numpy(np.asarray(wq.zero_point)),
        bits=wq.bits, symmetric=wq.symmetric)


def _tied_weight_rows(got, want):
    """Flat indices of the weight rows whose picks differ between the two
    packages (zero point, or scale past SCALE_RTOL)."""
    if "wq.zero_point" not in got or want["wq.zero_point"] is None:
        return []
    zp_p, zp_j = got["wq.zero_point"].numpy(), want["wq.zero_point"]
    s_p, s_j = got["wq.scale"].numpy(), want["wq.scale"]
    off = (zp_p != zp_j) | (np.abs(s_p - s_j) > SCALE_RTOL * np.abs(s_j))
    return [int(i) for i in np.flatnonzero(off)]


def _row_out_error(spec, params, site, name, row, x, wq):
    """Float64 mean squared error of one output row of Linear site ``name``
    with weight quantizer ``wq``, on the site's input captured in
    ``params`` from the images ``x`` and quantized by the site's own
    activation quantizer (the error the weight search minimizes)."""
    from adalog_tpu_torch.calib.calibrator import capture_all_sites
    from adalog_tpu_torch.calib.layout import quant_layout, tree_get
    from adalog_tpu_torch.quantizers.apply import apply_quantizer
    from adalog_tpu_torch.utils.config import Config

    xin, y = capture_all_sites(spec, params, [x], names=[name])[name]
    lin = tree_get(params, quant_layout(spec, Config())[name].param_path)
    with torch.no_grad():
        xq = apply_quantizer(site.aq, xin).double()
        w = lin.weight.double().reshape(site.n_V, -1, lin.weight.shape[1])
        N = 2 ** (wq.bits - 1)
        s, z = wq.scale.double(), wq.zero_point.double()
        wq_v = (torch.clamp(torch.round(w / s) + z, 0, 2 * N - 1) - z) * s
        wrow = wq_v.reshape(-1, w.shape[-1])[row]
        tgt = (y.double() - lin.bias.double())[..., row]
        return float(((xq @ wrow - tgt) ** 2).mean())


def _fields(site, prefix=""):
    for f in dataclasses.fields(site):
        v = getattr(site, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def test_cli_needs_a_card_unless_asked_for_the_cpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp_path, config = tiny
    args = _args(tmp_path, config, calibrate=True, device="cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(args)
    assert not os.path.exists(os.path.join(tmp_path, "out"))
    defaults = argparse.ArgumentParser(
        parents=[cli.get_args_parser()]).parse_args([])
    assert defaults.device == "cuda"


def test_make_predictor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec, model = zoo.build_model("test_tiny", seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_predictor(spec, model, {})


@pytest.mark.parametrize("flags", [dict(mesh_devices=2), dict(mesh_tp=2),
                                   dict(mesh_devices=1, mesh_tp=4)])
def test_cli_multi_device_not_ported(tiny, flags):
    """Mesh flags that cannot form a mesh exit before the run starts, as the
    JAX package's CLI does: two ranks asked for outside a process group of
    two, --mesh-tp without --mesh-devices, and a tp that does not divide
    (the mesh itself runs in tests/test_torch_parallel.py)."""
    tmp_path, config = tiny
    with pytest.raises(SystemExit):
        cli.main(_args(tmp_path, config, calibrate=True, **flags))
    assert not os.path.exists(os.path.join(tmp_path, "out"))


def test_cli_int8_not_ported(tiny, monkeypatch):
    """A config with eval_int8: the port's CLI validates every supported
    Linear site as an integer product (int8_gemm), and a loaded checkpoint
    validates as the JAX package's CLI does with its int8 switch: top-1 and
    top-5 equal, the loss within LOSS_RTOL. The JAX switch is process-global
    (its later forwards all run int8), so the JAX run only loads."""
    tmp_path, config = tiny
    with open(config, "a") as f:
        f.write("        self.eval_int8 = True\n")
    _small_synthetic(monkeypatch, j_data)
    monkeypatch.setattr(j_cache, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(j_int8, "_ENABLED", False)   # restored afterwards
    p_seen = _record_validate(monkeypatch, p_metrics)
    j_seen = _record_validate(monkeypatch, j_metrics)
    calls = int8_linear.int8_gemm.calls
    cli.main(_args(tmp_path, config, calibrate=True,
                   output_dir=os.path.join(tmp_path, "p")))
    # test_tiny: qkv, proj and fc1 of both blocks and the head (fc2 is an
    # AdaLog site), on 2 validation batches
    assert int8_linear.int8_gemm.calls - calls == 7 * 2
    ckpt, = glob.glob(os.path.join(tmp_path, "p", "*", "*.ckpt"))
    load = dict(load_calibrate_checkpoint=ckpt, test_calibrate_checkpoint=True)
    cli.main(_args(tmp_path, config, **load,
                   output_dir=os.path.join(tmp_path, "p2")))
    j_cli.main(_args(tmp_path, config, parser=j_cli.get_args_parser, **load,
                     output_dir=os.path.join(tmp_path, "j")))
    assert j_int8.enabled()
    (lp, t1p, t5p), (lj, t1j, t5j) = p_seen[-1], j_seen[-1]
    assert (t1p, t5p) == (t1j, t5j)
    np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL)


@pytest.mark.parametrize("flags", [
    ["--calibrate", "--load-calibrate-checkpoint", "x.ckpt"],
    ["--optimize", "--load-optimize-checkpoint", "x.ckpt"]])
def test_cli_exclusive_groups(flags):
    parser = argparse.ArgumentParser(parents=[cli.get_args_parser()])
    with pytest.raises(SystemExit):
        parser.parse_args(flags)


def test_cli_profile_writes_a_trace(tiny):
    tmp_path, config = tiny
    cli.main(_args(tmp_path, config, calibrate=True, profile=True))
    trace, = glob.glob(os.path.join(tmp_path, "out", "*", "trace",
                                    "trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert len(events) > 100


def test_run_is_the_module_entry_point(tiny, monkeypatch):
    tmp_path, config = tiny
    monkeypatch.setattr("sys.argv", [
        "adalog_tpu_torch.cli", "--model", "test_tiny", "--config", config,
        "--calibrate", "--synthetic-data", "--device", "cpu",
        "--calib-size", "4", "--calib-batch-size", "4", "--w_bit", "4",
        "--output-dir", os.path.join(tmp_path, "out")])
    cli.run()
    ckpt, = glob.glob(os.path.join(tmp_path, "out", "*", "*.ckpt"))
    assert os.path.basename(ckpt) == "test_tiny_w4_a6_s6_calibsize_4.ckpt"


def test_phase_timer_and_annotate(tmp_path):
    """The span API that replaced the phase timer and ``annotate``: a span
    is named in a trace only while ``spans`` is on, and ``device_trace``
    turns them on for its extent."""
    assert profiling.span("norm") is profiling.span("linear")   # no-op
    with torch.profiler.profile() as prof:
        with profiling.span("norm"):
            torch.ones(4).sum()
        with profiling.spans(), profiling.span("linear"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "linear" in names and "norm" not in names
    with profiling.device_trace(str(tmp_path / "t")):
        with profiling.span("norm"):
            torch.ones(8).cumsum(0)
    assert profiling.span("norm") is profiling.span("gelu")    # off again
    with open(tmp_path / "t" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "norm" in names


def test_cli_profile_trace_holds_the_spans(tiny):
    """``--profile`` turns the forward's spans on: the calibration's trace
    names its LayerNorms and Linear products."""
    tmp_path, config = tiny
    cli.main(_args(tmp_path, config, calibrate=True, profile=True))
    trace, = glob.glob(os.path.join(tmp_path, "out", "*", "trace",
                                    "trace.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"norm", "linear", "gelu", "attn"} <= names


def test_lazy_api_names():
    from adalog_tpu_torch.calib.calibrator import QuantCalibrator
    from adalog_tpu_torch.recon.brecq import BlockReconstructor
    from adalog_tpu_torch.serve import load_quantized
    assert adalog_tpu_torch.QuantCalibrator is QuantCalibrator
    assert adalog_tpu_torch.BlockReconstructor is BlockReconstructor
    assert adalog_tpu_torch.build_model is zoo.build_model
    assert adalog_tpu_torch.model_forward_fn is zoo.model_forward_fn
    assert adalog_tpu_torch.load_quantized is load_quantized
    assert adalog_tpu_torch.make_predictor is make_predictor
    with pytest.raises(AttributeError):
        adalog_tpu_torch.no_such_name
