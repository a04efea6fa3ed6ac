"""The port's calibration and reconstruction over a mesh (mesh= of
calib/calibrator.py, recon/brecq.py and cli.py; the dp helpers of
parallel/mesh.py) against adalog_tpu on the CPU, at test_tiny and
test_tiny_swin size.

The ranks run in gloo process groups on the CPU, spawned with
``parallel.mesh.spawn`` once per world size (2 and 4) for the whole
module: their entry points (tests/torch_calib_mesh_ranks.py) import no jax.
The JAX side runs in this process on the 8 virtual CPU devices
(tests/conftest.py), its searches and calibrations over
``adalog_tpu.parallel.mesh.make_mesh``; the two meet in .npz and .ckpt
files. Both packages start from the JAX package's weights.

Gates:
  - the sharded quantiles and positive percentiles equal the single-device
    ones bit for bit (the bits of the floats, so a -0.0 for a +0.0 fails);
  - a rank's taps equal those of the same forward on its slice bit for bit,
    and its rows of the whole batch's to 2e-5 (tests/test_sharding.py's):
    the CPU's GEMM picks its kernel by the row count, so a forward over a
    slice and the same rows of a whole-batch forward can differ in their
    last bits (measured: test_tiny's head at one row);
  - the search families at dp=2 to JAX's token-sharded search on
    make_mesh(8) and to the single-device port at JAX's own tolerance
    (rtol 1e-4, atol 1e-5, test_sharding.py);
  - whole calibrations: the ranks bit-equal; at most max(2, total // 20)
    quantizer fields past that tolerance against JAX's mesh calibration
    and against the single-device port (tests/test_mesh_cli.py); JAX
    calibrates each model over one mesh (JAX_DP: test_tiny over 2 devices,
    test_tiny_swin over 4), which both of the port's dp hold to, since
    JAX's mesh result does not depend on dp beyond the order of its float
    sums; the
    quantized logits' error to the raw model within 1.05x of the single-
    device run's (test_sharding.py);
  - BRECQ at dp=2: the first step's gradients within GRAD_RTOL of the
    largest element of the single-device step's on the same draw, but an
    activation scale's: a sum of STE rounding residues that cancels to a
    small part of its terms, held to tests/test_torch_recon.py's
    SCALE_GRAD_RTOL (measured up to 7e-5 here);
    after 20
    steps the alphas within ALPHA_ATOL and no hard decision flipped against
    the single-device port and against JAX's mesh reconstruction (measured
    2.4e-7 and 1.4e-6).
"""

import argparse
import glob
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adalog_tpu.calib import search as JS
from adalog_tpu.calib.calibrator import QuantCalibrator as JQuantCalibrator
from adalog_tpu.calib.layout import quant_layout as j_quant_layout
from adalog_tpu.models import zoo as j_zoo
from adalog_tpu.parallel.mesh import make_mesh as j_make_mesh
from adalog_tpu.parallel.mesh import shard_axis as j_shard_axis
from adalog_tpu.quantizers.state import GELU_MIN
from adalog_tpu.recon import brecq as J
from adalog_tpu.utils.checkpoint import load_checkpoint as j_load
from adalog_tpu.utils.config import Config as JConfig
import adalog_tpu_torch.data.imagenet as p_data
from adalog_tpu_torch import cli
from adalog_tpu_torch.calib import calibrator as C
from adalog_tpu_torch.calib import search as TS
from adalog_tpu_torch.calib.candidates import positive_percentile, quantile
from adalog_tpu_torch.calib.layout import quant_layout
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.parallel import mesh as M
from adalog_tpu_torch.recon import brecq as B
from adalog_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.interop import from_jax
from test_cli import _write_tiny_config
import torch_calib_mesh_ranks as ranks
import torch_parallel_ranks

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
CAPTURE_TOL = 2e-5
SPAWN_TIMEOUT = 600
SMALL = ranks.SMALL
MODELS = {"tiny": "test_tiny", "swin": "test_tiny_swin"}
# the mesh of JAX's calibration of each model, which every case holds to
JAX_DP = {"tiny": 2, "swin": 4}
GRAD_RTOL = 1e-6
SCALE_GRAD_RTOL = 2e-3
ALPHA_ATOL = 1e-5
REC_RTOL = 1e-4
KL_ATOL = 1e-6
N_VAL = 8


def _images(seed, n=8):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

# (name, kind, shard dim, quantile dim): every one at dp 2 and 3
ORDER_CASES = [("ties", "quantile", 0, None),
               ("signed_zeros", "quantile", 0, None),
               ("signed_zeros_pos", "positive", 0, None),
               ("no_positive_shard", "positive", 0, None),
               ("none_positive", "positive", 0, None),
               ("two", "quantile", 0, None),
               ("two_pos", "positive", 0, None),
               ("columns", "quantile", 0, 0),
               ("heads", "quantile", 1, -1)]


def _order_inputs():
    rng = np.random.default_rng(3)
    zeros = np.array([0.0, -0.0, 1.5, -2.0, 0.0, -0.0], np.float32)
    columns = rng.standard_normal((37, 6)).astype(np.float32)
    columns[::4, 2] = columns[1, 2]                     # ties in a column
    columns[:20, 4] = -0.0                              # and signed zeros
    columns[20:, 4] = 0.0
    return {
        # 101 values: shards of 51 / 50 and 34 / 34 / 33
        "ties": rng.integers(-3, 4, 101).astype(np.float32),
        "signed_zeros": rng.choice(zeros, 64),
        "signed_zeros_pos": rng.choice(zeros, 65),
        # the first shard at dp 2 and 3 holds no positive value
        "no_positive_shard": np.concatenate([
            -np.abs(rng.standard_normal(40)),
            np.abs(rng.standard_normal(21))]).astype(np.float32),
        "none_positive": -np.abs(rng.standard_normal(30)).astype(np.float32),
        # two values: at dp 3 the last rank's slice is empty
        "two": np.array([0.5, -0.25], np.float32),
        "two_pos": np.array([-0.5, 0.25], np.float32),
        "columns": columns,
        "heads": rng.standard_normal((3, 29)).astype(np.float32),
    }


def _taps(model, x):
    return C.capture_all_sites(zoo.model_spec("test_tiny"), model, [x])


# (case, fn, tap keys, image axis of each, kwargs); batched forms stack
# blocks 0 and 1 on a leading site axis
_LIN = dict(w_bits=4, a_bits=4, n_V=1, **ranks.FAMILY_KW, _tokens=True)
_MM = dict(A_bits=4, B_bits=4, **ranks.FAMILY_KW, head_cw=True)
FAMILIES = [
    ("linear", "search_linear_default", ("proj.x", "proj.y", "proj.w",
                                         "proj.b"), (0, 0, None, None),
     dict(_LIN)),
    ("linear_gram", "search_linear_default",
     ("fc1.x", "fc1.y", "fc1.w", "fc1.b"), (0, 0, None, None),
     dict(_LIN, gram=True, a_gram=True)),
    ("act_channelwise", "search_act_channelwise", ("fc1.x",), (0,),
     dict(a_bits=4, eq_n=32, steps=3, use_fpcs=True, _tokens=True)),
    ("postgelu", "search_linear_postgelu_adalog",
     ("fc2.x", "fc2.y", "fc2.w", "fc2.b", "shift"),
     (0, 0, None, None, None), dict(_LIN, eq_n=64, gram=True)),
    ("twin", "search_linear_postgelu_twin",
     ("fc2.x", "fc2.y", "fc2.w", "fc2.b"), (0, 0, None, None), dict(_LIN)),
    ("matmul", "search_matmul", ("mm1.A", "mm1.B", "mm1.y"), (0, 0, 0),
     dict(_MM)),
    ("matmul_gram", "search_matmul", ("mm1.A", "mm1.B", "mm1.y"), (0, 0, 0),
     dict(_MM, gram=True, head_cw=False)),
    ("postsoftmax", "search_matmul_postsoftmax",
     ("mm2.A", "mm2.B", "mm2.y"), (0, 0, 0), dict(_MM, a_kind="adalog")),
    ("conv", "search_conv", ("conv.x", "conv.y", "conv.w", "conv.b"),
     (0, 0, None, None),
     dict(w_bits=4, eq_n=32, steps=3, use_fpcs=True,
          conv_dims=(8, 8, 8, 0))),
]
BATCHED = [("linear", ("proj",)), ("act_channelwise", ("fc1",)),
           ("postgelu", ("fc2",)), ("twin", ("fc2",)), ("matmul", ("mm1",)),
           ("postsoftmax", ("mm2",))]


def _family_cases():
    out = list(FAMILIES)
    by_name = {c[0]: c for c in FAMILIES}
    for name, _ in BATCHED:
        _, fn, keys, axes, kw = by_name[name]
        out.append((name + "_batched", fn + "_batched",
                    tuple(k if k == "shift" else "L" + k for k in keys),
                    tuple(None if a is None else a + 1 for a in axes), kw))
    return out


FAMILY_CASES = _family_cases()
SITE = {"proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
        "mm1": "attn.matmul1", "mm2": "attn.matmul2"}


def _family_inputs(model, x):
    """The tensors the family cases name, from test_tiny's taps of x."""
    taps = _taps(model, x)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    out = {"shift": np.float32(GELU_MIN)}
    for short, site in SITE.items():
        for blk in (0, 1):
            tup = taps[f"blocks.{blk}.{site}"]
            vals = {"x": tup[0], "y": tup[-1]} if short[:2] != "mm" else \
                {"A": tup[0], "B": tup[1], "y": tup[2]}
            if short[:2] != "mm":
                vals["w"] = sd[f"blocks.{blk}.{site}.weight"]
                vals["b"] = sd[f"blocks.{blk}.{site}.bias"]
            for k, v in vals.items():
                v = np.asarray(v)
                if blk == 0:
                    out[f"{short}.{k}"] = v
                out.setdefault(f"L{short}.{k}", []).append(v)
    for k in [k for k in out if k.startswith("L")]:
        out[k] = np.stack(out[k])
    conv = taps["patch_embed.proj"]
    out["conv.x"], out["conv.y"] = (t.numpy() for t in conv)
    out["conv.w"] = sd["patch_embed.proj.weight"]
    out["conv.b"] = sd["patch_embed.proj.bias"]
    return out


def _family_args(inputs, keys, axes, tokens, to):
    """The case's whole inputs (tokens flattened), through ``to``."""
    args = []
    for k, ax in zip(keys, axes):
        a = inputs[k]
        if k == "shift":
            args.append(float(a) if to is torch.from_numpy else a)
            continue
        a = np.asarray(a)
        if tokens and ax is not None:
            a = a.reshape(a.shape[:ax] + (-1, a.shape[-1]))
        args.append(to(a))
    return args


# ---------------------------------------------------------------------------
# the ranks, once per world size; the JAX side meanwhile
# ---------------------------------------------------------------------------

CAL_RUNS = [(f"{m}_g{g}", name, {"batch_sites": bool(g)})
            for m, name in MODELS.items() for g in (1, 0)]


def _cli_argv(config, out, *flags):
    return ["--model", "test_tiny", "--config", config, "--synthetic-data",
            "--device", "cpu", "--val-batch-size", "4", "--output-dir", out,
            *flags]


CLI_RUNS = {"calibrate_dp2": (2, ("--calibrate", "--mesh-devices", "2")),
            "optimize_dp2": (2, ("--calibrate", "--optimize",
                                 "--mesh-devices", "2")),
            "calibrate_dp4tp2": (4, ("--calibrate", "--mesh-devices", "4",
                                     "--mesh-tp", "2"))}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The work directory after both spawns: inputs, the ranks' results,
    and the single-device and JAX results this process computed while the
    ranks ran."""
    d = str(tmp_path_factory.mktemp("calib_mesh"))
    models = {}
    for name in MODELS.values():
        jp = _np_tree(j_zoo.build_model(name, seed=0)[1])
        models[name] = (jp, from_jax(zoo.model_spec(name).cfg, jp)[0])
        torch.save(models[name][1].state_dict(), os.path.join(d, f"{name}.pt"))
    x = _images(1)
    tiny = models["test_tiny"][1]
    inputs = dict(images=x, images5=_images(2, 5), **_order_inputs(),
                  **_family_inputs(tiny, x))
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    spec = zoo.model_spec("test_tiny")
    pc, qc = C.QuantCalibrator(spec, tiny, Config(**SMALL),
                               device="cpu").calibrate([x])
    save_checkpoint(os.path.join(d, "calibrated.ckpt"), pc, qc)
    config = os.path.join(d, "tiny_cfg.py")
    _write_tiny_config(config)

    plans = {
        2: [("order_stats", dict(cases=ORDER_CASES)),
            ("capture", dict(keys=["images", "images5"])),
            ("families", dict(cases=FAMILY_CASES)),
            ("calibrate", dict(runs=[(t + "_dp2", n, o)
                                     for t, n, o in CAL_RUNS] + [
                ("tiny_seq_dp2", "test_tiny", {"batch_sites": False}),
                ("tiny_stream_dp2", "test_tiny", {
                    "capture_device_budget_bytes": 40_000,
                    "streaming_calib": "on"})])),
            ("resume", dict(model_name="test_tiny", cut=6)),
            ("reconstruct", dict(cases=[("whole", 8), ("part", 2)])),
            ("cli", dict(argvs=[_cli_argv(config, os.path.join(d, k), *f)
                                for k, (w, f) in CLI_RUNS.items() if w == 2],
                         n_val=N_VAL))],
        4: [("order_stats", dict(cases=ORDER_CASES, dp=3)),
            ("capture", dict(keys=["images", "images5"])),
            ("calibrate", dict(runs=[(t + "_dp4", n, o)
                                     for t, n, o in CAL_RUNS])),
            ("cli", dict(argvs=[_cli_argv(config, os.path.join(d, k), *f)
                                for k, (w, f) in CLI_RUNS.items() if w == 4],
                         n_val=N_VAL))],
    }
    failed = []

    def run():
        try:
            for world, plan in plans.items():
                M.spawn(ranks.suite, world, (d, plan),
                        init_file=os.path.join(d, f"rendezvous{world}"),
                        timeout=SPAWN_TIMEOUT)
        except BaseException as e:          # raised again in this thread
            failed.append(e)

    t = threading.Thread(target=run)
    t.start()
    try:
        jax_side = _jax_side(d, models, inputs, config)
    finally:
        t.join()
    if failed:
        raise failed[0]
    return dict(dir=d, models=models, inputs=inputs, config=config,
                calibrated=(pc, qc), **jax_side)


def _jax_side(d, models, inputs, config):
    """What this process computes while the ranks run: JAX's sharded
    searches, mesh calibrations and mesh reconstruction (in four threads:
    XLA compiles without the GIL), and the single-device port's CLI
    runs."""
    mesh8 = j_make_mesh(8)
    x = inputs["images"]

    def family(case):
        name, fn, keys, axes, kw = case
        args = _family_args(inputs, keys, axes, kw.get("_tokens"),
                            jnp.asarray)
        args = [a if ax is None else jax.device_put(
            a, j_shard_axis(mesh8, a.ndim, ax)) for a, ax in zip(args, axes)]
        kwj = {k: v for k, v in kw.items() if not k.startswith("_")}
        return name, [np.asarray(r) for r in getattr(JS, fn)(*args, **kwj)]

    def calibrate(key):
        m, dp = key
        name = MODELS[m]
        jc = JQuantCalibrator(j_zoo.model_spec(name), models[name][0],
                              JConfig(**SMALL), mesh=j_make_mesh(dp))
        return m, _np_tree(jc.calibrate([x]))

    def reconstruct():
        jpc, jqc, _ = j_load(os.path.join(d, "calibrated.ckpt"))
        jspec = j_zoo.model_spec("test_tiny")
        jcfg = JConfig(**SMALL, **ranks.RECON, optim_batch_size=8,
                       recon_block_group=1)
        jr = J.BlockReconstructor(jspec, jpc, jax.tree_util.tree_map(
            jnp.asarray, models["test_tiny"][0]), jqc,
            j_quant_layout(jspec, jcfg), jcfg, mesh=j_make_mesh(2))
        trained, real = {}, jr._train_block

        def recording(unit, *a, **k):
            trained[unit.name] = out = real(unit, *a, **k)
            return out
        jr._train_block = recording
        jr.reconstruct([x], quant_act=True)
        return trained

    with ThreadPoolExecutor(4) as pool:
        cal = pool.map(calibrate, list(JAX_DP.items()))
        rec = pool.submit(reconstruct)
        fam = pool.map(family, FAMILY_CASES)
        cal, fam, jtrained = dict(cal), dict(fam), rec.result()
    single_cli = {}
    init = p_data.SyntheticLoader.__init__
    p_data.SyntheticLoader.__init__ = \
        torch_parallel_ranks.small_synthetic_init(N_VAL)
    try:
        for key in ("calibrate", "optimize"):
            out = os.path.join(d, f"single_{key}")
            flags = ("--calibrate",) + (("--optimize",)
                                        if key == "optimize" else ())
            cli.main(argparse.ArgumentParser(
                parents=[cli.get_args_parser()]).parse_args(
                    _cli_argv(config, out, *flags)))
            single_cli[key] = out
    finally:
        p_data.SyntheticLoader.__init__ = init
    return dict(jax_families=fam, jax_calibrations=cal, jax_trained=jtrained,
                single_cli=single_cli)


def _rank_npz(d, what, rank):
    return dict(np.load(os.path.join(d, f"{what}_r{rank}.npz")))


def _ckpt(path, name):
    return load_checkpoint(path, zoo.model_spec(name).cfg)[:2]


# ---------------------------------------------------------------------------
# order statistics, capture
# ---------------------------------------------------------------------------

def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dp", [2, 3])
@pytest.mark.parametrize("case", [c[0] for c in ORDER_CASES])
def test_sharded_order_statistics_bit_for_bit(work, dp, case):
    _, kind, _, dim = next(c for c in ORDER_CASES if c[0] == case)
    x = torch.from_numpy(work["inputs"][case])
    qs = torch.from_numpy(ranks.QS)
    want = positive_percentile(x.reshape(-1), qs) if kind == "positive" \
        else quantile(x, qs, dim=dim)
    got = np.load(os.path.join(work["dir"], f"order_dp{dp}.npz"))[case]
    np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))


def test_signed_zero_cases_hold_both_zeros(work):
    """The ±0 cases do reach -0.0 and +0.0 at the selected positions."""
    qs = torch.from_numpy(ranks.QS)
    got = quantile(torch.from_numpy(work["inputs"]["signed_zeros"]), qs)
    col = quantile(torch.from_numpy(work["inputs"]["columns"]), qs, dim=0)
    signs = set(np.signbit(got.numpy()[got.numpy() == 0]).tolist())
    signs |= set(np.signbit(col.numpy()[:, 4]).tolist())
    assert signs == {True, False}


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("key", ["images", "images5"])
def test_capture_holds_the_ranks_rows(work, dp, key):
    """Each rank's taps: its dp_split of the batch, bit for bit as the
    forward on that slice; its rows of the whole batch's taps to
    CAPTURE_TOL."""
    x = work["inputs"][key]
    tiny = work["models"]["test_tiny"][1]
    whole = _taps(tiny, x)
    rows = torch.tensor_split(torch.arange(len(x)), dp)
    for rank in range(dp):
        got = _rank_npz(work["dir"], f"capture_{key}_dp{dp}", rank)
        own = _taps(tiny, x[rows[rank].numpy()])
        assert {k.rsplit(".", 1)[0] for k in got} == set(whole)
        for nm, tup in whole.items():
            for i, t in enumerate(tup):
                g = got[f"{nm}.{i}"]
                assert g.shape[0] == len(rows[rank]), (nm, rank)
                np.testing.assert_array_equal(g, own[nm][i].numpy())
                np.testing.assert_allclose(g, t[rows[rank]].numpy(),
                                           rtol=CAPTURE_TOL, atol=CAPTURE_TOL)


# ---------------------------------------------------------------------------
# the search families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [c[0] for c in FAMILY_CASES])
def test_family_matches_jax_and_single_device(work, case):
    _, fn, keys, axes, kw = next(c for c in FAMILY_CASES if c[0] == case)
    args = _family_args(work["inputs"], keys, axes, kw.get("_tokens"),
                        torch.from_numpy)
    kwt = {k: v for k, v in kw.items() if not k.startswith("_")}
    with torch.no_grad():
        single = [r.numpy() for r in getattr(TS, fn)(*args, **kwt)]
    ranks_out = [_rank_npz(work["dir"], "families", r) for r in range(2)]
    for i, want in enumerate(single):
        got = ranks_out[0][f"{case}.{i}"]
        np.testing.assert_array_equal(got, ranks_out[1][f"{case}.{i}"])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"{i} single")
        np.testing.assert_allclose(got, work["jax_families"][case][i],
                                   **TOL, err_msg=f"{i} jax")


# ---------------------------------------------------------------------------
# whole calibrations
# ---------------------------------------------------------------------------

def _fields(tree, prefix=""):
    import dataclasses

    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        elif isinstance(v, torch.Tensor):
            yield prefix + f.name, v


def _diverging(got, want):
    """(fields past TOL, fields) of two qstates."""
    assert set(got) == set(want)
    bad = total = 0
    for name in want:
        a, b = dict(_fields(got[name])), dict(_fields(want[name]))
        assert a.keys() == b.keys(), name
        for k in a:
            total += 1
            va, vb = a[k].float().numpy(), b[k].float().numpy()
            bad += not (va.shape == vb.shape and np.allclose(va, vb, **TOL))
    return bad, total


def _quant_error(name, model, qstate, x):
    spec = zoo.model_spec(name)
    fwd = zoo.model_forward_fn(spec)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        y = fwd(spec.cfg, model, xt, qstate, {"*": "quant"})
        return float(torch.linalg.norm(y - fwd(spec.cfg, model, xt)))


CAL_CASES = [(m, dp, g) for m in MODELS for dp in (2, 4) for g in (1, 0)]


@pytest.fixture(scope="module")
def single_calibrations(work):
    out = {}
    for m, name in MODELS.items():
        for g in (1, 0):
            out[m, g] = C.QuantCalibrator(
                zoo.model_spec(name), work["models"][name][1],
                Config(**SMALL, batch_sites=bool(g)),
                device="cpu").calibrate([work["inputs"]["images"]])
    return out


def _mesh_states(work, m, dp, g):
    return [_ckpt(os.path.join(work["dir"], f"{m}_g{g}_dp{dp}_r{r}.ckpt"),
                  MODELS[m]) for r in range(dp)]


@pytest.mark.parametrize("m,dp,g", CAL_CASES)
def test_calibration_ranks_bit_equal(work, m, dp, g):
    states = _mesh_states(work, m, dp, g)
    (p0, q0), rest = states[0], states[1:]
    for p, q in rest:
        for k, v in p0.state_dict().items():
            assert torch.equal(v, p.state_dict()[k]), k
        for nm in q0:
            for (k, a), (_, b) in zip(_fields(q0[nm]), _fields(q[nm])):
                assert torch.equal(a, b), (nm, k)


@pytest.mark.parametrize("m,dp,g", CAL_CASES)
def test_calibration_matches_jax_mesh_and_single_device(
        work, single_calibrations, m, dp, g):
    name = MODELS[m]
    p, q = _mesh_states(work, m, dp, g)[0]
    jp, jq = work["jax_calibrations"][m]
    jmodel, jstate = from_jax(zoo.model_spec(name).cfg, jp, jq)
    sp, sq = single_calibrations[m, g]
    for want in (jstate, sq):
        bad, total = _diverging(q, want)
        assert bad <= max(2, total // 20), (bad, total)
    x = work["inputs"]["images"]
    assert _quant_error(name, p, q, x) <= 1.05 * _quant_error(name, sp, sq,
                                                               x)


def test_streaming_waves_match_one_pass(work):
    """A capture budget of 40 kB streams test_tiny's calibration in waves
    over the mesh: the same state as the one-pass mesh run."""
    p, q = _ckpt(os.path.join(work["dir"], "tiny_stream_dp2_r0.ckpt"),
                 "test_tiny")
    p1, q1 = _mesh_states(work, "tiny", 2, 1)[0]
    bad, total = _diverging(q, q1)
    assert bad <= max(2, total // 20), (bad, total)


def test_mesh_resume_file_written_by_rank_0(work):
    """A mesh calibration stopped after 6 sites resumes from its file to
    the uninterrupted mesh run's state; only rank 0 wrote the file, and
    both ranks read it."""
    d = work["dir"]
    meta = [json.load(open(os.path.join(d, f"resume_r{r}.json")))
            for r in range(2)]
    assert meta[0]["writes"] > 0 and meta[1]["writes"] == 0
    assert all(6 <= m["done_at_cut"] < 14 for m in meta)
    runs = [_ckpt(os.path.join(d, f"resumed_r{r}.ckpt"), "test_tiny")
            for r in range(2)]
    p, q = _ckpt(os.path.join(d, "tiny_seq_dp2_r0.ckpt"), "test_tiny")
    for pr, qr in runs:
        bad, total = _diverging(qr, q)
        assert bad == 0, (bad, total)
        for k, v in p.state_dict().items():
            np.testing.assert_allclose(pr.state_dict()[k].numpy(), v.numpy(),
                                       **TOL, err_msg=k)


# ---------------------------------------------------------------------------
# reconstruction
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_recons(work):
    """The single-device port's reconstructions of both cases, recorded as
    the ranks record theirs."""
    spec = zoo.model_spec("test_tiny")
    params, qstate, _ = load_checkpoint(
        os.path.join(work["dir"], "calibrated.ckpt"), spec.cfg)
    x = work["inputs"]["images"]
    out = {}
    for tag, batch in (("whole", 8), ("part", 2)):
        r, rec, _ = ranks.recorded_recon(spec, params,
                                         work["models"]["test_tiny"][1],
                                         qstate, batch, None, quant_layout)
        r.reconstruct([x[:4], x[4:]])
        out[tag] = (rec, r.unit_stats)
    return out


def _close(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("tag", ["whole", "part"])
def test_brecq_first_step_gradients(work, single_recons, tag):
    """The gradients of the first step (the first unit, the same draw):
    the ranks' summed ones against the single-device step's."""
    want, _ = single_recons[tag]
    for rank in range(2):
        got = _rank_npz(work["dir"], f"recon_{tag}", rank)
        keys = [k for k in want if k.startswith("grad0")]
        assert keys and {k for k in got if k.startswith("grad0")} == set(keys)
        for k in keys:
            _close(got[k], want[k], GRAD_RTOL if k.startswith("grad0.w")
                   else SCALE_GRAD_RTOL, k)


def _alphas(rec):
    return {k: v for k, v in rec.items()
            if k.startswith("trained.") and ".w." in k}


@pytest.mark.parametrize("tag", ["whole", "part"])
def test_brecq_matches_single_device(work, single_recons, tag):
    """After 20 steps a unit: alphas within ALPHA_ATOL, no hard decision
    flipped, activation scales and recs close; the ranks bit-equal."""
    want, wstats = single_recons[tag]
    got = [_rank_npz(work["dir"], f"recon_{tag}", r) for r in range(2)]
    stats = json.load(open(os.path.join(
        work["dir"], f"recon_{tag}_r0.json")))["stats"]
    trained = [k for k in want if k.startswith("trained.")]
    assert trained and set(trained) == {k for k in got[0]
                                        if k.startswith("trained.")}
    for k in trained:
        np.testing.assert_array_equal(got[0][k], got[1][k])
    for k, a in _alphas(want).items():
        np.testing.assert_allclose(got[0][k], a, rtol=0, atol=ALPHA_ATOL,
                                   err_msg=k)
        assert ((got[0][k] >= 0) == (a >= 0)).all(), k
    for k in set(trained) - set(_alphas(want)):
        np.testing.assert_allclose(got[0][k], want[k], rtol=REC_RTOL,
                                   atol=1e-7, err_msg=k)
    assert set(stats) == set(wstats)
    for u, st in wstats.items():
        for f in ("rec_first", "rec_last"):
            tol = KL_ATOL if u == "head" else REC_RTOL * abs(st[f])
            assert abs(stats[u][f] - st[f]) <= tol, (u, f)


def test_brecq_matches_jax_mesh(work):
    """Against JAX's BlockReconstructor(mesh=make_mesh(2)): every step of
    both sees the whole set (optim_batch_size 8 of 8); alphas within
    ALPHA_ATOL, no hard decision flipped."""
    got = _rank_npz(work["dir"], "recon_whole", 0)
    assert work["jax_trained"]
    for unit, (jtr, _, _) in work["jax_trained"].items():
        for cn, a in jtr["w"].items():
            b, a = got[f"trained.{unit}.w.{cn}"], np.asarray(a)
            np.testing.assert_allclose(b, a, rtol=0, atol=ALPHA_ATOL,
                                       err_msg=f"{unit} {cn}")
            assert ((a >= 0) == (b >= 0)).all(), (unit, cn)


@pytest.mark.parametrize("tag", ["whole", "part"])
def test_brecq_ranks_hold_half_the_rows(work, tag):
    for rank in range(2):
        meta = json.load(open(os.path.join(
            work["dir"], f"recon_{tag}_r{rank}.json")))
        assert meta["rows"] and set(meta["rows"].values()) == {4}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", list(CLI_RUNS))
def test_cli_mesh_run_writes_one_checkpoint(work, run):
    """One checkpoint, rank 0's, in one run dir, equal to the single-device
    CLI run's within the calibration gate; the eval ran on the dp x tp
    mesh."""
    d = work["dir"]
    ckpts = glob.glob(os.path.join(d, run, "*", "*.ckpt"))
    logs = glob.glob(os.path.join(d, run, "*", "output.log"))
    key = "optimize" if "optimize" in run else "calibrate"
    tag = "optimsize" if key == "optimize" else "calibsize"
    want = glob.glob(os.path.join(work["single_cli"][key], "*",
                                  f"*{tag}*.ckpt"))
    assert len(logs) == 1 and len(want) == 1
    assert len(ckpts) == (2 if key == "optimize" else 1), ckpts
    got = [c for c in ckpts if tag in os.path.basename(c)]
    assert len(got) == 1
    (p, q), (sp, sq) = (_ckpt(got[0], "test_tiny"),
                        _ckpt(want[0], "test_tiny"))
    bad, total = _diverging(q, sq)
    assert bad <= max(2, total // 20), (bad, total)
    text = open(logs[0]).read()
    dp, tp = (2, 2) if "tp2" in run else (2, 1)
    assert f"dp={dp} x tp={tp} mesh of gloo ranks" in text
    assert "data-parallel over" in text and " * Prec@1 " in text


# ---------------------------------------------------------------------------
# no process group
# ---------------------------------------------------------------------------

def test_mesh_without_a_process_group_raises():
    mesh = M.Mesh(2, 1, 0, 0, None, None, torch.device("cpu"), "gloo")
    spec, model = zoo.build_model("test_tiny", seed=0)
    cfg = Config(**SMALL)
    for call in (
            lambda: M.dp_split(torch.zeros(4), mesh),
            lambda: M.dp_context(mesh).__enter__(),
            lambda: C.capture_all_sites(spec, model, [_images(0, 4)],
                                        mesh=mesh),
            lambda: C.QuantCalibrator(spec, model, cfg, device="cpu",
                                      mesh=mesh),
            lambda: B.BlockReconstructor(spec, model, model, {},
                                         quant_layout(spec, cfg), cfg,
                                         device="cpu", mesh=mesh)):
        with pytest.raises(RuntimeError, match="process group"):
            call()
