"""The port's multi-device serving (adalog_tpu_torch/parallel, serve.py and
cli.py under a mesh) against adalog_tpu on the CPU, at test_tiny and
test_tiny_swin size.

The tp plans and the per-rank slices of parameters and quantizer state are
plain functions, held here to the JAX package's plans and to the
addressable shards of its NamedSharding placement on the 8 virtual CPU
devices, bit for bit. The predictors run in gloo ranks on the CPU, spawned
with ``parallel.mesh.spawn`` into a process group through a file in the
test's directory: their entry points (tests/torch_parallel_ranks.py) import
no jax, the JAX mesh predictors run in this process, and the two meet in
.npz files. Logits are held to JAX's mesh predictors and to the port's
single-device predictor at JAX's own tolerances (tests/test_sharding.py:
2e-4; bf16 2e-2 as tests/test_serve.py).

Biases are random (the init leaves them zero). The quantizer state is
init_qstate with activation scales and zero points set as
tests/test_sharding.py sets them, varied per head at the attention matmuls
(so that a wrong head slice shows), and the post-GeLU shift marked folded,
so that fc2 takes the fused GEMM on one device.
"""

import argparse
import dataclasses
import glob
import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding

from adalog_tpu.calib.init_state import init_qstate as j_init_qstate
from adalog_tpu.models.zoo import build_model as j_build_model
from adalog_tpu.parallel import mesh as j_mesh
from adalog_tpu.parallel.tp import make_tp_plan as j_make_tp_plan
from adalog_tpu.serve import make_predictor as j_make_predictor
from adalog_tpu.utils.config import Config as JConfig
import adalog_tpu_torch.data.imagenet as p_data
from adalog_tpu_torch import cli
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.parallel.mesh import (
    Mesh, shard_batch, shard_params_tp, spawn, tp_shardings,
)
from adalog_tpu_torch.parallel.tp import make_tp_plan
from adalog_tpu_torch.serve import load_quantized, make_predictor
from adalog_tpu_torch.utils.checkpoint import save_checkpoint
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.interop import (
    from_jax, qstate_from_tree, swin_state_dict, vit_state_dict,
)
from test_cli import _write_tiny_config
import torch_parallel_ranks as ranks

torch.set_num_threads(1)

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
W4A4 = ranks.W4A4
SPAWN_TIMEOUT = 300
N_VAL = 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(name):
    """(JAX spec, params, qstate) with numpy leaves: init_qstate, uniform
    activation quantizers at scale 0.05 / zero point 8 (test_sharding.py's),
    per-head matmul scales and zero points varied over the heads, and the
    post-GeLU shift marked folded."""
    spec, params = j_build_model(name, seed=0)
    rng = np.random.default_rng(7)
    # biases that are not zero, so that a row-parallel bias added on every
    # rank instead of once would show
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.02 * rng.standard_normal(a.shape).astype(
            np.float32) if jax.tree_util.keystr(path).endswith(".b") else a,
        params)
    qstate = j_init_qstate(spec, JConfig(**W4A4), params)
    for nm, site in list(qstate.items()):
        if hasattr(site, "aq"):
            aq = site.aq
            if aq.kind == "uniform" and aq.zero_point is not None:
                aq = aq.replace(scale=jnp.full_like(aq.scale, 0.05),
                                zero_point=jnp.full_like(aq.zero_point, 8.0))
            elif aq.shifted:
                aq = aq.replace(
                    bias_reparamed=jnp.ones_like(aq.bias_reparamed))
            qstate[nm] = site.replace(aq=aq)
        elif hasattr(site, "Aq"):
            def per_head(q):
                if q.kind != "uniform" or q.scale.ndim != 4:
                    return q
                h = jnp.arange(q.scale.shape[1], dtype=jnp.float32)
                h = h.reshape(1, -1, 1, 1)
                # steps with no rational ratio to the Linear sites' 0.05:
                # a ratio of 1 or 1.5 puts attention outputs (AdaLog
                # probabilities are powers of two) exactly on a .5 code of
                # proj's quantizer, where fp32 sum order decides the code
                return q.replace(scale=0.05 * (1.41421356 + 0.31830989 * h)
                                 + 0 * q.scale,
                                 zero_point=8.0 + h + 0 * q.zero_point)
            qstate[nm] = site.replace(Aq=per_head(site.Aq),
                                      Bq=per_head(site.Bq))
    return spec, _np_tree(params), _np_tree(qstate)


@pytest.fixture(scope="module")
def states():
    """{name: (JAX spec, params, qstate, port spec, module, qstate)}."""
    out = {}
    for name in ("test_tiny", "test_tiny_swin"):
        jspec, jp, jq = _jax_state(name)
        spec = zoo.model_spec(name)
        model, qs = from_jax(spec.cfg, jp, jq)
        out[name] = (jspec, jp, jq, spec, model, qs)
    return out


def _images(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# plans and shards: plain functions, no process group
# ---------------------------------------------------------------------------

PLANS = [("test_tiny", 2), ("test_tiny", 4), ("test_tiny_swin", 2)]


@pytest.mark.parametrize("name,tp", PLANS)
def test_tp_plan_matches_jax(states, name, tp):
    jspec, _, jq, spec, _, qs = states[name]
    want = j_make_tp_plan(jspec, jq, tp)
    got = make_tp_plan(spec, qs, tp)
    assert got.tp == tp and got.family == spec.family
    assert got.col_sites == want.col_sites
    assert got.row_sites == want.row_sites
    assert got.attn_sharded == want.attn_sharded
    assert got.col_sites


def test_tp_plan_falls_back_where_heads_do_not_divide(states):
    """tp=4 does not divide test_tiny's 2 heads: the attention stays
    replicated while the MLP (hidden 128) still slices (as
    test_sharding.py's fallback case)."""
    *_, spec, _, qs = states["test_tiny"]
    plan = make_tp_plan(spec, qs, 4)
    assert not plan.attn_sharded
    assert "blocks.0.attn.proj" not in plan.row_sites
    assert "blocks.0.attn.qkv" not in plan.col_sites
    assert plan.col_sites.get("blocks.0.mlp.fc1") == 1
    assert "blocks.0.mlp.fc2" in plan.row_sites
    specs = plan.params_specs(states["test_tiny"][4].state_dict())
    assert specs["blocks.0.attn.qkv.weight"] is None
    assert specs["blocks.0.mlp.fc1.weight"] == 0
    assert specs["blocks.0.mlp.fc2.weight"] == 1
    assert specs["head.weight"] is None


def _shard_on(arr, device):
    for s in arr.addressable_shards:
        if s.device == device:
            return np.asarray(s.data)
    raise AssertionError(f"no shard on {device}")


def _placed(tree, specs, mesh):
    return jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, specs)


def _state_dict(family, tree):
    return vit_state_dict(tree) if family == "vit" else swin_state_dict(tree)


def _assert_qstates_equal(got, want):
    assert set(got) == set(want)
    for name in got:
        a, b = dataclasses.asdict(got[name]), dataclasses.asdict(want[name])
        flat_a = jax.tree_util.tree_leaves_with_path(
            a, is_leaf=lambda x: x is None)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(
            b, is_leaf=lambda x: x is None))
        assert len(flat_a) == len(flat_b), name
        for path, x in flat_a:
            y = flat_b[path]
            if isinstance(x, torch.Tensor):
                np.testing.assert_array_equal(
                    x.numpy(), y.numpy(), err_msg=f"{name}{path}")
            else:
                assert x == y, f"{name}{path}"


@pytest.mark.parametrize("name,tp", PLANS)
def test_shards_match_jax_bit_for_bit(states, name, tp):
    """Each rank's permuted parameter slices and quantizer-state slices
    equal the shards JAX's tp placement puts on that rank's device of a
    (1, tp) mesh: Swin's gathered rel-pos bias shard, ungathered, is the
    rank's column slice of the table."""
    jspec, jp, jq, spec, model, qs = states[name]
    jplan = j_make_tp_plan(jspec, jq, tp)
    jm = j_mesh.make_mesh_2d(1, tp)
    perm = jplan.permute_params(jp)
    p_placed = _placed(perm, jplan.params_specs(perm), jm)
    qspecs = jplan.qstate_specs(jq)
    q_placed = {k: _placed(v, qspecs[k], jm) for k, v in jq.items()}
    plan = make_tp_plan(spec, qs, tp)
    sliced = plan.qstate_specs(qs)
    assert sliced, "no quantizer state sliced"
    for t in range(tp):
        dev = jm.devices[0, t]
        want = _state_dict(spec.family, jax.tree_util.tree_map(
            lambda a, _d=dev: _shard_on(a, _d), p_placed))
        got = plan.shard_module(model, t).state_dict()
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        want_q = qstate_from_tree({k: jax.tree_util.tree_map(
            lambda a, _d=dev: _shard_on(a, _d), v)
            for k, v in q_placed.items()})
        _assert_qstates_equal(plan.shard_qstate(qs, t), want_q)


@pytest.mark.parametrize("name", ["test_tiny", "test_tiny_swin"])
def test_placement_table_matches_jax(states, name):
    """``tp_shardings`` / ``shard_params_tp`` (the GSPMD table of
    parallel/mesh.py) on a (2, 4) mesh: qkv / fc1 slice their rows, proj /
    fc2 their columns, norms and rel-pos tables stay whole, the 10-class
    head too (10 % 4); every rank's slices equal JAX's shards."""
    jspec, jp, _, spec, model, _ = states[name]
    table = tp_shardings(model.state_dict(), 4)
    pre = "blocks.0" if spec.family == "vit" else "layers.1.blocks.0"
    assert table[f"{pre}.attn.qkv.weight"] == 0
    assert table[f"{pre}.attn.proj.weight"] == 1
    assert table[f"{pre}.mlp.fc1.weight"] == 0
    assert table[f"{pre}.mlp.fc2.weight"] == 1
    assert table[f"{pre}.norm1.weight"] is None
    assert table["head.weight" if spec.family == "vit"
                 else "head.fc.weight"] is None
    if spec.family == "swin":
        assert table[f"{pre}.attn.relative_position_bias_table"] is None
    jm = j_mesh.make_mesh_2d(2, 4)
    placed = j_mesh.shard_params_tp(jp, jm)
    for t in range(4):
        mesh = Mesh(2, 4, 1, t, None, None, torch.device("cpu"), "gloo")
        want = _state_dict(spec.family, jax.tree_util.tree_map(
            lambda a, _d=jm.devices[1, t]: _shard_on(a, _d), placed))
        got = shard_params_tp(model, mesh)
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_shard_batch_splits_over_dp():
    x = torch.arange(12.0).reshape(6, 2)
    for d in range(3):
        mesh = Mesh(3, 2, d, 1, None, None, torch.device("cpu"), "gloo")
        assert torch.equal(shard_batch(x, mesh), x[2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x[:5], Mesh(3, 1, 0, 0, None, None, torch.device("cpu"),
                                "gloo"))


def test_load_quantized_mesh_needs_its_ranks(states, tmp_path):
    """Outside a process group of the mesh's size the mesh cannot form: the
    error says how to launch; mesh_tp without mesh_devices, or not dividing
    it, is refused as in the JAX package."""
    *_, spec, model, qs = states["test_tiny"]
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, model, qs)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        load_quantized("test_tiny", path, device="cpu", mesh_devices=2)
    with pytest.raises(ValueError, match="requires mesh_devices"):
        load_quantized("test_tiny", path, device="cpu", mesh_tp=2)
    with pytest.raises(ValueError, match="must divide"):
        load_quantized("test_tiny", path, device="cpu", mesh_devices=4,
                       mesh_tp=3)
    predict, *_ = load_quantized("test_tiny", path, device="cpu",
                                 mesh_devices=-1)     # every rank: one here
    assert tuple(predict(_images(0, 2)).shape) == (2, 10)


# ---------------------------------------------------------------------------
# predictors in gloo ranks on the CPU
# ---------------------------------------------------------------------------

MODEL = {"tiny": "test_tiny", "swin": "test_tiny_swin"}
# (case, model, dp, tp, dtype, GEMM switch, int8, inputs)
CASES = [
    ("tiny_tp2", "tiny", 1, 2, "float32", True, False, ("x8", "x3", "x5")),
    ("tiny_tp2_bf16", "tiny", 1, 2, "bfloat16", True, False, ("x8",)),
    ("tiny_dp2", "tiny", 2, 1, "float32", True, False, ("x8", "x3", "x5")),
    ("swin_tp2", "swin", 1, 2, "float32", True, False, ("x8", "x5")),
    ("tiny_tp2_int8", "tiny", 1, 2, "float32", True, True, ("x8", "x3")),
    ("tiny_dp2tp2", "tiny", 2, 2, "float32", True, False, ("x8", "x3", "x5")),
]
CASE = {c[0]: c for c in CASES}
INPUTS = {"x8": 8, "x3": 3, "x5": 5}


@pytest.fixture(scope="module")
def served(states, tmp_path_factory):
    """Every case served in its ranks (world 2, then world 4): the work
    directory holding each rank's results, and the checkpoints."""
    work = str(tmp_path_factory.mktemp("ranks"))
    np.savez(os.path.join(work, "inputs.npz"),
             **{k: _images(10 + n, n) for k, n in INPUTS.items()})
    ckpts = {}
    for key, name in MODEL.items():
        *_, model, qs = states[name]
        ckpts[key] = os.path.join(work, f"{name}.ckpt")
        save_checkpoint(ckpts[key], model, qs)
    for world in (2, 4):
        cases = [dict(name=c, model=MODEL[m], ckpt=ckpts[m], dp=dp, tp=tp,
                      dtype=dt, gemm=gemm, int8=int8, inputs=list(inp))
                 for c, m, dp, tp, dt, gemm, int8, inp in CASES
                 if dp * tp == world]
        spawn(ranks.predictor_cases, world, (work, cases),
              init_file=os.path.join(work, f"rendezvous{world}"),
              timeout=SPAWN_TIMEOUT)
    return work, ckpts


def _rank_result(work, case, rank):
    with open(os.path.join(work, f"{case}_r{rank}.json")) as f:
        meta = json.load(f)
    return dict(np.load(os.path.join(work, f"{case}_r{rank}.npz"))), meta


def _single_predictor(states, case):
    _, m, _, _, dt, gemm, int8, _ = CASE[case]
    *_, spec, model, qs = states[MODEL[m]]
    return make_predictor(spec, model, qs, eval_dtype=dt, device="cpu",
                          cfg=Config(**W4A4), use_gemm_kernels=gemm,
                          use_int8=int8)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_logits_match_single_device(states, served, case):
    """Every rank returns the whole batch's logits, remainder batches
    included, equal to the port's single-device predictor's."""
    work, _ = served
    _, _, dp, tp, dt, *_, inputs = CASE[case]
    single = _single_predictor(states, case)
    x = np.load(os.path.join(work, "inputs.npz"))
    for rank in range(dp * tp):
        out, _ = _rank_result(work, case, rank)
        for key in inputs:
            want = single(x[key]).numpy()
            assert out[key].shape == want.shape == (INPUTS[key], 10)
            np.testing.assert_allclose(out[key], want, rtol=TOL[dt],
                                       atol=TOL[dt], err_msg=f"rank {rank}")


@pytest.mark.parametrize("case", [c[0] for c in CASES if not c[6]])
def test_mesh_logits_match_jax_mesh_predictor(states, served, case):
    """Rank 0's logits against JAX's make_predictor over the same (dp, tp)
    mesh of virtual devices (kernels off there: XLA's path)."""
    work, _ = served
    _, m, dp, tp, dt, *_, inputs = CASE[case]
    jspec, jp, jq, *_ = states[MODEL[m]]
    jm = j_mesh.make_mesh(dp) if tp == 1 else j_mesh.make_mesh_2d(dp, tp)
    predict = j_make_predictor(jspec, jp, jq, eval_dtype=dt, mesh=jm)
    x = np.load(os.path.join(work, "inputs.npz"))
    out, _ = _rank_result(work, case, 0)
    for key in inputs:
        np.testing.assert_allclose(out[key], np.asarray(predict(x[key])),
                                   rtol=TOL[dt], atol=TOL[dt], err_msg=key)


def _per_batch(meta, kernel):
    return [c[kernel] for c in meta["calls"]]


@pytest.mark.parametrize("case", ["tiny_tp2", "tiny_dp2tp2", "swin_tp2"])
def test_tp_ranks_leave_row_sites_unfused(states, served, case):
    """With the GEMM switch on, each tp rank runs K1 once a block on its
    local heads and K4 at the column-parallel and replicated sites only:
    the row-parallel sites (proj, fc2) never take K4."""
    work, _ = served
    _, m, dp, tp, *_ = CASE[case]
    *_, spec, _, qs = states[MODEL[m]]
    plan = make_tp_plan(spec, qs, tp)
    linear = [n for n, s in qs.items() if hasattr(s, "n_V")]
    want_k4 = len(linear) - len(plan.row_sites)
    n_blocks = 2 if m == "tiny" else 3
    for rank in range(dp * tp):
        _, meta = _rank_result(work, case, rank)
        assert set(_per_batch(meta, "K1")) == {n_blocks}
        assert set(_per_batch(meta, "K4")) == {want_k4}
        asked = set(meta["looked_up"]["K4"])
        assert asked == set(linear) - plan.row_sites
        assert not asked & plan.row_sites


def test_dp_ranks_run_every_site_fused(states, served):
    *_, qs = states["test_tiny"]
    linear = [n for n, s in qs.items() if hasattr(s, "n_V")]
    for rank in range(2):
        _, meta = _rank_result(served[0], "tiny_dp2", rank)
        assert set(_per_batch(meta, "K4")) == {len(linear)}
        assert set(_per_batch(meta, "K1")) == {2}


def test_int8_tp_ranks_choose_per_site(states, served):
    """eval_int8 with the GEMM switch at tp=2: the uniform column-parallel
    and replicated sites (qkv, fc1, the head) run as integer products (K5);
    the row-parallel sites take neither K5 nor K4, so K4 runs nowhere (fc2,
    the one AdaLog site, is row-parallel)."""
    *_, spec, _, qs = states["test_tiny"]
    plan = make_tp_plan(spec, qs, 2)
    for rank in range(2):
        _, meta = _rank_result(served[0], "tiny_tp2_int8", rank)
        asked = set(meta["looked_up"]["K5"])
        assert asked == {"blocks.0.attn.qkv", "blocks.0.mlp.fc1",
                         "blocks.1.attn.qkv", "blocks.1.mlp.fc1", "head"}
        assert not (asked | set(meta["looked_up"]["K4"])) & plan.row_sites
        assert set(_per_batch(meta, "K5")) == {5}
        assert set(_per_batch(meta, "K4")) == {0}
        assert set(_per_batch(meta, "K1")) == {2}


# ---------------------------------------------------------------------------
# the CLI over a mesh
# ---------------------------------------------------------------------------

def _precisions(out_dir):
    logs = glob.glob(os.path.join(out_dir, "*", "output.log"))
    assert len(logs) == 1, logs                  # one run dir, rank 0's
    text = open(logs[0]).read()
    return re.findall(r" \* Prec@1 (\S+) Prec@5 (\S+)", text), text


def test_cli_mesh_eval_matches_single_device(served, tmp_path, monkeypatch):
    """``--load-calibrate-checkpoint --test-calibrate-checkpoint
    --mesh-devices 4 --mesh-tp 2 --device cpu`` in 4 gloo ranks gives the
    single-device CLI's top-1 / top-5 on the same synthetic val set."""
    work, ckpts = served
    config = str(tmp_path / "tiny_cfg.py")
    _write_tiny_config(config)
    with open(config, "a") as f:
        f.write("        self.use_pallas = True\n")
    argv = ["--model", "test_tiny", "--config", config, "--synthetic-data",
            "--device", "cpu", "--val-batch-size", "3",
            "--load-calibrate-checkpoint", ckpts["tiny"],
            "--test-calibrate-checkpoint"]
    single_dir, mesh_dir = str(tmp_path / "single"), str(tmp_path / "mesh")
    monkeypatch.setattr(p_data.SyntheticLoader, "__init__",
                        ranks.small_synthetic_init(N_VAL))
    cli.main(argparse.ArgumentParser(parents=[cli.get_args_parser()])
             .parse_args(argv + ["--output-dir", single_dir]))
    spawn(ranks.cli_run, 4, (argv + ["--output-dir", mesh_dir,
                                     "--mesh-devices", "4", "--mesh-tp", "2"],
                             N_VAL),
          init_file=str(tmp_path / "rendezvous"), timeout=SPAWN_TIMEOUT)
    want, _ = _precisions(single_dir)
    got, text = _precisions(mesh_dir)
    assert len(want) == 1 and got == want
    assert "dp=2 x tp=2 mesh of gloo ranks" in text


@pytest.mark.parametrize("flags", [["--calibrate"], ["--optimize"]])
def test_cli_mesh_calibration_is_the_next_slice(tmp_path, monkeypatch,
                                                flags):
    """Calibration and reconstruction over a mesh are ported: a run that
    asks for them over 4 ranks gets the dp mesh of all 4 (they run dp over
    every rank; tests/test_torch_calib_mesh.py runs them)."""
    args = argparse.ArgumentParser(
        parents=[cli.get_args_parser()]).parse_args(
            ["--model", "test_tiny", "--device", "cpu", "--synthetic-data",
             "--mesh-devices", "4", "--output-dir", str(tmp_path)] + flags)
    monkeypatch.setenv("WORLD_SIZE", "4")        # as torchrun sets it
    assert cli.check_mesh(args) == (4, 1)
