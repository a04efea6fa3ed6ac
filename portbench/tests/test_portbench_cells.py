"""Every cell, run on its tiny stand-in on the CPU through the plain
versions of the kernels, prints the contract's result; a cell, metric or
model family added as files alone is found; nothing of JAX is imported,
and the reference and the families import nothing of the program."""

import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, make_tiny_root, tiny_name
from portbench import cell as cells, run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}
SEED = 2 ** 31 + 12345          # past 32 signed bits


def result_line(cell, trace, **kw):
    result = run.execute(cell, SEED, 0.5, trace, torch.device("cpu"), **kw)
    out, err = io.StringIO(), io.StringIO()
    run.emit(result, out, err)
    last = out.getvalue().strip().splitlines()[-1]
    checks = err.getvalue().strip().splitlines()
    return json.loads(last), checks


@pytest.mark.parametrize("real", [
    "deit_small_w4a4.serve_b200", "swin_base_w4a4.serve_b200",
    "deit_small_w4a4.serve_int8_b200"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_prints_the_contract(tiny_root, cpu_threads, real, trace):
    root, names = tiny_root
    cell = cells.load(names[real], root)
    res, checks = result_line(cell, trace)
    assert set(res) == KEYS
    assert list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    want = [m["name"] for m in (cell["per_layer"] if trace
                                else cell["end_to_end"])]
    if trace:       # the device readers find nothing on the CPU
        assert set(res["metrics"]) <= set(want)
        assert {"serve.host_ms", "serve.mfu_pct"} <= set(res["metrics"])
    else:
        assert sorted(res["metrics"]) == sorted(want)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert [c.split()[1] for c in checks] == list(res["check"])
    for name, c in res["check"].items():
        assert c["value"] <= c["limit"], name


def test_cell_added_as_files(tmp_path, cpu_threads):
    root = str(tmp_path)
    make_tiny_root(root)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    src = os.path.join(root, "portbench")
    arch = json.load(open(os.path.join(
        src, "configs", f"{tiny_name('deit_small_w4a4')}.json")))
    arch.update(name="tiny_vit_b", depth=2)
    json.dump(arch, open(os.path.join(src, "configs", "tiny_vit_b.json"),
                         "w"))
    t = json.load(open(os.path.join(src, "traffic", "serve_b200.json")))
    json.dump(dict(t, batch=4), open(os.path.join(
        src, "traffic", "serve_b4.json"), "w"))
    json.dump({"site_rel_err_max": 5e-5}, open(os.path.join(
        src, "limits", "tiny_vit_b.serve_b4.json"), "w"))
    with open(os.path.join(src, "metrics", "serve.batches.py"), "w") as f:
        f.write('NAME = "serve.batches"\nLAYER = "predictor (serve.py)"\n'
                'UNIT = "count"\nSOURCE = "host_clock"\n'
                'MOVES = "serve_img_s"\n\n\ndef read(ctx):\n'
                '    return float(len(ctx["host_ms"]))\n')
    bench["configs"].append({"name": "tiny_vit_b", "source": "test",
                             "file": "portbench/configs/tiny_vit_b.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_vit_b.serve_b4",
                               "config": "tiny_vit_b",
                               "traffic": "serve_b4", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "serve_img_s":
            m["workloads"].append("tiny_vit_b.serve_b4")
    bench["per_layer"].append({"name": "serve.batches", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "predictor (serve.py)",
                               "moves": "serve_img_s",
                               "workloads": ["tiny_vit_b.serve_b4"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    cell = cells.load("tiny_vit_b.serve_b4", root)
    assert cell["traffic"]["batch"] == 4
    res, _ = result_line(cell, 1)
    assert res["correct"] is True
    assert res["metrics"]["serve.batches"]["value"] >= 1
    res, _ = result_line(cell, 0)
    assert set(res["metrics"]) == {"serve_img_s", "setup_s"}


COUNTED = """

# counts the images this copy of the family embeds, so a run shows it
# went through this file
EMBEDDED = []
_embed = embed


def embed(run, arch, x):
    EMBEDDED.append(x.shape[0])
    return _embed(run, arch, x)
"""


@pytest.mark.parametrize("family", ["vit_twin", "no_such_family"])
def test_family_added_as_files(tmp_path, cpu_threads, family):
    """A configuration of a family that no configuration of BENCHMARK.json
    uses, with its module, cell, traffic and limits added as files and its
    entries added to BENCHMARK.json, runs ``correct``; one whose family
    has no module is refused, naming the file looked for."""
    root = str(tmp_path)
    make_tiny_root(root)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    src = os.path.join(root, "portbench")
    module = os.path.join(src, "families", f"{family}.py")
    if family != "no_such_family":
        with open(module, "w") as f:
            f.write(open(os.path.join(ROOT, "portbench", "families",
                                      "vit.py")).read() + COUNTED)
    real = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                       "deit_small_w4a4.json")))
    arch = dict(cells.family("vit").TINY, name="tiny_twin", source="test",
                family=family, quant=real["quant"],
                eval_dtype=real["eval_dtype"], serving=real["serving"],
                reduced=[])
    json.dump(arch, open(os.path.join(src, "configs", "tiny_twin.json"),
                         "w"))
    t = json.load(open(os.path.join(src, "traffic", "serve_b200.json")))
    json.dump(dict(t, batch=4), open(os.path.join(
        src, "traffic", "serve_b4.json"), "w"))
    json.dump({"site_rel_err_max": 5e-5, "attention_rel_err_max": 1e-4},
              open(os.path.join(src, "limits", "tiny_twin.serve_b4.json"),
                   "w"))
    bench["configs"].append({"name": "tiny_twin", "source": "test",
                             "file": "portbench/configs/tiny_twin.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_twin.serve_b4",
                               "config": "tiny_twin", "traffic": "serve_b4",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_img_s":
            m["workloads"].append("tiny_twin.serve_b4")
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    if family == "no_such_family":
        with pytest.raises(FileNotFoundError, match=re.escape(module)):
            cells.load("tiny_twin.serve_b4", root)
        return
    cell = cells.load("tiny_twin.serve_b4", root)
    res, checks = result_line(cell, 0)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"serve_img_s", "setup_s"}
    assert [c.split()[1] for c in checks] == list(res["check"])
    twin = cells.family(family, root)
    assert twin.__file__ == module and twin.EMBEDDED


BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {names!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def _run(code, tiny):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", code], cwd=tiny, env=env,
                          capture_output=True, text=True, timeout=300)


FAMILIES = sorted(f[:-3] for f in os.listdir(os.path.join(
    ROOT, "portbench", "families")) if f.endswith(".py"))


def test_run_imports_no_jax(tiny_root):
    root, names = tiny_root
    code = BLOCKER.format(names={"jax", "jaxlib", "flax", "adalog_tpu"}) + f"""
import torch
from portbench import cell, run
for name in {FAMILIES!r}:
    cell.family(name, {root!r})
c = cell.load({names['swin_base_w4a4.serve_b200']!r}, {root!r})
r = run.execute(c, 3, 0.2, 1, torch.device("cpu"))
assert r["correct"], r
bad = run.forbidden_modules()
assert not bad, bad
assert run.forbidden_modules(["jax.numpy", "adalog_tpu.ops"]) == \\
    ["adalog_tpu.ops", "jax.numpy"]
assert run.forbidden_modules(["adalog_tpu_torch.serve", "jaxtyping"]) == []
print("ok")
"""
    p = _run(code, root)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), p.stderr


def test_reference_imports_nothing_of_the_program(tiny_root):
    root, names = tiny_root
    blocked = {"jax", "jaxlib", "flax", "adalog_tpu", "adalog_tpu_torch"}
    code = BLOCKER.format(names=blocked) + f"""
import json, torch
from portbench import check, counts, reference, state, trace, cell
for name in {FAMILIES!r}:
    cell.family(name, {root!r})
for c in ({names['deit_small_w4a4.serve_b200']!r},
          {names['swin_base_w4a4.serve_b200']!r}):
    arch = cell.load(c, {root!r})["arch"]
    w = state.make_weights(arch, 5, torch.device("cpu"))
    x = state.make_images(arch, 5, 1, 4, torch.device("cpu"))[0]
    plan = state.make_plan(arch, w, x, 5)
    y = reference.forward(arch, w, plan, x)
    assert y.shape == (4, 10) and torch.isfinite(y).all()
    assert counts.forward_flops(arch) > 0
print("ok")
"""
    p = _run(code, root)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), p.stderr


def test_no_card_no_result(tmp_path):
    """run.py exits non-zero and prints no result where torch finds no
    CUDA device (this machine), and where the program is missing."""
    p = subprocess.run([sys.executable, os.path.join(ROOT, "portbench",
                                                     "run.py"),
                        "--workload", "deit_small_w4a4.serve_b200",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert p.returncode != 0 and p.stdout.strip() == ""
    alone = tmp_path / "alone"
    alone.mkdir()
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), alone)
    shutil.copytree(os.path.join(ROOT, "portbench"), alone / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "deit_small_w4a4.serve_b200", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=alone,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout.strip() == ""
