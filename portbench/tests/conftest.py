"""Fixtures of the benchmark's tests: a copy of the benchmark whose cells
run each family's tiny stand-in (its ``TINY``: the program's test_tiny,
test_tiny_swin) on the CPU, and a skip for tests that need the card,
decided when a test runs."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _tiny_traffic(t):
    return dict(t, batch=8, distinct_batches=2, calib_images=8,
                trace_batches=2, check_images=4)


def tiny_name(config):
    """The name of a configuration's stand-in."""
    return f"tiny_{config}"


def make_tiny_root(dest):
    """A benchmark root at ``dest`` with BENCHMARK.json's cells renamed to
    the tiny stand-ins (``tiny_<config>.<traffic>``: the sizes of the
    configuration's family's ``TINY``, with the real configuration's
    family, quantizers and serving options), their families and metrics,
    traffic at batch 8 and the real limits. Returns {real cell: tiny
    cell}."""
    from portbench import cell

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    base = os.path.join(dest, "portbench")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for sub in ("metrics", "families"):
        shutil.copytree(os.path.join(ROOT, "portbench", sub),
                        os.path.join(base, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        real = json.load(open(os.path.join(ROOT, c["file"])))
        name = tiny_name(c["name"])
        arch = dict(cell.family(real["family"]).TINY, name=name,
                    source="test fixture", family=real["family"],
                    quant=real["quant"], eval_dtype=real["eval_dtype"],
                    serving=real["serving"], reduced=[])
        json.dump(arch, open(os.path.join(base, "configs", f"{name}.json"),
                             "w"))
    names = {}
    for w in bench["workloads"]:
        tiny = f"{tiny_name(w['config'])}.{w['traffic']}"
        names[w["name"]] = tiny
        t = json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                        f"{w['traffic']}.json")))
        json.dump(_tiny_traffic(t), open(os.path.join(
            base, "traffic", f"{w['traffic']}.json"), "w"))
        shutil.copy(os.path.join(ROOT, "portbench", "limits",
                                 f"{w['name']}.json"),
                    os.path.join(base, "limits", f"{tiny}.json"))
        w["name"], w["config"] = tiny, tiny_name(w["config"])
    bench["configs"] = [
        {"name": n, "source": "test fixture",
         "file": f"portbench/configs/{n}.json", "reduced": [],
         "why": "test fixture"}
        for n in (tiny_name(c["name"]) for c in bench["configs"])]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [names[n] for n in m["workloads"]]
    json.dump(bench, open(os.path.join(dest, "BENCHMARK.json"), "w"),
              indent=1)
    return names


@pytest.fixture
def tiny_root(tmp_path):
    names = make_tiny_root(str(tmp_path))
    return str(tmp_path), names


@pytest.fixture
def cpu_threads():
    import torch

    was = torch.get_num_threads()
    torch.set_num_threads(min(4, was))
    yield
    torch.set_num_threads(was)


@pytest.fixture
def card():
    """The first CUDA device; skips the test where torch finds none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch finds no CUDA device")
    return torch.device("cuda:0")
