"""Fixtures of the benchmark's tests: a copy of the benchmark whose cells
run the tiny fixture models (test_tiny, test_tiny_swin) on the CPU, and a
skip for tests that need the card, decided when a test runs."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_VIT = {"name": "tiny_vit", "source": "test fixture",
            "program_model": "test_tiny", "family": "vit", "img_size": 32,
            "patch_size": 8, "in_chans": 3, "embed_dim": 32, "depth": 2,
            "num_heads": 2, "mlp_ratio": 4.0, "num_classes": 10}
TINY_SWIN = {"name": "tiny_swin", "source": "test fixture",
             "program_model": "test_tiny_swin", "family": "swin",
             "img_size": 32, "patch_size": 4, "in_chans": 3,
             "embed_dim": 16, "depths": [1, 2], "num_heads": [2, 4],
             "window_size": 4, "mlp_ratio": 4.0, "num_classes": 10}
# each real configuration's stand-in: (its name, the tiny model)
TINY_CELLS = {"deit_small_w4a4": ("tiny_vit", TINY_VIT),
              "deit_small_w4a4_int8": ("tiny_vit_int8", TINY_VIT),
              "swin_base_w4a4": ("tiny_swin", TINY_SWIN)}


def _tiny_traffic(t):
    return dict(t, batch=8, distinct_batches=2, calib_images=8,
                trace_batches=2, check_images=4)


def make_tiny_root(dest):
    """A benchmark root at ``dest`` with BENCHMARK.json's cells renamed to
    the tiny stand-ins (``<config>.<traffic>`` of tiny_vit, tiny_vit_int8
    or tiny_swin, with the real configuration's quantizers and serving
    options), their metrics, traffic at batch 8 and the real limits.
    Returns {real cell: tiny cell}."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    base = os.path.join(dest, "portbench")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    shutil.copytree(os.path.join(ROOT, "portbench", "metrics"),
                    os.path.join(base, "metrics"))
    for c in bench["configs"]:
        real = json.load(open(os.path.join(ROOT, c["file"])))
        name, tiny = TINY_CELLS[c["name"]]
        arch = dict(tiny, name=name, quant=real["quant"],
                    eval_dtype=real["eval_dtype"], serving=real["serving"],
                    reduced=[])
        json.dump(arch, open(os.path.join(base, "configs", f"{name}.json"),
                             "w"))
    names = {}
    for w in bench["workloads"]:
        tiny = f"{TINY_CELLS[w['config']][0]}.{w['traffic']}"
        names[w["name"]] = tiny
        t = json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                        f"{w['traffic']}.json")))
        json.dump(_tiny_traffic(t), open(os.path.join(
            base, "traffic", f"{w['traffic']}.json"), "w"))
        shutil.copy(os.path.join(ROOT, "portbench", "limits",
                                 f"{w['name']}.json"),
                    os.path.join(base, "limits", f"{tiny}.json"))
        w["name"], w["config"] = tiny, TINY_CELLS[w["config"]][0]
    bench["configs"] = [
        {"name": n, "source": "test fixture",
         "file": f"portbench/configs/{n}.json", "reduced": [],
         "why": "test fixture"} for n, _ in TINY_CELLS.values()]
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
