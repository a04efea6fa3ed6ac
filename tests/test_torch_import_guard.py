"""The port imports no jax, no flax and nothing of adalog_tpu: each module
is imported in a fresh interpreter behind a sys.meta_path finder that
raises on those names (this process has jax loaded already)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = """
import sys

class Guard:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax") or top == "adalog_tpu":
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Guard())
import importlib
importlib.import_module(sys.argv[1])
print("imported", sys.argv[1])
"""


@pytest.mark.parametrize("module", [
    "adalog_tpu_torch.calib.calibrator", "adalog_tpu_torch.calib.search",
    "adalog_tpu_torch.calib.candidates", "adalog_tpu_torch.ops.scoring",
    "adalog_tpu_torch.utils.resume", "adalog_tpu_torch.serve",
    "adalog_tpu_torch.models.swin", "adalog_tpu_torch.ops.fq_gemm",
    "adalog_tpu_torch.calib.reparam", "adalog_tpu_torch.recon.blocks",
    "adalog_tpu_torch.recon.brecq", "chip_smoke"])
def test_module_imports_no_jax(module):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", GUARD, module], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"imported {module}" in out.stdout


def test_guard_catches_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", GUARD,
                          "adalog_tpu.calib.search"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "the port imported" in out.stderr
