"""The port imports no jax, no flax and nothing of adalog_tpu: each module
is imported in a fresh interpreter behind a sys.meta_path finder that
raises on those names (this process has jax loaded already)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the rank entry points of the mesh tests live beside the tests
PATH = os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])

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
    "adalog_tpu_torch.recon.brecq", "adalog_tpu_torch.cli",
    "adalog_tpu_torch.data.imagenet", "adalog_tpu_torch.data.native_loader",
    "adalog_tpu_torch.utils.metrics", "adalog_tpu_torch.utils.ref_checkpoint",
    "adalog_tpu_torch.utils.profiling", "adalog_tpu_torch.utils.checkpoint",
    "adalog_tpu_torch.ops.int8_linear", "adalog_tpu_torch.utils.diagnostics",
    "adalog_tpu_torch.utils.export", "adalog_tpu_torch.parallel.mesh",
    "adalog_tpu_torch.parallel.tp", "adalog_tpu_torch.quantizers.state",
    "torch_calib_mesh_ranks", "torch_parallel_ranks", "chip_smoke"])
def test_module_imports_no_jax(module):
    env = dict(os.environ, PYTHONPATH=PATH)
    out = subprocess.run([sys.executable, "-c", GUARD, module], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"imported {module}" in out.stdout


DP_HELPERS = """
import sys
exec(sys.argv[2])
from adalog_tpu_torch.parallel.mesh import (
    dp_assert_replicated, dp_barrier, dp_batches, dp_context, dp_count,
    dp_max, dp_mesh, dp_order_stats, dp_rows, dp_sum, from_order_key,
    order_key, require_group)
print("imported the dp helpers")
"""


def test_mesh_dp_helpers_import_no_jax():
    """The dp helpers of calibration over a mesh, behind the guard."""
    env = dict(os.environ, PYTHONPATH=PATH)
    guard = GUARD.split("import importlib")[0]
    out = subprocess.run([sys.executable, "-c", DP_HELPERS, "", guard],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imported the dp helpers" in out.stdout


def test_guard_catches_jax():
    env = dict(os.environ, PYTHONPATH=PATH)
    out = subprocess.run([sys.executable, "-c", GUARD,
                          "adalog_tpu.calib.search"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "the port imported" in out.stderr


LOAD_ROUND1 = """
import sys
from adalog_tpu_torch.models.zoo import model_spec
from adalog_tpu_torch.utils.checkpoint import load_checkpoint
model, qstate, meta = load_checkpoint(sys.argv[2], model_spec("test_tiny").cfg)
assert not [m for m in sys.modules if m.split(".")[0] == "adalog_tpu"]
print("loaded", type(model).__name__, len(qstate))
"""


def test_round1_pickle_loads_without_the_jax_package(tmp_path):
    """A round-1 pickle names the JAX package's classes
    (adalog_tpu.models.vit.ViTParams, ...); the port maps the names and
    imports nothing of that package to load it."""
    import pickle

    import jax
    import numpy as np

    from adalog_tpu.calib.init_state import init_qstate
    from adalog_tpu.models.zoo import build_model
    from adalog_tpu.utils.config import Config

    spec, params = build_model("test_tiny", seed=0)
    qstate = init_qstate(spec, Config(w_bit=4, a_bit=4, s_bit=4,
                                      qhead_a_bit=4), params)
    path = str(tmp_path / "round1.ckpt")
    with open(path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, {
            "version": 1, "params": params, "qstate": qstate, "meta": {}}), f)
    with open(path, "rb") as f:
        assert b"adalog_tpu.models.vit" in f.read()
    env = dict(os.environ, PYTHONPATH=PATH)
    script = GUARD.replace("importlib.import_module(sys.argv[1])\n"
                           "print(\"imported\", sys.argv[1])\n", "") \
        + LOAD_ROUND1
    out = subprocess.run([sys.executable, "-c", script, "-", path], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"loaded VisionTransformer {len(qstate)}" in out.stdout
