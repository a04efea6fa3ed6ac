"""K7's wrapper (adalog_tpu_torch/ops/layer_norm.py) on the CPU: the plain
version is the eager chain ``models.layers.layer_norm`` ran before K7, bit
for bit; which LayerNorms a predictor's plan routes to K7 (every one of
each family's fixtures on a CUDA device, none on the CPU, none of the
per-head q_norm / k_norm, none that ``supports`` refuses); what routes a
served forward through the wrapper and what never does (calibration,
BRECQ, training, a CPU predictor); the layouts and load widths K7 is
handed; and that importing the module builds nothing. The kernel itself is
held to the float64 LayerNorm and to the chain on the card
(tests/test_torch_layer_norm_cuda.py).

A CPU run cannot route to K7 (its plan names CUDA LayerNorms only), so the
tests that follow a plan's LayerNorms through a forward let
``layer_norm.DEVICES`` include the CPU: the wrapper then runs the plain
version, and the forward's logits equal those outside any plan.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from adalog_tpu_torch.calib.init_state import init_qstate
from adalog_tpu_torch.models import layers, zoo
from adalog_tpu_torch.ops import layer_norm as ln
from adalog_tpu_torch.ops import routes
from adalog_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W4A4 = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)
FAMILIES = ("test_tiny", "test_tiny_swin", "test_tiny_eva")

torch.set_num_threads(2)


def _old_chain(p, x):
    """``models.layers.layer_norm`` before K7, as it was written."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + p.eps) * p.weight + p.bias


def _norm(D, dtype=torch.float32, eps=1e-6, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = torch.nn.LayerNorm(D, eps=eps).to(dtype)
    with torch.no_grad():
        m.weight.copy_(1 + 0.1 * torch.randn(D, generator=g))
        m.bias.copy_(0.1 * torch.randn(D, generator=g))
    return m.requires_grad_(False)


def _served(name):
    spec, model = zoo.build_model(name, seed=0)
    return spec, model, init_qstate(spec, Config(**W4A4), model)


def _norm_names(model):
    return {n for n, m in model.named_modules()
            if isinstance(m, torch.nn.LayerNorm)}


def _images(spec, n=2, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, spec.cfg.img_size, spec.cfg.img_size, 3)).astype(np.float32))


@pytest.fixture
def on_cpu_too(monkeypatch):
    """Plans route the CPU's LayerNorms as a card's."""
    monkeypatch.setattr(ln, "DEVICES", ("cuda", "cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 7, 384), (5, 2730), (1, 128),
                                   (2, 4, 4, 1024)])
def test_plain_is_the_old_chain_bit_for_bit(dtype, shape):
    """The plain version, and ``layers.layer_norm`` outside a plan, give
    the old chain's bits, in float32 and bfloat16."""
    p = _norm(shape[-1], dtype)
    x = (3 * torch.randn(shape, generator=torch.Generator().manual_seed(1))
         + 0.5).to(dtype)
    want = _old_chain(p, x)
    assert torch.equal(ln.layer_norm_plain(x, p.weight, p.bias, p.eps), want)
    assert torch.equal(layers.layer_norm(p, x), want)
    assert torch.equal(layers.layer_norm(p, x, training=True), want)


@pytest.mark.parametrize("name", FAMILIES)
def test_build_routes_every_norm_of_the_fixture(on_cpu_too, name):
    """On a device K7 runs on, a predictor's plan routes every LayerNorm
    of each family's fixture (each fixture has no per-head one)."""
    spec, model, qstate = _served(name)
    plan = routes.build(spec, model, qstate, Config(**W4A4))
    names = {n for n, m in model.named_modules() if m in plan.norms}
    assert names == _norm_names(model) and names
    assert isinstance(plan.norms, frozenset)


@pytest.mark.parametrize("name", FAMILIES)
def test_cpu_plan_routes_no_norm(name):
    """A predictor on the CPU routes no LayerNorm."""
    spec, model, qstate = _served(name)
    assert routes.build(spec, model, qstate, Config(**W4A4)).norms == \
        frozenset()


@pytest.mark.parametrize("name,want", [
    ("deit_small", {384: 25}),
    # the patch norm and 2 a block at 128 / 256 / 512 / 1024 (2-2-18-2
    # blocks), the merges at 512, 1024 and 2048, the final norm at 1024
    ("swin_base", {128: 5, 256: 4, 512: 37, 1024: 6, 2048: 1}),
    # 3 a block (the sub-LN over 2730) and fc_norm
    ("eva02_large_448", {1024: 49, 2730: 24})])
def test_zoo_norms_by_width(monkeypatch, name, want):
    """The benchmark's models, built without storage: deit_small 25
    LayerNorms, swin_base 53, eva02_large_448 73, every one taken, at the
    widths K7 serves."""
    monkeypatch.setattr(ln, "DEVICES", ("meta",))
    _, model = zoo.build_model(name, seed=0, device="meta")
    norms = ln.plan_norms(model)
    got = {}
    for m in norms:
        got[m.weight.numel()] = got.get(m.weight.numel(), 0) + 1
    assert got == want
    assert len(norms) == sum(isinstance(m, torch.nn.LayerNorm)
                             for m in model.modules())


@pytest.mark.parametrize("make,ok", [
    (lambda: torch.nn.LayerNorm(384), True),
    (lambda: torch.nn.LayerNorm(2730).to(torch.bfloat16), True),
    (lambda: torch.nn.LayerNorm(ln.MAX_D), True),
    (lambda: torch.nn.LayerNorm(ln.MAX_D + 1), False),
    (lambda: torch.nn.LayerNorm(384, bias=False), False),
    (lambda: torch.nn.LayerNorm(384, elementwise_affine=False), False),
    (lambda: torch.nn.LayerNorm((4, 96)), False),
    (lambda: torch.nn.LayerNorm(384).to(torch.float16), False),
    (lambda: torch.nn.LayerNorm(384).to(torch.float64), False),
])
def test_supports(make, ok):
    assert ln.supports(make()) is ok


def test_only_supported_norms_are_routed(on_cpu_too):
    """A LayerNorm that ``supports`` refuses is left out of the plan and
    stays on the plain version."""
    spec, model, qstate = _served("test_tiny")
    model.blocks[0].norm1.bias = None
    plan = routes.build(spec, model, qstate, Config(**W4A4))
    assert model.blocks[0].norm1 not in plan.norms
    assert len(plan.norms) == len(_norm_names(model)) - 1


def test_q_norm_and_k_norm_stay_on_the_chain(on_cpu_too):
    """A ViT with per-head q_norm / k_norm: the plan leaves them out, and
    a forward under it hands them to the plain version, not the wrapper."""
    from adalog_tpu_torch.models.vit import Attention

    spec, model, qstate = _served("test_tiny")
    for blk in model.blocks:
        old = blk.attn
        blk.attn = Attention(spec.cfg, qk_norm=True)
        blk.attn.load_state_dict(old.state_dict(), strict=False)
    plan = routes.build(spec, model, qstate, Config(**W4A4))
    per_head = {m for n, m in model.named_modules()
                if n.endswith(("q_norm", "k_norm"))}
    assert len(per_head) == 2 * len(model.blocks)
    assert not per_head & plan.norms
    assert len(plan.norms) == len(_norm_names(model)) - len(per_head)
    seen = []
    real = ln.layer_norm_rows
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "layer_norm_rows",
                   lambda p, x: seen.append(p) or real(p, x))
        with torch.no_grad(), routes.activate(plan):
            zoo.model_forward_fn(spec)(spec.cfg, model, _images(spec),
                                       qstate, {"*": "quant"})
    assert seen and not per_head & set(seen)
    assert set(seen) == plan.norms


@pytest.mark.parametrize("name", FAMILIES)
def test_served_forward_under_a_plan(on_cpu_too, name):
    """Each family's quantized forward under a plan hands every LayerNorm
    to the wrapper once, in a layout K7 reads (rows at one stride, the
    last dimension contiguous), and, the wrapper running the plain version
    on the CPU, gives the logits of the forward outside any plan bit for
    bit; training under the same plan hands none."""
    spec, model, qstate = _served(name)
    fwd = zoo.model_forward_fn(spec)
    x = _images(spec)
    plan = routes.build(spec, model, qstate, Config(**W4A4))
    layouts = []
    real = ln.layer_norm_rows
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "layer_norm_rows",
                   lambda p, x: layouts.append(ln.rows_of(x)) or real(p, x))
        calls = ln.layer_norm_rows.calls
        with torch.no_grad(), routes.activate(plan):
            got = fwd(spec.cfg, model, x, qstate, {"*": "quant"})
        assert ln.layer_norm_rows.calls - calls == len(plan.norms)
        assert len(layouts) == len(plan.norms)
        assert all(lay is not None for lay in layouts), layouts
        calls = ln.layer_norm_rows.calls
        with routes.activate(plan):
            fwd(spec.cfg, model, x, qstate, {"*": "quant"}, training=True)
        assert ln.layer_norm_rows.calls == calls
    with torch.no_grad():
        want = fwd(spec.cfg, model, x, qstate, {"*": "quant"})
    assert torch.equal(got, want)
    assert ln.layer_norm_rows.launches == 0


def test_calibration_and_brecq_route_none(on_cpu_too):
    """Calibration and BRECQ enter no plan: even where plans would route the
    CPU's LayerNorms, neither hands one to the wrapper."""
    from adalog_tpu_torch.calib.calibrator import QuantCalibrator
    from adalog_tpu_torch.calib.layout import quant_layout
    from adalog_tpu_torch.recon import brecq

    spec, model = zoo.build_model("test_tiny", seed=0)
    x = np.random.default_rng(3).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    cfg = Config(**W4A4, eq_n=32, steps=2, search_round=1, fpcs=True,
                 recon_iters=5, optim_batch_size=8)
    calls = ln.layer_norm_rows.calls
    p, q = QuantCalibrator(spec, model, cfg, device="cpu").calibrate([x])
    brecq.BlockReconstructor(spec, p, model, q, quant_layout(spec, cfg), cfg,
                             device="cpu").reconstruct([x])
    assert ln.layer_norm_rows.calls == calls


def test_cpu_predictor_routes_none():
    """A CPU predictor's forward never calls the wrapper."""
    from adalog_tpu_torch.serve import make_predictor

    spec, model, qstate = _served("test_tiny_swin")
    calls = ln.layer_norm_rows.calls
    y = make_predictor(spec, model, qstate, device="cpu")(
        _images(spec).numpy())
    assert ln.layer_norm_rows.calls == calls
    assert y.shape == (2, spec.cfg.num_classes)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    p = _norm(384)
    x = torch.randn(4, 197, 384)
    calls = ln.layer_norm_rows.calls
    assert torch.equal(ln.layer_norm_rows(p, x), _old_chain(p, x))
    assert ln.layer_norm_rows.calls == calls + 1
    assert ln.layer_norm_rows.launches == 0
    with pytest.raises(RuntimeError, match="no path"):
        ln.layer_norm_rows(p, x.to("meta"))


@pytest.mark.parametrize("D,want", [(1, 4), (128, 4), (129, 8), (256, 8),
                                    (384, 16), (512, 16), (1024, 32),
                                    (1025, 128), (2048, 128), (2730, 128),
                                    (4096, 128), (4097, 512),
                                    (ln.MAX_D, 512)])
def test_threads_per_row(D, want):
    """The fewest threads that hold a row at MAX_VALS values each: within
    one warp to 1024 values, then 128 or 512."""
    assert ln.threads_per_row(D) == want
    assert D <= ln.MAX_VALS * want


def test_threads_per_row_refuses_past_max_d():
    with pytest.raises(ValueError):
        ln.threads_per_row(ln.MAX_D + 1)


@pytest.mark.parametrize("itemsize,D,rows,lda,ptr,want", [
    (4, 1024, 65600, 1024, 256, 16),   # eva02's LayerNorms
    (4, 2730, 65600, 2730, 256, 8),    # its sub-LN: rows of 10,920 bytes
    (2, 2730, 65600, 2730, 256, 4),    # bfloat16: rows of 5,460 bytes
    (2, 1024, 65600, 1024, 256, 16),
    (4, 384, 200, 197 * 384, 256, 16),  # the class token's rows, strided
    (4, 384, 200, 197 * 384 + 2, 256, 8),
    (4, 384, 1, 384, 8, 8),
    (4, 385, 1, 385, 256, 4),          # a ragged width: scalars
    (4, 386, 2, 386, 256, 8),
    (2, 385, 2, 385, 256, 2),
    (2, 128, 9, 128, 2, 2),
])
def test_unit_bytes(itemsize, D, rows, lda, ptr, want):
    """The widest load that a row's length, x's row stride, and every
    base (x, the output, the weight and bias) are multiples of."""
    assert ln.unit_bytes(itemsize, D, rows, lda, ptr, 256, 256, 256) == want


@pytest.mark.parametrize("make,want", [
    (lambda: torch.zeros(2, 5, 384), (10, 384, 384)),
    (lambda: torch.zeros(384), (1, 384, 384)),
    (lambda: torch.zeros(200, 197, 384)[:, 0], (200, 384, 197 * 384)),
    (lambda: torch.zeros(4, 6, 10)[:, :, :8], (24, 8, 10)),
    # q of (B, N, 3, H, hd) permuted to (B, H, N, hd): no single stride
    (lambda: torch.zeros(2, 5, 3, 4, 8).permute(2, 0, 3, 1, 4)[0], None),
    (lambda: torch.zeros(8, 4).t(), None),
])
def test_rows_of(make, want):
    assert ln.rows_of(make()) == want


GUARD = """
from adalog_tpu_torch.ops import cuda_build

def boom(*a, **k):
    raise AssertionError("built a kernel at import")

cuda_build.build = cuda_build.library = boom
import adalog_tpu_torch.ops.layer_norm
import adalog_tpu_torch.models.layers
import adalog_tpu_torch.ops.routes
print("built nothing")
"""


def test_import_builds_nothing():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "built nothing" in out.stdout
