"""W3A3 and W6A6, the widths of the shipped configs/3bit.py and
configs/6bit.py: the port against adalog_tpu on the CPU, at test_tiny and
test_tiny_swin.

Both packages calibrate the same batch at a small configuration (eq_n 32,
steps 2, one search round, FPCS, LayerNorm reparam, post-GeLU AdaLog,
head-wise matmuls) with every bit width of a shipped config: w, a and s
bits 3 or 6, qhead_a_bit the same, qconv_a_bit 8. Held, site by site and as
tests/test_torch_calib_e2e.py holds W4A4: kinds, bits and flags equal;
integer picks (zero points, AdaLog bases) exact or adjacent, the adjacent
share reported; scales to SCALE_RTOL; the reparameterized model's tensors to
PARAM_RTOL of each tensor's largest value; the quantized logits to
LOGIT_TOL. Then one short BRECQ from the port's state (carried to the JAX
package by a v2 checkpoint) on tests/test_torch_recon.py's gates, and the
kernels' plain versions on the JAX package's calibrated state: the served
logits through K1, K2, K3 (attention), K4 (every Linear site, the AdaLog
fc2 sites at 3 and 6 bits among them) and K5 (int8 codes at 3 and 6 bits)
against the JAX package's unfused quantized logits, and K1 and K4 against
its Pallas kernels (interpret mode) on one site each.

The grids. The JAX package builds its candidate grids inside jit, where
XLA's CPU code contracts a product that feeds an add into a fused
multiply-add, turns a division by a constant into a product with its
float32 reciprocal and folds constant percentiles; the port computes the
same values (calib/candidates.py: ``xla_fma``, ``xla_div``, ``quantile``
with the lo product fused, ``_grid``'s ``self_delta``). Before that, a
grid point could lie one float32 ulp from JAX's at every bit width, and at
these widths that moved picks: test_tiny_swin at W6A6 took a weight zero
point 8 steps from JAX's (layers.1.blocks.1.mlp.fc1, a tie between
candidates that quantize the row alike, broken by the order of survivors
one ulp apart), and test_tiny at W6A6 moved the quantized logits at 12.5%
of positions.

What is left are near-ties, traced by both packages' FPCS scores on their
own captures (every candidate of every step; "ahead by" in float32 ulps of
the score, higher is better). This file's numbers (eq_n 32) have one:
  - test_tiny W3A3, blocks.1.mlp.fc2, weight row 1: the weight output-MSE
    FPCS (post-GeLU family, round 1, its last step) ranks candidates 1
    (scale 0.013402404) and 0 (0.012338655), both at zero point 4. Scores:
    JAX 0.028334796 and 0.028332505 (1 ahead by 1230 ulp, 8.1e-5
    relative), the port 0.02832938 and 0.028329484 (0 ahead by 56 ulp).
    The two packages' scores of one candidate differ by 2908 ulp (1.9e-4
    relative), more than the gap: the site's captured input differs
    between the packages by up to 7.45e-8 in 12566 of 17408 entries (the
    order of the forward's fp32 sums), and its AdaLog codes at 3 bits carry
    that into the score. Given JAX's capture, the port picks JAX's
    candidate, with grids bit-equal at every step. The weight scale of that
    row moves 7.9% and the folded fc2 bias entry of the row 13.7%; the
    quantized logits stay within LOGIT_TOL (measured 1.75e-7 of their
    largest value).
At eq_n 64 (same seeds, not run here) four more, none a port fault:
  - W3A3 blocks.1.mlp.fc2 row 16, the same step: JAX ahead by 1084 ulp,
    the port the other way by 866; one candidate's score differs by 6117
    ulp between the packages (capture noise through the AdaLog codes);
  - W3A3 blocks.0.mlp.fc1 row 125, the default Linear family's weight
    output-MSE FPCS, last step: JAX ahead by 3 ulp, the port the other way
    by 2 (scale 1.0%, zero point equal);
  - W6A6 blocks.0.mlp.fc1 row 110, zero point 27 against 28 (adjacent):
    at the first step of the same FPCS the two, at one scale, score equal
    in JAX and 1 ulp apart in the port; at the refined scale the zero
    points quantize the row alike (exact ties) and the survivors' order
    picks;
  - W6A6 blocks.1.attn.matmul1, B of head 0 (scale 7.0%, zero point 30
    against 31): the matmul family's B FPCS, its last step: JAX ahead by
    32086 ulp (0.37%), the port the other way by 15092; the candidate
    JAX ranks second has a scale one ulp apart between the packages (its
    grid comes from quantiles of the two captures) and a score 0.55%
    apart: at that scale a rounding of one B element flips.
Measured over the four cases: of 2946 scale entries of the sites whose
integer picks all agree, 1 past SCALE_RTOL (MOVED_SHARE bounds the share);
of 2932 integer picks, 0 adjacent. The reparameterized tensors are held
but for the rows whose weight scale moved (at most one, that one).
"""

import dataclasses
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adalog_tpu.calib.calibrator import QuantCalibrator as JQuantCalibrator
from adalog_tpu.calib.layout import quant_layout as j_quant_layout
from adalog_tpu.models import zoo as j_zoo
from adalog_tpu.ops import fq_attn as jfa
from adalog_tpu.ops import fq_gemm as jfg
from adalog_tpu.ops import int8_linear as j_int8
from adalog_tpu.recon import brecq as J
from adalog_tpu.serve import make_predictor as j_make_predictor
from adalog_tpu.utils.checkpoint import load_checkpoint as j_load
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu_torch.calib.calibrator import QuantCalibrator
from adalog_tpu_torch.calib.layout import quant_layout, tree_get
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.models.layers import LinearSite, MatMulSite
from adalog_tpu_torch.ops import fq_attn, fq_gemm, int8_linear, routes
from adalog_tpu_torch.recon import brecq as T
from adalog_tpu_torch.serve import make_predictor
from adalog_tpu_torch.utils.checkpoint import save_checkpoint
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.interop import from_jax, qstate_from_tree
from test_torch_recon import (
    ALPHA_ATOL, FLIP_SHARE, KL_ATOL, REC_RTOL, SCALE_MOVE_SHARE, VALUE_RTOL,
    _recording, _unit_leaves,
)

torch.set_num_threads(1)

BITS = (3, 6)
MODELS = ("test_tiny", "test_tiny_swin")
ITERS = 5
SCALE_RTOL = 1e-5
PARAM_RTOL = 1e-5
LOGIT_TOL = 1e-5
MOVED_SHARE = 0.01
ADJACENT_SHARE = 0.1
JOINT_RTOL = 5e-7          # four float32 ulps of the joint grid's scales
INTEGER_FIELDS = ("zero_point", "log_q")
COUNTS = {"picks": 0, "adjacent": 0, "scales": 0, "moved": 0}


def _small(bits):
    return dict(w_bit=bits, a_bit=bits, s_bit=bits, qhead_a_bit=bits,
                qconv_a_bit=8, eq_n=32, steps=2, search_round=1, fpcs=True,
                calib_size=8, calib_batch_size=8, recon_iters=ITERS,
                optim_size=8, optim_batch_size=8)


def _images(seed, n=8):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


CASES = [(m, b) for b in BITS for m in MODELS]


def _jax_calibration(case, jp, x):
    """The JAX package's calibration of one case: (params, qstate)."""
    name, bits = case
    jc = JQuantCalibrator(j_zoo.model_spec(name),
                          jax.tree_util.tree_map(jnp.asarray, jp),
                          JConfig(**_small(bits)))
    jc.calibrate([x])
    return tuple(_np_tree(t) for t in jc.finish_calibration())


def _jax_recon(case, jp, x, ckpt):
    """The JAX package's ITERS-step BRECQ of one case from the port's state
    in ``ckpt``, ungrouped, so that every unit passes its _train_block:
    {unit: trained}."""
    name, bits = case
    jspec = j_zoo.model_spec(name)
    jpc, jqc, _ = j_load(ckpt)
    jcfg = JConfig(**_small(bits), recon_block_group=1)
    jr = J.BlockReconstructor(jspec, jpc,
                              jax.tree_util.tree_map(jnp.asarray, jp), jqc,
                              j_quant_layout(jspec, jcfg), jcfg)
    trained = _recording(jr)
    jr.reconstruct([x], quant_act=True)
    return {k: (_np_tree(tr), r0, r1) for k, (tr, r0, r1) in trained.items()}


# the FPCS grids: (search function, bits) on small inputs from a seed, at
# eq_n 64 and steps 3 (four children a survivor and two refine steps, so
# the refine's products and the shrinking delta are exercised)
GRID_CASES = [(fn, b) for b in BITS
              for fn in ("search_linear_default",
                         "search_linear_postgelu_adalog")]
GRID_KW = dict(n_V=1, eq_n=64, steps=3, rounds=1, use_fpcs=True)


def _grid_args(fn, bits):
    """(args, kwargs) of one search, as numpy: x (96, 24) normal or
    post-GeLU-like, w (40, 24), b, y = x wT + b (and the GeLU shift)."""
    from adalog_tpu_torch.quantizers.state import GELU_MIN

    rng = np.random.default_rng(10 + bits)
    x = rng.standard_normal((96, 24))
    if fn.endswith("postgelu_adalog"):
        x = np.maximum(x, 0) + GELU_MIN * np.exp(-x * x)
    w = 0.2 * rng.standard_normal((40, 24))
    b = 0.1 * rng.standard_normal(40)
    args = [a.astype(np.float32) for a in (x, x @ w.T + b, w, b)]
    if fn.endswith("postgelu_adalog"):
        args.append(np.float32(GELU_MIN))
    return args, dict(GRID_KW, w_bits=bits, a_bits=bits)


def _jax_grids(fn, bits):
    """Every candidate grid the JAX package's jitted search ``fn`` scores,
    in order, with its scores: [(scales, zero points, scores)], read by a
    callback from inside its FPCS."""
    import adalog_tpu.calib.search as JS

    args, kw = _grid_args(fn, bits)
    rec, real = [], JS.fpcs

    def traced(score2d, scales, zps, **k):
        def score(s, z):
            sims = score2d(s, z)
            jax.debug.callback(lambda *t: rec.append(tuple(map(np.asarray,
                                                               t))),
                               s, z, sims, ordered=True)
            return sims
        return real(score, scales, zps, **k)

    JS.fpcs = traced
    try:
        impl = getattr(JS, fn).__wrapped__
        jax.block_until_ready(jax.jit(lambda *a: impl(*a, **kw))(
            *[jnp.asarray(a) for a in args]))
        jax.effects_barrier()
    finally:
        JS.fpcs = real
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the port's calibration (and its state before the
    post-GeLU fold, saved for the JAX package's BRECQ), then the JAX
    package's calibrations and reconstructions in four processes (most of
    their time is tracing and compiling, much of it under the GIL), then
    the port's reconstructions."""
    x = _images(1)
    d = tmp_path_factory.mktemp("bits")
    out = {}
    for name, bits in CASES:
        spec = zoo.model_spec(name)
        jp = _np_tree(j_zoo.build_model(name, seed=0)[1])
        model, _ = from_jax(spec.cfg, jp)
        small = _small(bits)
        tc = QuantCalibrator(spec, model, Config(**small), device="cpu")
        prefold = tc.calibrate([x])
        ckpt = str(d / f"{name}_{bits}.ckpt")
        save_checkpoint(ckpt, *prefold)
        out[name, bits] = dict(
            name=name, bits=bits, small=small, spec=spec, jp=jp, x=x,
            model=model, prefold=prefold, t=tc.finish_calibration(),
            layout=tc.layout, ckpt=ckpt)
    with ProcessPoolExecutor(4, mp_context=mp.get_context("spawn")) as pool:
        cal = {c: pool.submit(_jax_calibration, c, out[c]["jp"], x)
               for c in CASES}
        rec = {c: pool.submit(_jax_recon, c, out[c]["jp"], x, out[c]["ckpt"])
               for c in CASES}
        grids = {c: pool.submit(_jax_grids, *c) for c in GRID_CASES}
        for c in CASES:
            out[c].update(j=cal[c].result(), jtrained=rec[c].result())
        out["grids"] = {c: grids[c].result() for c in GRID_CASES}
    for r in (out[c] for c in CASES):
        cfg = Config(**r["small"])
        tr = T.BlockReconstructor(r["spec"], *r["prefold"][:1], r["model"],
                                  r["prefold"][1],
                                  quant_layout(r["spec"], cfg), cfg,
                                  device="cpu")
        r["ttrained"] = _recording(tr)
        r["recon"] = tr.reconstruct([x], quant_act=True)
    return out


@pytest.mark.parametrize("fn,bits", GRID_CASES)
def test_fpcs_grids_equal_jax_bit_for_bit(runs, fn, bits):
    """The candidate grids of a search against the ones the JAX package's
    jitted search scores, bit for bit (calib/candidates.py's XLA
    arithmetic; before it, a grid point could lie one ulp off at every
    width, and at 3 and 6 bits that moved picks, the module docstring):
    every percentile grid (the first step of each FPCS), and each refine
    step's grid of every unit whose survivors the two packages ranked in
    the same order at the step before (float sums may reorder a near-tie,
    and the order decides the next grid's layout); at least half the units
    are compared at every step but the joint FPCS's. The post-GeLU joint
    grid (16 scales interpolated between two percentiles, times 8 bases)
    and its refine steps within JOINT_RTOL: XLA folds its constant
    fraction by division in one program and otherwise in another
    (measured: test_tiny's and test_tiny_swin's calibrations differ), so
    no single order of operations equals it everywhere."""
    import adalog_tpu_torch.calib.search as TS

    args, kw = _grid_args(fn, bits)
    rec, real = [], TS.fpcs

    def traced(score2d, scales, zps, **k):
        first = [True]

        def score(s, z):
            sims = score2d(s, z)
            rec.append((first[0], s.numpy().copy(), z.numpy().copy(),
                        sims.numpy().copy()))
            first[0] = False
            return sims
        return real(score, scales, zps, **k)

    TS.fpcs = traced
    try:
        with torch.no_grad():
            getattr(TS, fn)(*[torch.from_numpy(np.array(a)) if np.ndim(a)
                              else float(a) for a in args], **kw)
    finally:
        TS.fpcs = real
    want = runs["grids"][fn, bits]
    assert len(rec) == len(want) > 6
    units = joint = None
    for i, ((first, s, z, sims), (ws, wz, wsims)) in enumerate(
            zip(rec, want)):
        E = ws.shape[0]
        s, z, ws, wz = (a.reshape(E, -1) for a in (s, z, ws, wz))
        if first:
            units, joint = np.arange(s.shape[1]), E == 2 * kw["eq_n"]
        assert joint or len(units) >= 0.5 * s.shape[1], (i, len(units))
        np.testing.assert_array_equal(z[:, units], wz[:, units], f"step {i}")
        if joint:
            np.testing.assert_allclose(s[:, units], ws[:, units],
                                       rtol=JOINT_RTOL, err_msg=f"step {i}")
        else:
            np.testing.assert_array_equal(s[:, units], ws[:, units],
                                          f"step {i}")
        width = 32 if joint else 16
        top = np.argsort(-sims.reshape(E, -1), axis=0, kind="stable")[:width]
        w_top = np.argsort(-wsims.reshape(E, -1), axis=0,
                           kind="stable")[:width]
        units = np.intersect1d(units, np.nonzero((top == w_top).all(0))[0])


@pytest.fixture(params=CASES, ids=lambda p: f"{p[0]}-w{p[1]}a{p[1]}")
def both(request, runs):
    """One case: both packages' calibrations of one model at one width, on
    the same weights and batch, and their reconstructions."""
    return runs[request.param]


def _fields(site, prefix=""):
    for f in dataclasses.fields(site):
        v = getattr(site, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def _compare_sites(got: dict, want: dict):
    """Site by site, as chip_smoke.compare_qstates: flags and kinds equal,
    integer picks exact or adjacent, the scales of each site whose picks
    all agree within SCALE_RTOL. Returns (counts, the sites with a scale
    past it or an adjacent pick)."""
    assert set(got) == set(want)
    n = dict(picks=0, adjacent=0, scales=0, moved=0)
    moved = set()
    for name in want:
        a, b = dict(_fields(got[name])), dict(_fields(want[name]))
        assert a.keys() == b.keys(), name
        agree, scales = True, []
        for k, va in a.items():
            vb = b[k]
            if not isinstance(va, torch.Tensor):
                assert va == vb, (name, k)
                continue
            assert va.shape == vb.shape and va.dtype == vb.dtype, (name, k)
            if va.dtype == torch.bool:
                assert torch.equal(va, vb), (name, k)
            elif k.split(".")[-1] in INTEGER_FIELDS:
                d = (va - vb).abs()
                assert bool((d <= 1).all()), (name, k, va, vb)
                n["picks"] += d.numel()
                n["adjacent"] += int((d != 0).sum())
                agree = agree and not bool((d != 0).any())
            else:
                scales.append((va.double(), vb.double()))
        if not agree:
            moved.add(name)
            continue
        for va, vb in scales:
            rel = (va - vb).abs() / vb.abs().clamp(min=1e-30)
            n["scales"] += rel.numel()
            past = int((rel > SCALE_RTOL).sum())
            n["moved"] += past
            if past:
                moved.add(name)
    return n, moved


def test_sites_match_jax(both):
    n, _ = _compare_sites(both["t"][1], qstate_from_tree(both["j"][1]))
    for k in COUNTS:
        COUNTS[k] += n[k]
    assert set(both["t"][1]) == set(both["layout"])
    assert n["moved"] <= MOVED_SHARE * n["scales"], n
    assert n["adjacent"] <= ADJACENT_SHARE * n["picks"], n


def test_bit_widths_reach_every_site(both):
    """Every site carries the config's widths: w and a bits, s bits on the
    attention matmuls' A operand, qhead_a_bit on the head, 8 on the
    patch embedding's input."""
    bits = both["bits"]
    for name, site in both["t"][1].items():
        if isinstance(site, MatMulSite):
            assert (site.Aq.bits, site.Bq.bits) == (bits, bits), name
        else:
            assert site.wq.bits == bits, name
            want = 8 if name.startswith("patch_embed") else bits
            assert site.aq.bits == want, name


def _moved_rows(both):
    """{Linear param path: the output rows whose weight scale moved} of the
    sites that moved on a near-tie (the docstring)."""
    got, want = both["t"][1], qstate_from_tree(both["j"][1])
    _, moved = _compare_sites(got, want)
    out = {}
    for nm in moved:
        a, b = got[nm].wq.scale.double(), want[nm].wq.scale.double()
        rows = ((a - b).abs() > SCALE_RTOL * b.abs()).reshape(-1)
        out[".".join(map(str, both["layout"][nm].param_path))] = rows
    return out


def test_reparameterized_model_matches_jax(both):
    """The folded LayerNorms, the rescaled qkv / fc1 weights and biases and
    the fc2 biases with the GeLU shift folded in; of a site that moved on a
    near-tie (the docstring), the rows whose weight scale moved are left
    out, and only those."""
    moved = _moved_rows(both)
    assert sum(int(r.sum()) for r in moved.values()) <= 1
    model_j, _ = from_jax(both["spec"].cfg, both["j"][0])
    want = model_j.state_dict()
    for k, v in both["t"][0].state_dict().items():
        w, v = want[k].numpy(), v.numpy()
        rows = moved.get(k.rsplit(".", 1)[0])
        keep = slice(None) if rows is None else ~rows.numpy()
        np.testing.assert_allclose(v[keep], w[keep], rtol=PARAM_RTOL,
                                   atol=PARAM_RTOL * np.abs(w).max(),
                                   err_msg=k)


def _quant(spec, model, qstate, x, modes=None, capture=False):
    with torch.no_grad():
        out = zoo.model_forward_fn(spec)(
            spec.cfg, model, torch.from_numpy(x), qstate,
            modes or {"*": "quant"}, capture=capture)
    return (out[0] if capture else out).numpy()


def test_quantized_logits_match_jax(both):
    spec, x = both["spec"], _images(2)
    model_j, q_j = from_jax(spec.cfg, *both["j"])
    want = _quant(spec, model_j, q_j, x)
    got = _quant(spec, *both["t"], x)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_shares_reported(both):
    print(f"so far: {COUNTS['picks']} integer picks, {COUNTS['adjacent']} "
          f"adjacent; {COUNTS['scales']} scales of agreeing sites, "
          f"{COUNTS['moved']} past SCALE_RTOL")
    assert COUNTS["adjacent"] <= ADJACENT_SHARE * max(1, COUNTS["picks"])
    assert COUNTS["moved"] <= MOVED_SHARE * max(1, COUNTS["scales"])


# ---------------------------------------------------------------------------
# a short BRECQ from the port's state
# ---------------------------------------------------------------------------

def test_brecq_matches_jax(both):
    """ITERS steps a unit by each package from the port's calibrated state
    before the fold (n == batch, so every step sees the whole set): first
    and last recs, but the head's KL, a difference of two sums of about
    log(classes) each, to KL_ATOL absolute (at six bits it is 5e-7);
    trained alphas (hard decisions flip in at most FLIP_SHARE), activation
    scales within SCALE_MOVE_SHARE of the most ITERS Adam steps can move
    them; the state keeps its widths."""
    assert set(both["ttrained"]) == set(both["jtrained"])
    flips = total = 0
    for name, (ttr, t0, t1) in both["ttrained"].items():
        jtr, j0, j1 = both["jtrained"][name]
        if name == "head":
            assert abs(t0 - j0) <= KL_ATOL and abs(t1 - j1) <= KL_ATOL, \
                (t0, j0, t1, j1)
        else:
            assert abs(t0 - j0) <= VALUE_RTOL * abs(j0), (name, t0, j0)
            assert abs(t1 - j1) <= REC_RTOL * abs(j1), (name, t1, j1)
        tl, jl = _unit_leaves(ttr), _unit_leaves(jtr)
        for k, a in tl.items():
            b = jl[k]
            if k[0] == "w":
                flips += int(((a >= 0) != (b >= 0)).sum())
                total += a.size
                np.testing.assert_allclose(a, b, rtol=0, atol=ALPHA_ATOL,
                                           err_msg=str((name, k)))
            else:
                assert float(np.abs(a - b).max()) <= \
                    SCALE_MOVE_SHARE * T.A_LR * ITERS, (name, k)
    assert flips <= FLIP_SHARE * total, (flips, total)
    _, tQ = both["recon"]
    for nm, site in tQ.items():
        if isinstance(site, LinearSite):
            assert site.wq.bits == both["bits"] and site.wq.alpha is None


# ---------------------------------------------------------------------------
# the kernels' plain versions on the JAX package's calibrated state
# ---------------------------------------------------------------------------

@pytest.fixture
def served(both):
    """JAX's calibrated (folded) state in both packages, and JAX's
    unfused quantized logits of a held-out batch."""
    spec, x = both["spec"], _images(3, 4)
    model, tq = from_jax(spec.cfg, *both["j"])
    return dict(model=model, tq=tq, x=x, want=_quant(spec, model, tq, x))


def _blocks(spec):
    return sum(spec.cfg.depths) if hasattr(spec.cfg, "depths") else \
        spec.cfg.depth


def _linear_sites(tq):
    return [nm for nm, s in tq.items() if isinstance(s, LinearSite)]


def _counting(wrapper, fn):
    before = wrapper.calls
    out = fn()
    return out, wrapper.calls - before


@pytest.mark.parametrize("path", ["K1", "K2", "K3", "K4", "K5"])
def test_kernel_paths_match_jax(both, served, path):
    """The served forward with each kernel's plain version on the JAX
    state: K1 (the fused attention) on every block, K2 with every matmul1
    raw (against JAX's forward with the same modes), K3 in a quant forward
    with capture, K4 on every Linear site, K5 on every int8 site (the
    AdaLog fc2 sites stay fake-quant)."""
    spec, model, tq, x = both["spec"], served["model"], served["tq"], \
        served["x"]
    want, n_blocks = served["want"], _blocks(spec)
    plan = routes.build(spec, model, tq, use_gemm_kernels=path == "K4")
    if path == "K1":
        with routes.activate(plan):
            got, n = _counting(fq_attn.fq_flash_attn,
                               lambda: _quant(spec, model, tq, x))
        assert n == n_blocks
    elif path == "K2":
        modes = {"*": "quant", **{nm: "raw" for nm in tq
                                  if nm.endswith("matmul1")}}
        j_model, j_q = from_jax(spec.cfg, *both["j"])
        want = _quant(spec, j_model, j_q, x, modes)
        with routes.activate(plan):
            got, n = _counting(fq_attn.fq_softmax_attn_matmul,
                               lambda: _quant(spec, model, tq, x, modes))
        assert n == n_blocks
    elif path == "K3":
        with routes.activate(plan):
            got, n = _counting(fq_attn.fq_attn_matmul,
                               lambda: _quant(spec, model, tq, x,
                                              capture=True))
        assert n == 2 * n_blocks
    elif path == "K4":
        table = {nm: r.gemm for nm, r in plan.linear.items()
                 if r.kind == "fq_gemm"}
        assert len(table) == len(_linear_sites(tq))
        fc2 = {nm for nm, s in table.items() if s.kind == "adalog_shift"}
        assert fc2 and all(nm.endswith("fc2") for nm in fc2)
        assert all(s.bits == both["bits"] for nm, s in table.items()
                   if not nm.startswith("patch_embed"))
        with routes.activate(plan):
            got, n = _counting(fq_gemm.fq_gemm,
                               lambda: _quant(spec, model, tq, x))
        assert n == len(table)
    else:
        cfg = Config(**both["small"])
        j_int8.set_enabled(True)
        try:
            jspec, jparams = j_zoo.model_spec(both["name"]), \
                jax.tree_util.tree_map(jnp.asarray, both["j"][0])
            jq = jax.tree_util.tree_map(jnp.asarray, both["j"][1])
            prep = j_int8.prepare(jspec, jparams, jq, JConfig(**both["small"]))
            want = np.asarray(j_make_predictor(
                jspec, jparams, jq, int8_prep=prep,
                cfg=JConfig(**both["small"]))(jnp.asarray(x)))
        finally:
            j_int8.set_enabled(False)
        predict = make_predictor(spec, model, tq, cfg=cfg, use_int8=True,
                                 use_gemm_kernels=True, device="cpu")
        got, n = _counting(int8_linear.int8_gemm, lambda: predict(x).numpy())
        assert n == len(prep) and len(prep) >= 4
        plan = routes.build(spec, model, tq, cfg, use_int8=True)
        assert set(prep) == {nm for nm, r in plan.linear.items()
                             if r.kind == "int8"}
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_k4_on_the_adalog_fc2_site_matches_jax_kernel(both, served):
    """K4's plain version on the calibrated AdaLog fc2 site of the first
    block, its entry as the plan builds it, against the JAX package's
    Pallas fq_gemm (interpret mode) with the site's parameters."""
    tq, model = served["tq"], served["model"]
    name = next(nm for nm in tq if nm.endswith("mlp.fc2"))
    entry = fq_gemm.gemm_site(name, tq[name])
    jsite = both["j"][1][name]
    jparams = np.asarray(jfg.site_params(jax.tree_util.tree_map(
        jnp.asarray, jsite.aq)))
    np.testing.assert_array_equal(entry.params.numpy(), jparams)
    assert entry.kind == "adalog_shift" and entry.bits == both["bits"]
    w = tree_get(model, both["layout"][name].param_path).weight.detach()
    rng = np.random.default_rng(both["bits"])
    x = (np.abs(rng.standard_normal((40, w.shape[1]))) * 0.5
         - 0.17).astype(np.float32)
    jfg.INTERPRET = True
    try:
        want = np.asarray(jfg.fq_gemm(jnp.asarray(x), jnp.asarray(w.numpy()).T,
                                      jnp.asarray(jparams),
                                      kind="adalog_shift", bits=both["bits"]))
    finally:
        jfg.INTERPRET = False
    got = fq_gemm.run(entry, torch.from_numpy(x), w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_k1_on_calibrated_sites_matches_jax_kernel(both, served):
    """K1's plain version on the first block's calibrated matmul sites (the
    post-softmax AdaLog base at s_bit 3 or 6) against the JAX package's
    Pallas fq_flash_attn (interpret mode)."""
    tq = served["tq"]
    m1 = next(nm for nm in tq if nm.endswith("attn.matmul1"))
    m2 = m1[:-1] + "2"
    assert tq[m2].Aq.kind == "adalog" and tq[m2].Aq.bits == both["bits"]
    H = tq[m1].Aq.scale.numel()
    rng = np.random.default_rng(7)
    N, S, D = 2, 17, 8
    q, v = (rng.standard_normal((2, N, H, S, D))).astype(np.float32)
    kT = rng.standard_normal((N, H, D, S)).astype(np.float32)
    got = fq_attn.run_flash(tq[m1], tq[m2], torch.from_numpy(q),
                            torch.from_numpy(kT), torch.from_numpy(v),
                            logit_scale=D ** -0.5).numpy()
    args, bits = fq_attn.flash_args(tq[m1], tq[m2], torch.from_numpy(q),
                                    torch.from_numpy(kT),
                                    torch.from_numpy(v))
    jfa.INTERPRET = True
    try:
        want = np.asarray(jfa.fq_flash_attn(
            *[jnp.asarray(a.numpy()) for a in args], None,
            logit_scale=D ** -0.5, **bits))
    finally:
        jfa.INTERPRET = False
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-5,
                               atol=1e-5)
