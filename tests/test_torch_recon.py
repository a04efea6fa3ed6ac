"""The port's block reconstruction (adalog_tpu_torch.recon) and the training
forms of its quantizers, layers and forwards, against adalog_tpu on the CPU.

The same numpy inputs go through both packages. The starting state is one
calibration by the port (test_tiny and test_tiny_swin, a small W4A4
configuration: eq_n 32, steps 2, one search round, LayerNorm reparam),
carried to the JAX package through a v2 checkpoint, so both reconstruct
from the same model and quantizer state. The optimization set is the
calibration batch and n == optim_batch_size, so every step of both sees the
whole set (their samplers differ; a permutation of the batch changes only
the order of the sums).

Tolerances, each with the worst value measured on this CPU when it was set:
  - STE values and gradients and hard AdaRound bit for bit; AdaRound soft
    targets to SOFT_ATOL, one fp32 ulp of 1 (exp differs by an ulp between
    XLA and torch; measured 6e-8), soft-quantized weights to 8 of them
    times the scale (the sum with floor(w/s) rounds); training-mode
    gradients to GRAD_RTOL of the largest element (measured 3.8e-7 for x,
    1.5e-7 for alpha), the scale gradients to 1e-4 (measured 4.6e-6);
  - a log quantizer's scale gradient on probabilities cancels analytically
    inside the range (dq = x); both packages leave a float residue, each
    within RESIDUE_ULPS * 2^-24 * sum|g * dq| of zero (measured 0.17 of
    those units);
  - block forwards at training=True, soft=True to VALUE_RTOL (measured
    5.5e-8); block losses to VALUE_RTOL; alpha gradients to 10 GRAD_RTOL of
    each leaf's largest element (measured 5.8e-6); an activation scale's
    gradient is a sum of STE rounding residues that cancels to a small part
    of its terms, held to SCALE_GRAD_RTOL (measured up to 4.4e-4);
  - 20 iterations: first recs to VALUE_RTOL (measured 5.2e-7), last recs
    to REC_RTOL (measured 8.2e-7), but the head's: its KL is the
    difference of two sums of about log(classes) each, held to KL_ATOL
    absolute (measured 2.4e-7 on a loss of 5e-5); alphas to ALPHA_ATOL
    (measured 1.0e-5); hard decisions flip in at most FLIP_SHARE of the
    weights (measured 0); activation scales within SCALE_MOVE_SHARE of the
    most that ITERS Adam steps at A_LR can move them (measured 0.36%);
    frozen weights equal where the decisions agree.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from adalog_tpu.calib.layout import quant_layout as j_quant_layout
from adalog_tpu.calib.layout import tree_get as j_tree_get
from adalog_tpu.models import zoo as j_zoo
from adalog_tpu.quantizers import adaround as j_ada
from adalog_tpu.quantizers import apply as j_apply
from adalog_tpu.quantizers import ste as j_ste
from adalog_tpu.quantizers import state as j_state
from adalog_tpu.recon import brecq as J
from adalog_tpu.recon.blocks import block_units as j_block_units
from adalog_tpu.utils import resume as j_resume
from adalog_tpu.utils.checkpoint import load_checkpoint as j_load
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu_torch.calib.calibrator import QuantCalibrator
from adalog_tpu_torch.calib.layout import quant_layout, tree_get
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.models.layers import MatMulSite
from adalog_tpu_torch.ops import fq_attn, fq_gemm, weight_prep
from adalog_tpu_torch.quantizers import adaround as t_ada
from adalog_tpu_torch.quantizers import apply as t_apply
from adalog_tpu_torch.quantizers import ste as t_ste
from adalog_tpu_torch.quantizers import state as t_state
from adalog_tpu_torch.recon import brecq as T
from adalog_tpu_torch.recon.blocks import VIT_BLOCK_SITES, block_units
from adalog_tpu_torch.utils import resume as t_resume
from adalog_tpu_torch.utils.checkpoint import save_checkpoint
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.interop import (
    affine_from_node, affine_node, from_jax,
)

torch.set_num_threads(1)

MODELS = ("test_tiny", "test_tiny_swin")
ITERS = 20
SMALL = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4, eq_n=32, steps=2,
             search_round=1, fpcs=True, calib_size=8, calib_batch_size=8,
             recon_iters=ITERS, optim_size=8, optim_batch_size=8)
GRAD_RTOL = 1e-5
RESIDUE_ULPS = 16
VALUE_RTOL = 1e-5
REC_RTOL = 1e-4
ALPHA_ATOL = 1e-4
SOFT_ATOL = 2.0 ** -23
KL_ATOL = 1e-6
SCALE_GRAD_RTOL = 2e-3
FLIP_SHARE = 1e-3
SCALE_MOVE_SHARE = 0.05


def _images(seed, n=8):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["round_ste", "floor_ste", "ceil_ste"])
def test_ste_values_and_gradients(rng, op):
    x = (4 * rng.standard_normal((512,))).astype(np.float32)
    x[:4] = [0.5, 1.5, -2.5, 3.0]
    g = rng.standard_normal(x.shape).astype(np.float32)
    yj, gj = jax.value_and_grad(
        lambda v: jnp.sum(getattr(j_ste, op)(v) * g))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    yt = getattr(t_ste, op)(xt)
    (gt,) = torch.autograd.grad(torch.sum(yt * _t(g)), xt)
    np.testing.assert_array_equal(
        yt.detach().numpy(), np.asarray(getattr(j_ste, op)(jnp.asarray(x))))
    np.testing.assert_array_equal(gt.numpy(), np.ones_like(x) * g)
    np.testing.assert_array_equal(np.asarray(gj), gt.numpy())


def _weight_case(rng, shape=(3, 8, 16), bits=4):
    w = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    lo, hi = w.min(-1, keepdims=True), w.max(-1, keepdims=True)
    scale = ((hi - lo) / (2 ** bits - 1)).astype(np.float32)
    zp = np.round(-lo / scale).astype(np.float32)
    return w, scale, zp


def test_adaround_init_soft_hard_match_jax(rng):
    w, scale, _ = _weight_case(rng)
    aj = np.asarray(j_ada.adaround_init_alpha(jnp.asarray(w), scale))
    at = t_ada.adaround_init_alpha(_t(w), _t(scale)).numpy()
    np.testing.assert_allclose(at, aj, rtol=1e-6, atol=1e-6)
    a = aj.copy()
    a[0, 0, :4] = [0.0, -30.0, 30.0, -1e-8]
    np.testing.assert_allclose(
        t_ada.adaround_soft_targets(_t(a)).numpy(),
        np.asarray(j_ada.adaround_soft_targets(jnp.asarray(a))), rtol=0,
        atol=SOFT_ATOL)
    np.testing.assert_array_equal(
        t_ada.adaround_hard_weight(_t(w), _t(scale), _t(a)).numpy(),
        np.asarray(j_ada.adaround_hard_weight(jnp.asarray(w), scale,
                                              jnp.asarray(a))))
    # the soft target of the initial alpha is the fractional part of w/s
    rest = w / scale - np.floor(w / scale)
    np.testing.assert_allclose(
        t_ada.adaround_soft_targets(_t(aj)).numpy(), rest, atol=2e-6)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("soft", [False, True])
def test_adaround_quant_and_gradient_match_jax(rng, soft, symmetric):
    w, scale, zp = _weight_case(rng)
    alpha = np.asarray(j_ada.adaround_init_alpha(jnp.asarray(w), scale))
    alpha = alpha + rng.standard_normal(alpha.shape).astype(np.float32)
    g = rng.standard_normal(w.shape).astype(np.float32)
    kw = dict(bits=4, symmetric=symmetric, soft=soft)

    def jf(a):
        return jnp.sum(j_ada.adaround_quant(jnp.asarray(w), scale, zp, a,
                                            **kw) * g)

    vj, gj = jax.value_and_grad(jf)(jnp.asarray(alpha))
    at = _t(alpha).requires_grad_(True)
    yt = t_ada.adaround_quant(_t(w), _t(scale), _t(zp), at, **kw)
    np.testing.assert_allclose(
        yt.detach().numpy(),
        np.asarray(j_ada.adaround_quant(jnp.asarray(w), scale, zp,
                                        jnp.asarray(alpha), **kw)),
        rtol=0, atol=(SOFT_ATOL * 8 if soft else 0) * float(scale.max()))
    if not soft:       # the hard decision has no gradient in either package
        assert not yt.requires_grad and not np.asarray(gj).any()
        return
    (gt,) = torch.autograd.grad(torch.sum(yt * _t(g)), at)
    _close(gt.numpy(), gj, GRAD_RTOL, "alpha gradient")


def _act_case(rng, kind, n=(6, 9, 17, 17)):
    """(x, QuantizerState fields) of a training-mode quantizer case."""
    if kind == "uniform":
        return ((3 * rng.standard_normal(n)).astype(np.float32),
                dict(scale=np.array([0.3], np.float32),
                     zero_point=np.array([7.0], np.float32)))
    if kind == "twin":
        return ((rng.standard_normal(n)).astype(np.float32),
                dict(scale=np.array([[0.05], [0.003]], np.float32)))
    logits = 3 * rng.standard_normal(n)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    fields = dict(scale=np.array([1.0], np.float32))
    if kind == "adalog_shifted":
        x = (rng.standard_normal(n) * 0.8).astype(np.float32)
        return x, dict(scale=np.array([2.3], np.float32),
                       shift=np.array([j_state.GELU_MIN], np.float32),
                       log_q=np.asarray(23.0, np.float32),
                       bias_reparamed=np.asarray(False))
    if kind == "adalog":
        fields["log_q"] = np.asarray(29.0, np.float32)
    return p, fields


def _state_pair(kind, fields):
    static = dict(kind="adalog" if kind.startswith("adalog") else kind,
                  bits=4, shifted=kind == "adalog_shifted")
    j = j_state.QuantizerState(
        **{k: jnp.asarray(v) for k, v in fields.items()}, **static)
    t = t_state.QuantizerState(
        **{k: torch.from_numpy(np.array(v)) for k, v in fields.items()},
        **static)
    return j, t


@pytest.mark.parametrize("kind", ["uniform", "twin", "log2", "logsqrt2",
                                  "adalog", "adalog_shifted"])
def test_training_gradients_match_jax(rng, kind):
    """d/dx and d/dscale of sum(g * q(x)) at training=True, against
    jax.grad. Inside the range a log quantizer's training value is x
    itself (the STE code cancels the scale), so on probabilities at scale
    1 its scale gradient is zero up to a float residue in both packages;
    the shifted (post-GeLU) AdaLog case also has saturated elements, whose
    gradient does not cancel."""
    x, fields = _act_case(rng, kind)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jq, tq = _state_pair(kind, fields)

    def jf(xx, s):
        return jnp.sum(j_apply.apply_quantizer(
            jq.replace(scale=s), xx, training=True) * g)

    (gxj, gsj) = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                              jnp.asarray(fields["scale"]))
    xt = _t(x).requires_grad_(True)
    st = _t(fields["scale"]).requires_grad_(True)
    yt = t_apply.apply_quantizer(dataclasses.replace(tq, scale=st), xt,
                                 training=True)
    yj = np.asarray(j_apply.apply_quantizer(jq, jnp.asarray(x),
                                            training=True))
    # log codes may take the neighbouring code where log2 differs by an
    # ulp between the packages; none does at these inputs
    np.testing.assert_allclose(yt.detach().numpy(), yj, rtol=5e-6, atol=0)
    gxt, gst = torch.autograd.grad(torch.sum(yt * _t(g)), (xt, st))
    _close(gxt.numpy(), gxj, GRAD_RTOL, "x gradient")
    if kind in ("log2", "logsqrt2", "adalog"):
        bound = RESIDUE_ULPS * 2.0 ** -24 * float(np.sum(np.abs(g * yj)))
        assert abs(float(gst)) <= bound and abs(float(gsj[0])) <= bound, \
            (float(gst), float(gsj[0]), bound)
    else:
        _close(gst.numpy(), gsj, 1e-4, "scale gradient")


# ---------------------------------------------------------------------------
# schedule, losses, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [20, 100, 20000])
def test_temperature_matches_jax(iters):
    for t in sorted({1, iters // 5 - 1, iters // 5, iters // 5 + 1,
                     iters // 2, iters - 1, iters}):
        want = float(J._b_temperature(jnp.float32(t), iters))
        assert float(T._b_temperature(float(t), iters)) == want, (t, want)


@pytest.mark.parametrize("kind", ["mse", "kl"])
def test_rec_loss_matches_jax(rng, kind):
    shape = (8, 17, 32) if kind == "mse" else (8, 10)
    p = rng.standard_normal(shape).astype(np.float32)
    t = (p + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    want = float(J._rec_loss(jnp.asarray(p), jnp.asarray(t), kind))
    got = float(T._rec_loss(_t(p), _t(t), kind))
    assert abs(got - want) <= VALUE_RTOL * abs(want), (got, want)
    if kind == "kl":
        assert float(T._rec_loss(_t(p), _t(p + 1.0), kind)) < 1e-6


def test_adam_matches_optax(rng):
    """The hand-written Adam against optax's adam with the constant and the
    cosine learning rate, over 30 updates of random gradients: measured
    equal bit for bit (torch.optim.Adam, which orders the same update
    otherwise, ends 2.4e-7 apart, past the 1e-7 held here)."""
    iters = 30
    p0 = rng.standard_normal((64,)).astype(np.float32)
    grads = [rng.standard_normal((64,)).astype(np.float32) * 10.0 ** -k
             for k in range(iters)]         # shrinking past Adam's eps
    for lr_j, lr_t in ((T.W_LR, lambda k: T.W_LR),
                       (optax.cosine_decay_schedule(T.A_LR, iters, 0.0),
                        T._cosine_lr(T.A_LR, iters))):
        opt = optax.adam(lr_j)
        pj = jnp.asarray(p0)
        st = opt.init(pj)
        pt = _t(p0)
        adam = T._Adam([pt], lr_t)
        for g in grads:
            up, st = opt.update(jnp.asarray(g), st, pj)
            pj = optax.apply_updates(pj, up)
            adam.step([_t(g)])
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# one calibrated state, in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MODELS)
def state(request, tmp_path_factory):
    """The port calibrates (no post-GeLU fold, as before --optimize); the
    JAX package loads the same state from a v2 checkpoint."""
    name = request.param
    spec, jspec = zoo.model_spec(name), j_zoo.model_spec(name)
    jp = _np_tree(j_zoo.build_model(name, seed=0)[1])
    model, _ = from_jax(spec.cfg, jp)
    x = _images(1)
    cfg, jcfg = Config(**SMALL), JConfig(**SMALL)
    pc, qc = QuantCalibrator(spec, model, cfg, device="cpu").calibrate([x])
    ckpt = str(tmp_path_factory.mktemp(name) / "calibrated.ckpt")
    save_checkpoint(ckpt, pc, qc)
    jpc, jqc, _ = j_load(ckpt)
    return dict(name=name, spec=spec, jspec=jspec, jp=jp, model=model, x=x,
                cfg=cfg, jcfg=jcfg, pc=pc, qc=qc, jpc=jpc, jqc=jqc,
                layout=quant_layout(spec, cfg),
                jlayout=j_quant_layout(jspec, jcfg))


def _port_recon(s, params=None, qstate=None, **kw):
    return T.BlockReconstructor(
        s["spec"], s["pc"] if params is None else params, s["model"],
        s["qc"] if qstate is None else qstate, s["layout"], s["cfg"],
        device="cpu", **kw)


def _jax_recon(s, **kw):
    return J.BlockReconstructor(
        s["jspec"], s["jpc"], jax.tree_util.tree_map(jnp.asarray, s["jp"]),
        s["jqc"], s["jlayout"], s["jcfg"], **kw)


def _recording(recon):
    """Wrap the instance's _train_block: {unit: (trainables, rec0, rec1)}."""
    got, orig = {}, recon._train_block

    def wrapped(unit, *a, **k):
        got[unit.name] = out = orig(unit, *a, **k)
        return out

    recon._train_block = wrapped
    return got


@pytest.fixture(scope="module")
def runs(state, tmp_path_factory):
    """One ITERS-iteration reconstruction by each package, each writing a
    resume log; the JAX one ungrouped, so that every unit passes through
    its _train_block."""
    d = tmp_path_factory.mktemp(state["name"] + "_runs")
    jfile, tfile = str(d / "jax.resume"), str(d / "port.resume")
    s = dict(state, jcfg=JConfig(**SMALL, recon_block_group=1))
    jr = _jax_recon(s, resume_path=jfile)
    jtrained = _recording(jr)
    jP, jQ = jr.reconstruct([s["x"]], quant_act=True)
    tr = _port_recon(state, resume_path=tfile)
    ttrained = _recording(tr)
    tP, tQ = tr.reconstruct([s["x"]], quant_act=True)
    return dict(j=(_np_tree(jP), _np_tree(jQ)), t=(tP, tQ), jfile=jfile,
                tfile=tfile, jtrained=jtrained, ttrained=ttrained, recon=tr)


def _host(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _unit_leaves(tr):
    out = {("w", k): _host(v) for k, v in tr["w"].items()}
    for k, d in tr["a"].items():
        for kk, v in d.items():
            out[("a", k, kk)] = _host(v)
    return out


def test_capture_block_io_matches_jax(state):
    s = state
    io_j = J.capture_block_io(s["jspec"],
                              jax.tree_util.tree_map(jnp.asarray, s["jp"]),
                              [s["x"]])
    io_t = T.capture_block_io(s["spec"], s["model"], [s["x"]])
    assert set(io_t) == set(io_j)
    for nm, (a, b) in io_t.items():
        _close(a.numpy(), io_j[nm][0], VALUE_RTOL, nm)
        _close(b.numpy(), io_j[nm][1], VALUE_RTOL, nm)
    io_h = T.capture_block_io(s["spec"], s["model"], [s["x"]],
                              skip=("head",), keep_on_device=False)
    assert "head" not in io_h and all(a.device.type == "cpu"
                                      for a, _ in io_h.values())


def test_block_units_match_jax(state):
    ju, tu = j_block_units(state["jspec"]), block_units(state["spec"])
    assert [(u.name, u.canon) for u in tu] == [(u.name, u.canon) for u in ju]
    n = len(tu)
    assert n == (4 if state["name"] == "test_tiny" else 6)
    assert VIT_BLOCK_SITES == ("attn.qkv", "attn.matmul1", "attn.matmul2",
                               "attn.proj", "mlp.fc1", "mlp.fc2")
    # same-shape blocks share one forward object
    fw = [u.forward for u in tu if u.name.startswith(("blocks.", "layers."))
          and "downsample" not in u.name]
    assert len(set(fw)) == (1 if state["name"] == "test_tiny" else 2)


def test_deit_small_has_14_units():
    units = block_units(zoo.model_spec("deit_small"))
    assert len(units) == 14
    assert [u.name for u in units][:2] == ["patch_embed", "blocks.0"]
    assert units[-1].name == "head"


@pytest.fixture(scope="module")
def block(state):
    """A transformer block of each model (ViT blocks.0; Swin's shifted
    layers.1.blocks.1) in both packages on the captured block input: the
    initial trainables, and the JAX package's loss (brecq.py's loss_fn,
    term by term) with its gradient, jitted once with the step count as an
    argument."""
    s = state
    idx = 1 if s["name"] == "test_tiny" else 4
    jr, tr = _jax_recon(s), _port_recon(s)
    junit, tunit = (j_block_units(s["jspec"])[idx],
                    block_units(s["spec"])[idx])
    rin, rout = T.capture_block_io(s["spec"], s["model"],
                                   [s["x"]])[tunit.name]
    jq = {cn: jr.qstate[nm] for nm, cn in junit.canon.items()}
    jmodes = jr._site_modes(junit, True)
    jbp = junit.extract(jr.params)
    xj, yj = jnp.asarray(rin.numpy()), jnp.asarray(rout.numpy())

    def jloss(trj, cnt):
        qs = J._merge_trainables(jq, trj, True)
        pred = junit.forward(jbp, qs, xj, jmodes, True, True)
        rec_ = J._rec_loss(pred, yj, "mse")
        b = J._b_temperature(cnt, ITERS)
        rnd = 0.0
        for alpha in jax.tree_util.tree_leaves(trj["w"]):
            sft = j_ada.adaround_soft_targets(alpha)
            rnd = rnd + jnp.sum(1.0 - jnp.abs(2.0 * sft - 1.0) ** b)
        rnd = J.ROUND_WEIGHT * rnd * (cnt >= J.WARMUP * ITERS)
        return rec_ + rnd, (rec_, pred)

    return dict(
        tunit=tunit, tr=tr, rin=rin, rout=rout,
        tq={cn: tr.qstate[nm] for nm, cn in tunit.canon.items()},
        modes=tr._site_modes(tunit, True),
        jtr=jr._init_trainables(junit, True),
        jgrad=jax.jit(jax.value_and_grad(jloss, has_aux=True)))


def _block_step(b, count):
    """The port's (loss, rec, pred, grads by leaf) of one training step at
    the 1-based ``count``, and the JAX package's."""
    ttr = b["tr"]._init_trainables(b["tunit"], True)
    loss, rec = T._block_loss(b["tunit"].forward,
                              b["tunit"].extract(b["tr"].params), b["tq"],
                              ttr, b["rin"], b["rout"], b["modes"], count,
                              ITERS, True, "mse")
    leaves = list(_unit_leaves(ttr))
    tensors = [ttr["w"][k[1]] if k[0] == "w" else ttr["a"][k[1]][k[2]]
               for k in leaves]
    tg = dict(zip(leaves, torch.autograd.grad(loss, tensors,
                                              allow_unused=True)))
    (jl, (jrec, _)), jg = b["jgrad"](b["jtr"], jnp.float32(count))
    return (loss.item(), rec.item(), tg), (float(jl), float(jrec),
                                           _unit_leaves(jg))


@pytest.mark.parametrize("count", [1, 15])
def test_block_loss_and_gradients_match_jax(block, count):
    """A block at training=True, soft=True, before (count 1) and after
    (count 15 of 20) the rounding penalty starts: loss, rec and the
    gradient of every trainable against jax.value_and_grad."""
    (tl, trec, tg), (jl, jrec, jg) = _block_step(block, count)
    assert abs(trec - jrec) <= VALUE_RTOL * abs(jrec), (trec, jrec)
    assert abs(tl - jl) <= VALUE_RTOL * abs(jl), (tl, jl)
    assert (tl == trec) == (count == 1)
    for k, g in tg.items():
        want = jg[k]
        if g is None:
            assert not want.any(), k
            continue
        _close(g.numpy(), want,
               GRAD_RTOL * 10 if k[0] == "w" else SCALE_GRAD_RTOL, k)
    # the port holds every post-softmax AdaLog scale out of the trainables
    probability = [k for k in jg if k[0] == "a" and k[2] == "A"
                   and "matmul2" in k[1]]
    assert probability and not any(k in tg for k in probability)


def test_training_forward_values_match_jax(block):
    """The block's forward at training=True, soft=True with the initial
    alphas against the JAX package's."""
    b = block
    ttr = b["tr"]._init_trainables(b["tunit"], True)
    tq = T._merge_trainables(b["tq"], ttr, True)
    with torch.no_grad():
        yt = b["tunit"].forward(b["tunit"].extract(b["tr"].params), tq,
                                b["rin"], b["modes"], True, True)
    (_, (_, yj)), _ = b["jgrad"](b["jtr"], jnp.float32(1))
    _close(yt.numpy(), yj, VALUE_RTOL)


# ---------------------------------------------------------------------------
# a whole reconstruction
# ---------------------------------------------------------------------------

def test_trained_units_match_jax(state, runs):
    """ITERS steps on every unit: trained alphas (hard decisions flip in at
    most FLIP_SHARE), activation scales, first and last recs."""
    assert set(runs["ttrained"]) == set(runs["jtrained"])
    flips = total = 0
    for name, (ttr, t0, t1) in runs["ttrained"].items():
        jtr, j0, j1 = runs["jtrained"][name]
        assert abs(t0 - j0) <= VALUE_RTOL * abs(j0), (name, t0, j0)
        tol = KL_ATOL if name == "head" else REC_RTOL * abs(j1)
        assert abs(t1 - j1) <= tol, (name, t1, j1)
        tl, jl = _unit_leaves(ttr), _unit_leaves(jtr)
        for k, a in tl.items():
            b = jl[k]
            if k[0] == "w":
                flips += int(((a >= 0) != (b >= 0)).sum())
                total += a.size
                np.testing.assert_allclose(a, b, rtol=0, atol=ALPHA_ATOL,
                                           err_msg=str((name, k)))
            else:
                moved = T.A_LR * ITERS
                assert float(np.abs(a - b).max()) <= \
                    SCALE_MOVE_SHARE * moved, (name, k)
        # JAX trains the probability scale and leaves it at 1 here
        for k, b in jl.items():
            if k[0] == "a" and k[2] == "A" and "matmul2" in k[1]:
                assert k not in tl and (b == 1.0).all(), (name, k)
    assert flips <= FLIP_SHARE * total, (flips, total)


def test_reconstructed_state_matches_jax(state, runs):
    """Frozen weights (equal where the hard decisions agree), trained
    activation scales, alphas dropped, every post-softmax AdaLog scale 1,
    and the quantized logits."""
    s = state
    (tP, tQ), (jP, jQ) = runs["t"], runs["j"]
    assert set(tQ) == set(jQ)
    for nm, site in tQ.items():
        js = jQ[nm]
        if isinstance(site, MatMulSite):
            for k in ("Aq", "Bq"):
                a = getattr(site, k).scale.numpy()
                b = np.asarray(getattr(js, k).scale)
                assert float(np.abs(a - b).max()) <= \
                    SCALE_MOVE_SHARE * T.A_LR * ITERS, (nm, k)
            if site.Aq.kind == "adalog":
                assert (site.Aq.scale == 1.0).all() and (js.Aq.scale == 1.0
                                                         ).all(), nm
            continue
        assert site.wq.alpha is None and js.wq.alpha is None
        assert float(np.abs(site.aq.scale.numpy()
                            - np.asarray(js.aq.scale)).max()) <= \
            SCALE_MOVE_SHARE * T.A_LR * ITERS, nm
        w = tree_get(tP, s["layout"][nm].param_path).weight.numpy()
        jw = np.asarray(j_tree_get(jP, s["jlayout"][nm].param_path).w)
        step = np.asarray(js.wq.scale).reshape(-1).max()
        assert (np.abs(w - jw) > 1e-3 * step).mean() <= FLIP_SHARE, nm
        # hard weights sit on the scale grid
        wv = w.reshape((site.n_V, -1, w.shape[-1]) if hasattr(site, "n_V")
                       else (w.shape[0], -1))
        ratio = wv / site.wq.scale.numpy()
        np.testing.assert_allclose(ratio, np.round(ratio), atol=1e-3)


def test_recon_leaves_caller_untouched(state):
    s = state
    before = {k: v.clone() for k, v in s["pc"].state_dict().items()}
    q_before = {nm: site.aq.scale.clone() for nm, site in s["qc"].items()
                if hasattr(site, "aq")}
    # params is params_full, as the JAX package's tests pass them
    r = T.BlockReconstructor(s["spec"], s["pc"], s["pc"], s["qc"],
                             s["layout"], Config(**dict(SMALL,
                                                        recon_iters=3)),
                             device="cpu")
    p, _ = r.reconstruct([s["x"]])
    assert any(not torch.equal(v, p.state_dict()[k])
               for k, v in before.items())
    for k, v in s["pc"].state_dict().items():
        assert torch.equal(v, before[k]), k
    for nm, t in q_before.items():
        assert torch.equal(s["qc"][nm].aq.scale, t), nm


def test_grouped_equals_sequential(state):
    """recon_block_group 1 and 4 give bit-identical models and states."""
    out = []
    for group in (1, 4):
        r = _port_recon(state)
        r.cfg = Config(**dict(SMALL, recon_block_group=group))
        out.append(r.reconstruct([state["x"]]))
    (p1, q1), (p4, q4) = out
    for k, v in p1.state_dict().items():
        assert torch.equal(v, p4.state_dict()[k]), k
    for nm in q1:
        assert all(torch.equal(a, b) for a, b in zip(
            _site_tensors(q1[nm]), _site_tensors(q4[nm]))), nm


def _site_tensors(site):
    out = []
    for f in dataclasses.fields(site):
        v = getattr(site, f.name)
        if dataclasses.is_dataclass(v):
            out += _site_tensors(v)
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def test_segmented_equals_monolithic(state):
    """recon_seg_iters marks where the host reads the losses; one segment
    and 7-step segments give bit-identical results and recs."""
    out = []
    for seg in (1000, 7):
        r = _port_recon(state)
        r.cfg = Config(**dict(SMALL, recon_seg_iters=seg))
        p, q = r.reconstruct([state["x"]])
        out.append((p, q, r.unit_stats))
    (p0, q0, s0), (p1, q1, s1) = out
    for k, v in p0.state_dict().items():
        assert torch.equal(v, p1.state_dict()[k]), k
    assert {k: (v["rec_first"], v["rec_last"]) for k, v in s0.items()} == \
        {k: (v["rec_first"], v["rec_last"]) for k, v in s1.items()}


def test_group_budget_derates(state, caplog):
    r = _port_recon(state)
    r.cfg = Config(**dict(SMALL, recon_block_group=4, recon_group_bytes=1))
    with caplog.at_level("INFO", logger="adalog_tpu_torch"):
        r.reconstruct([state["x"]])
    assert any("derated 4 -> 1" in m for m in caplog.messages)
    assert len(r.unit_stats) == len(block_units(state["spec"]))


# ---------------------------------------------------------------------------
# resume, both ways
# ---------------------------------------------------------------------------

def _unit_sites(unit, q):
    return [nm for nm in unit.canon if nm in q]


def _assert_equal_port(p, q, want_p, want_q, layout, names):
    """The port's model and state equal the port's ``want_*`` exactly at
    the sites ``names``."""
    for nm in names:
        assert all(torch.equal(a, b) for a, b in zip(
            _site_tensors(q[nm]), _site_tensors(want_q[nm]))), nm
        if not isinstance(q[nm], MatMulSite):
            path = layout[nm].param_path
            assert torch.equal(tree_get(p, path).weight,
                               tree_get(want_p, path).weight), nm


def _assert_equal_jax(p, q, jP, jQ, layout, jlayout, names):
    """The port's model and state equal the JAX package's (numpy trees)
    exactly at the sites ``names``: activation scales and weights."""
    for nm in names:
        site, js = q[nm], jQ[nm]
        if isinstance(site, MatMulSite):
            for k in ("Aq", "Bq"):
                np.testing.assert_array_equal(
                    getattr(site, k).scale.numpy(),
                    np.asarray(getattr(js, k).scale), err_msg=nm)
            continue
        np.testing.assert_array_equal(site.aq.scale.numpy(),
                                      np.asarray(js.aq.scale), err_msg=nm)
        np.testing.assert_array_equal(
            tree_get(p, layout[nm].param_path).weight.numpy(),
            np.asarray(j_tree_get(jP, jlayout[nm].param_path).w),
            err_msg=nm)


def test_jax_log_resumes_port(state, runs, tmp_path):
    """The JAX package's log: its full log restores its results exactly
    (nothing is trained); half of it restores those units, and the port
    trains the rest exactly as its own uninterrupted run did."""
    s = state
    units = block_units(s["spec"])
    recs = j_resume.resume_scan(runs["jfile"])
    assert [t for t, _, _ in recs] == ["recon"] * len(units)
    jP, jQ = runs["j"]
    r = _port_recon(s, resume_path=runs["jfile"])
    p, q = r.reconstruct([s["x"]])
    assert r.unit_stats == {}
    _assert_equal_jax(p, q, jP, jQ, s["layout"], s["jlayout"], list(q))

    part = str(tmp_path / "part.resume")
    j_resume.resume_append(part, recs[:2])
    done = {name for _, name, _ in recs[:2]}
    r = _port_recon(s, resume_path=part)
    p, q = r.reconstruct([s["x"]])
    assert set(r.unit_stats) == {u.name for u in units} - done
    tP, tQ = runs["t"]
    for u in units:
        if u.name in done:
            _assert_equal_jax(p, q, jP, jQ, s["layout"], s["jlayout"],
                              _unit_sites(u, q))
        else:
            _assert_equal_port(p, q, tP, tQ, s["layout"], _unit_sites(u, q))
    # the port appended its records after the JAX package's two
    assert len(t_resume.resume_scan(part)) == len(units)


def test_port_log_resumes_jax(state, runs, tmp_path):
    """The port's log: half of it restores those units in the JAX package
    exactly, which then trains the rest as its own uninterrupted run did."""
    s = state
    units = block_units(s["spec"])
    recs = t_resume.resume_scan(runs["tfile"])
    assert [t for t, _, _ in recs] == ["recon"] * len(units)
    part = str(tmp_path / "part.resume")
    t_resume.resume_append(part, recs[:2])
    done = {name for _, name, _ in recs[:2]}
    jr = _jax_recon(dict(s, jcfg=JConfig(**SMALL, recon_block_group=1)),
                    resume_path=part)
    trained = _recording(jr)
    jP, jQ = _np_tree(jr.reconstruct([s["x"]], quant_act=True))
    assert set(trained) == {u.name for u in units} - done
    tP, tQ = runs["t"]
    wP, wQ = runs["j"]
    for u in units:
        names = _unit_sites(u, tQ)
        if u.name in done:       # carried from the port's log, exactly
            _assert_equal_jax(tP, tQ, jP, jQ, s["layout"], s["jlayout"],
                              names)
            continue
        for nm in names:         # trained again, as the JAX run did
            for a, b in zip(jax.tree_util.tree_leaves(jQ[nm]),
                            jax.tree_util.tree_leaves(wQ[nm])):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=1e-6, atol=1e-7, err_msg=nm)
            if not isinstance(tQ[nm], MatMulSite):
                path = s["jlayout"][nm].param_path
                np.testing.assert_allclose(
                    np.asarray(j_tree_get(jP, path).w),
                    np.asarray(j_tree_get(wP, path).w), rtol=1e-6,
                    atol=1e-7, err_msg=nm)


def test_affine_nodes_round_trip(state):
    lin = tree_get(state["pc"], state["layout"][
        "head" if state["name"] == "test_tiny" else "head.fc"].param_path)
    conv = tree_get(state["pc"], ("patch_embed", "proj"))
    for m in (lin, conv):
        node = affine_node(m)
        assert node.dc == ("ConvP" if m is conv else "LinearP")
        back = affine_from_node(m, node)
        assert back is not m and torch.equal(back.weight, m.weight)
        assert torch.equal(back.bias, m.bias)
    node = affine_node(lin)
    node.fields["b"] = None
    assert affine_from_node(lin, node).bias is None and lin.bias is not None


# ---------------------------------------------------------------------------
# no kernel in training; entry points
# ---------------------------------------------------------------------------

def test_training_dispatches_no_kernel(state):
    """Inside every kernel context a serving forward enters (weight prep,
    the GEMM table, the attention kernels), a reconstruction calls no
    kernel wrapper: the training forwards take the plain ops."""
    s = state
    qs = s["qc"]
    wrappers = (fq_attn.fq_flash_attn, fq_attn.fq_softmax_attn_matmul,
                fq_attn.fq_attn_matmul, fq_gemm.fq_gemm)
    before = [w.calls for w in wrappers]
    r = _port_recon(s)
    r.cfg = Config(**dict(SMALL, recon_iters=3))
    wprep = weight_prep.prepare(s["spec"], r.params, r.qstate, r.cfg)
    with weight_prep.activate(wprep), \
            fq_attn.activate(True, True, fq_attn.prepare(r.qstate)), \
            fq_gemm.activate(fq_gemm.prepare(r.qstate)):
        # the eval forward in the same contexts does reach the kernels
        zoo.model_forward_fn(s["spec"])(s["spec"].cfg, r.params,
                                        torch.from_numpy(s["x"]), qs,
                                        {"*": "quant"})
        mid = [w.calls for w in wrappers]
        r.reconstruct([s["x"]])
    assert sum(mid) > sum(before)
    assert [w.calls for w in wrappers] == mid


def test_entry_points():
    spec, model = zoo.build_model("test_tiny", seed=0)
    cfg = Config(**SMALL)
    lay = quant_layout(spec, cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.BlockReconstructor(spec, model, model, {}, lay, cfg)
    with pytest.raises(NotImplementedError):
        T.BlockReconstructor(spec, model, model, {}, lay, cfg, mesh=object(),
                             device="cpu")


def test_finish_calibration_leaves_calibrate_result():
    """The (model, qstate) calibrate returns are not changed by a later
    finish_calibration, so reconstruction can start from them."""
    spec, model = zoo.build_model("test_tiny", seed=0)
    c = QuantCalibrator(spec, model, Config(**SMALL), device="cpu")
    p, q = c.calibrate([_images(3)])
    fc2 = {nm: site.aq.bias_reparamed.clone() for nm, site in q.items()
           if nm.endswith("fc2")}
    bias = {k: v.clone() for k, v in p.state_dict().items()}
    p2, q2 = c.finish_calibration()
    assert q2 is not q and all(not bool(q[nm].aq.bias_reparamed) and
                               bool(q2[nm].aq.bias_reparamed) for nm in fc2)
    for k, v in p.state_dict().items():
        assert torch.equal(v, bias[k]), k
    assert any(not torch.equal(v, p2.state_dict()[k])
               for k, v in p.state_dict().items())
