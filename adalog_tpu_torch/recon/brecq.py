"""BRECQ / AdaRound block reconstruction, the counterpart of
``adalog_tpu.recon.brecq``.

Per block unit (recon/blocks.py): capture the block's (input, output) from
the pristine FP32 model, attach an AdaRound rounding logit to every weight
quantizer of the block, and run ``cfg.recon_iters`` gradient steps on
(alphas, activation scales) to minimise the block-output error plus the
rounding penalty; then freeze the hard rounding into the weights.

The training step is eager PyTorch: a minibatch drawn by ``torch.randperm``
from a seeded generator of its own, the block's forward in training mode
(straight-through rounding, soft AdaRound targets, no kernel), one
``torch.autograd.grad`` into the alphas and the activation scales only (the
block's weights do not require grad), and Adam written out in optax's order
of operations (``_Adam``), with the activation group's cosine learning rate
in optax's closed form. On CUDA, fp32 products and convolutions, backward
passes included, are exact fp32 for the whole of ``reconstruct``, as the
JAX package trains at Precision.HIGHEST.

Every block trains against pristine-model I/O, so the blocks are
independent of each other: their order, and the grouping of same-shape
blocks, change no result.

Over a mesh (``mesh=``) the block I/O is data-parallel over the dp group,
as the JAX package shards it over its 'dp' axis: each rank captures and
keeps its ``dp_split`` of every batch, so its block-I/O memory falls by dp.
Every rank draws the same global minibatch (the same seeded generator over
the global row count) and trains on the drawn rows it holds; the
reconstruction term divides by the global batch, the rounding penalty
joins the loss of dp rank 0 alone, the gradients are summed over the dp
group in one all_reduce (a rank that drew no row adds zeros), and Adam
then steps the same on every rank. The
result equals the single-device one up to the order of the float sums.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import math
import time
from typing import Dict, List

import numpy as np
import torch

from adalog_tpu_torch.calib.calibrator import (
    _rank_slice, _resolve_device, _sync,
)
from adalog_tpu_torch.calib.layout import tree_get, tree_set
from adalog_tpu_torch.calib.reparam import _with
from adalog_tpu_torch.models.layers import (
    ConvSite, MatMulSite, _cudnn_full_fp32, conv_view, linear_view,
)
from adalog_tpu_torch.models.zoo import model_forward_fn
from adalog_tpu_torch.quantizers.adaround import (
    adaround_hard_weight, adaround_init_alpha, adaround_soft_targets,
)
from adalog_tpu_torch.parallel.mesh import (
    dp_assert_replicated, dp_barrier, dp_rows, dp_sum, require_group,
)
from adalog_tpu_torch.quantizers.state import map_tensors, tensor_leaves
from adalog_tpu_torch.recon.blocks import BlockUnit, block_units
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.resume import resume_append, resume_scan

log = logging.getLogger("adalog_tpu_torch")

ROUND_WEIGHT = 0.01          # weight of the rounding penalty
B_RANGE = (20.0, 2.0)        # the penalty's temperature, start and end
WARMUP = 0.2                 # share of iterations before the penalty starts
W_LR = 1e-3                  # Adam learning rate of the alphas
A_LR = 4e-5                  # initial (cosine-decayed) rate of the act scales


def capture_block_io(spec, params_full, batches: List[np.ndarray], skip=(),
                     keep_on_device: bool = True, mesh=None):
    """One pass over the optimization set through the pristine model,
    keeping every block unit's (input, output) concatenated over the
    batches: on the model's device, or on the host with
    ``keep_on_device=False``. ``skip``: block names whose I/O is not kept
    (a resume with most blocks done pays no memory for them). With
    ``mesh``, each rank keeps the rows of its ``dp_split`` of every batch
    (``parallel.mesh.dp_rows`` names them)."""
    if mesh is not None:
        require_group(mesh, "capture_block_io")
        batches = [_rank_slice(xb, mesh) for xb in batches]
    fwd = model_forward_fn(spec)
    skip = frozenset(skip)
    device = next(params_full.parameters()).device
    store = device if keep_on_device else torch.device("cpu")
    acc: Dict[str, list] = {}
    with torch.no_grad():
        for xb in batches:
            x = torch.as_tensor(xb).to(device=device, dtype=torch.float32)
            _, taps = fwd(spec.cfg, params_full, x, capture_blocks=True)
            for nm, (tin, tout) in taps.items():
                if nm not in skip:
                    acc.setdefault(nm, []).append((tin.to(store),
                                                   tout.to(store)))
    return {nm: (torch.cat([a for a, _ in v]), torch.cat([b for _, b in v]))
            for nm, v in acc.items()}


def _b_temperature(t, iters: int):
    """The rounding penalty's temperature at the 1-based step ``t``, in
    float32: B_RANGE[0] until WARMUP * iters, then a linear decay to
    B_RANGE[1]."""
    t = torch.as_tensor(t, dtype=torch.float32)
    start_decay = WARMUP * iters
    rel = (t - start_decay) / (iters - start_decay)
    return torch.where(t < start_decay, torch.tensor(B_RANGE[0]),
                       B_RANGE[1] + (B_RANGE[0] - B_RANGE[1])
                       * torch.clamp(1.0 - rel, min=0.0))


def _rec_loss(pred, tgt, kind: str, n=None):
    """'kl': KL(softmax(tgt) || softmax(pred)) summed over the batch, over
    the batch size; else the squared error summed over axis 1, averaged,
    over 10. ``n``: the batch size of the average when ``pred`` holds a
    rank's part of a dp-split batch (None: pred's own)."""
    if kind == "kl":
        lp = torch.log_softmax(pred, dim=-1)
        t = torch.softmax(tgt, dim=-1)
        return (torch.sum(torch.special.xlogy(t, t))
                - torch.sum(t * lp)) / (pred.shape[0] if n is None else n)
    err = torch.sum(torch.square(pred - tgt), dim=1)
    if n is None:
        return torch.mean(err) / 10.0
    return torch.sum(err) / (n * math.prod(err.shape[1:])) / 10.0


def _viewed_weight(p, site):
    if isinstance(site, ConvSite):
        return conv_view(p.weight)
    return linear_view(p.weight, site.n_V)


def _probability_scale_frozen(site) -> bool:
    """A matmul site whose A quantizer is AdaLog on probabilities (matmul2
    under the post-softmax AdaLog quantizer) keeps its A scale: the
    attention kernels quantize probabilities at scale 1 and never read it
    (``ops.fq_attn.supports_softmax``), so a trained scale would be served
    as 1. Its gradient cancels analytically (dq = x inside the range), but
    a float residue of a few 1e-8 at deit_small width is past Adam's eps,
    which would turn it into steps of about the learning rate. The JAX
    package trains it; at the test models its scale stays at 1."""
    return site.Aq.kind == "adalog" and not site.Aq.shifted


def _merge_trainables(qstate_block, trainables, quant_act: bool):
    """The block's (canonical-name) site states with the trainable tensors
    in place of their alphas and activation scales."""
    rep = dataclasses.replace
    out = dict(qstate_block)
    for nm, alpha in trainables["w"].items():
        site = out[nm]
        out[nm] = rep(site, wq=rep(site.wq, alpha=alpha))
    if quant_act:
        for nm, tr in trainables["a"].items():
            site = out[nm]
            if isinstance(site, MatMulSite):
                Aq = rep(site.Aq, scale=tr["A"]) if "A" in tr else site.Aq
                out[nm] = rep(site, Aq=Aq, Bq=rep(site.Bq, scale=tr["B"]))
            else:
                out[nm] = rep(site, aq=rep(site.aq, scale=tr["a"]))
    return out


def _block_loss(forward, block_params, qstate_block, trainables, xb, yb,
                modes, count: int, iters: int, quant_act: bool,
                rec_kind: str, n=None, penalty: bool = True):
    """(loss, rec) of one step at the 1-based ``count``: the block's
    reconstruction error in training mode with soft rounding, plus the
    rounding penalty ROUND_WEIGHT * sum(1 - |2 s(alpha) - 1| ** b) once
    count >= WARMUP * iters (before that the penalty is 0, and is not
    computed). Over a mesh ``xb`` is this rank's part of the batch (rec is
    0 where it has no row), ``n`` the global batch size (``_rec_loss``),
    and ``penalty`` is true on dp rank 0 alone, so that the dp sum of the
    ranks' gradients counts the penalty once."""
    if xb.shape[0]:
        qs = _merge_trainables(qstate_block, trainables, quant_act)
        pred = forward(block_params, qs, xb, modes, True, True)
        rec = _rec_loss(pred, yb, rec_kind, n)
    else:
        rec = torch.zeros((), device=xb.device)
    if not penalty or count < WARMUP * iters:
        return rec, rec
    b = float(_b_temperature(float(count), iters))
    rnd = 0.0
    for nm in sorted(trainables["w"]):
        s = adaround_soft_targets(trainables["w"][nm])
        rnd = rnd + torch.sum(1.0 - torch.abs(2.0 * s - 1.0) ** b)
    return rec + ROUND_WEIGHT * rnd, rec


def _cosine_lr(init: float, iters: int):
    """optax.cosine_decay_schedule(init, iters, 0) at a 0-based update
    count, in float32: init * 0.5 * (1 + cos(pi * min(k, iters) / iters))."""
    def lr(k):
        k = torch.tensor(float(min(k, iters)), dtype=torch.float32)
        return float(init * (0.5 * (1.0 + torch.cos(math.pi * k / iters))))
    return lr


class _Adam:
    """optax.adam in optax's order of operations, over a list of tensors:
    mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu; with k the 1-based
    update count, u = (mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps), and
    p += (-lr(k - 1)) * u, the learning rate read at the 0-based count as
    optax's schedules are. torch.optim.Adam forms the same update in another
    order (its bias corrections fold into the step size and eps)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, lr):
        self.params = list(params)
        self.lr = lr
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        self.count += 1
        k = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(self.B1) ** k)
        bc2 = float(np.float32(1) - np.float32(self.B2) ** k)
        step = -float(np.float32(self.lr(self.count - 1)))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            if g is None:          # no path from the loss: a zero gradient
                g = torch.zeros_like(p)
            m.copy_((1 - self.B1) * g + self.B1 * m)
            v.copy_((1 - self.B2) * (g * g) + self.B2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.EPS)
            p.copy_(p + step * u)


@contextlib.contextmanager
def _exact_fp32(device):
    """Exact fp32 products and convolutions on CUDA inside the block, their
    backward passes included (qconv2d pins cuDNN around its forward only).
    The matmul pin stays for the process, as every fp32 entry point of the
    package sets it; cuDNN's setting is restored on exit."""
    if device.type != "cuda":
        yield
        return
    from adalog_tpu_torch.serve import pin_fp32_matmul

    pin_fp32_matmul()
    with _cudnn_full_fp32():
        yield


class BlockReconstructor:
    """Reconstructs a calibrated model block by block: ``reconstruct``
    returns (model, qstate) with hard-rounded weights frozen in and the
    trained activation scales.

    params: the calibrated model (possibly reparameterized); params_full:
    the pristine FP32 model the block I/O is captured from; they may be the
    same module. Both are copied to ``device`` (None is the first CUDA
    device, and raises when there is none; the tests pass 'cpu'), so the
    caller's modules are never changed. qstate: the calibrated state.
    layout: ``calib.layout.quant_layout`` of the model. mesh: a
    ``parallel.mesh.Mesh``: the block I/O and the minibatches are
    data-parallel over its dp group (the module's docstring); raises
    without a process group. resume_path: frozen results are appended to
    this framed log after each unit (the JAX package's file format: a file
    written by either package resumes in the other), so an interrupted run
    restarts at the last finished unit; over a mesh rank 0 writes it and
    every rank reads it.

    ``unit_stats[name]`` holds each trained unit's first and last
    reconstruction loss, its iterations, its seconds (synchronized) and, on
    CUDA, its peak device memory in bytes (the device's peak counter is
    reset before each unit); over a mesh the losses are the dp group's and
    the seconds and bytes this rank's.
    """

    def __init__(self, spec, params, params_full, qstate, layout,
                 cfg: Config, mesh=None, resume_path: str = None,
                 device=None):
        self.mesh = None if mesh is None else require_group(
            mesh, "BlockReconstructor")
        self.device = _resolve_device(device, "BlockReconstructor",
                                      "reconstruct")
        self.spec = spec
        self.params = copy.deepcopy(params).to(self.device).requires_grad_(
            False)
        self.params_full = copy.deepcopy(params_full).to(
            self.device).requires_grad_(False)
        self.qstate = {nm: map_tensors(lambda t: t.to(self.device), site)
                       for nm, site in qstate.items()}
        self.layout = layout
        self.cfg = cfg
        self.resume_path = resume_path
        self.unit_stats: Dict[str, dict] = {}
        # over a mesh: the global indices of the rows this rank holds, and
        # the global row count
        self._rows, self._n_rows = None, 0

    # -- resume: ("recon", unit name, {"params": {site: LinearP | ConvP},
    #    "sites": {site: site state}}) records ----------------------------

    def _resume_apply(self):
        """Apply earlier "recon" records; returns the set of finished units.
        Valid because every unit trains against pristine-model I/O: a
        finished unit's frozen weights change no other unit's target."""
        from adalog_tpu_torch.utils.interop import (
            affine_from_node, qstate_from_tree,
        )

        done = set()
        for tag, name, payload in resume_scan(self.resume_path):
            if tag != "recon":
                continue
            for nm, node in payload.get("params", {}).items():
                path = self.layout[nm].param_path
                self.params = tree_set(self.params, path, affine_from_node(
                    tree_get(self.params, path), node))
            sites = qstate_from_tree(payload.get("sites", {}))
            for nm, site in sites.items():
                self.qstate[nm] = map_tensors(lambda t: t.to(self.device),
                                              site)
            done.add(name)
        if self.mesh is not None:
            # an all_reduce as a barrier: every rank has read the file
            # before rank 0 appends to it
            dp_barrier(self.mesh)
        if done:
            log.info("resumed %d reconstructed blocks from %s", len(done),
                     self.resume_path)
        return done

    def _record_block(self, unit: BlockUnit):
        from adalog_tpu_torch.utils.interop import affine_node

        if not self.resume_path or (self.mesh is not None
                                    and self.mesh.rank != 0):
            return
        payload = {"params": {}, "sites": {}}
        for nm in unit.canon:
            site = self.qstate.get(nm)
            if site is None:
                continue
            payload["sites"][nm] = site
            if not isinstance(site, MatMulSite):
                payload["params"][nm] = affine_node(
                    tree_get(self.params, self.layout[nm].param_path))
        resume_append(self.resume_path, [("recon", unit.name, payload)])

    # -- one unit -------------------------------------------------------------

    def _site_modes(self, unit: BlockUnit, quant_act: bool):
        """Per-site modes during training: Linear and conv sites quantize
        weights always and activations when quant_act; matmul sites are
        raw unless quant_act. Keys are canonical names."""
        modes = {}
        for nm, cn in unit.canon.items():
            site = self.qstate.get(nm)
            if site is None:
                continue
            if isinstance(site, MatMulSite):
                modes[cn] = "quant" if quant_act else "raw"
            else:
                modes[cn] = "quant" if quant_act else "w_only"
        return modes

    def _init_trainables(self, unit: BlockUnit, quant_act: bool):
        """An AdaRound alpha per weight site (canonical names) and, when
        quant_act, the activation scales (but a probability scale,
        ``_probability_scale_frozen``): fresh leaf tensors that require
        grad; the state's own tensors are left as they were."""
        def leaf(t):
            return t.detach().clone().requires_grad_(True)

        w_tr, a_tr = {}, {}
        for nm, cn in unit.canon.items():
            site = self.qstate.get(nm)
            if site is None:
                continue
            if isinstance(site, MatMulSite):
                if quant_act:
                    a_tr[cn] = {"B": leaf(site.Bq.scale)}
                    if not _probability_scale_frozen(site):
                        a_tr[cn]["A"] = leaf(site.Aq.scale)
                continue
            p = tree_get(self.params, self.layout[nm].param_path)
            with torch.no_grad():
                alpha = adaround_init_alpha(_viewed_weight(p, site),
                                            site.wq.scale)
            w_tr[cn] = leaf(alpha)
            if quant_act:
                a_tr[cn] = {"a": leaf(site.aq.scale)}
        return {"w": w_tr, "a": a_tr}

    def _train_block(self, unit: BlockUnit, raw_in, raw_out, quant_act: bool,
                     rec_kind: str, seed: int = 0):
        """``cfg.recon_iters`` steps on one unit; returns (trainables,
        first rec, last rec). Each step draws ``cfg.optim_batch_size`` of
        the unit's samples, ``randperm(n)[:batch]``, from a generator
        seeded with ``seed``; over a mesh n is the global row count and the
        rank trains on the drawn rows it holds (``_local_draws``). The
        host reads the losses every ``cfg.recon_seg_iters`` steps (the
        segment length of the JAX package's device programs); the results
        do not depend on it."""
        cfg = self.cfg
        iters, batch = cfg.recon_iters, cfg.optim_batch_size
        seg = max(1, min(iters, cfg.recon_seg_iters))
        modes = self._site_modes(unit, quant_act)
        qstate_block = {cn: self.qstate[nm] for nm, cn in unit.canon.items()
                        if nm in self.qstate}
        tr = self._init_trainables(unit, quant_act)
        block_params = unit.extract(self.params)
        w_leaves = [tr["w"][k] for k in sorted(tr["w"])]
        a_leaves = [t for k in sorted(tr["a"])
                    for _, t in sorted(tr["a"][k].items())]
        opt_w = _Adam(w_leaves, lambda k: W_LR)
        opt_a = _Adam(a_leaves, _cosine_lr(A_LR, iters))
        # every step's draw up front, in one copy to the I/O's device: a
        # copy from the host each step would make the host wait for the
        # device each step
        gen = torch.Generator().manual_seed(seed)
        n = raw_in.shape[0] if self.mesh is None else self._n_rows
        draws = torch.stack([torch.randperm(n, generator=gen)[:batch]
                             for _ in range(iters)])
        n_batch = None
        if self.mesh is None:
            draws = draws.to(raw_in.device)
            bounds = None
        else:
            n_batch = draws.shape[1]
            draws, bounds = self._local_draws(draws, raw_in.device)
        leaves = w_leaves + a_leaves
        lead = self.mesh is None or self.mesh.dp_index == 0
        rec0 = rec_last = None
        for t in range(iters):
            idx = draws[t] if bounds is None else \
                draws[bounds[t]:bounds[t + 1]]
            xb = raw_in.index_select(0, idx).to(self.device)
            yb = raw_out.index_select(0, idx).to(self.device)
            loss, rec = _block_loss(unit.forward, block_params, qstate_block,
                                    tr, xb, yb, modes, t + 1, iters,
                                    quant_act, rec_kind, n_batch, lead)
            # a rank that drew no row before the penalty starts has no
            # graph: it adds zeros
            grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
                     if loss.requires_grad else [None] * len(leaves))
            if self.mesh is not None:
                grads = self._dp_sum_grads(grads, leaves)
            opt_w.step(grads[:len(w_leaves)])
            opt_a.step(grads[len(w_leaves):])
            last = t + 1 == iters
            at_seg = (t + 1) % seg == 0 and not last
            rec_last = rec.detach()
            if self.mesh is not None and (t == 0 or at_seg or last):
                rec_last = dp_sum(rec_last, self.mesh)
            if rec0 is None:
                rec0 = rec_last
            if at_seg:
                log.debug("%s: step %d rec %.6f", unit.name, t + 1,
                          float(rec_last))
        detached = {"w": {k: v.detach() for k, v in tr["w"].items()},
                    "a": {k: {kk: vv.detach() for kk, vv in d.items()}
                          for k, d in tr["a"].items()}}
        return detached, float(rec0), float(rec_last)

    def _local_draws(self, draws, device):
        """The drawn rows (iters, batch) of global indices, mapped to this
        rank's local rows and kept where it holds them: (the kept local
        rows of every step in order, on ``device``; each step's bounds in
        them, on the host)."""
        local = torch.full((self._n_rows,), -1, dtype=torch.int64)
        local[self._rows] = torch.arange(len(self._rows))
        sel = local[draws]
        mine = sel >= 0
        bounds = [0] + torch.cumsum(mine.sum(1), 0).tolist()
        return sel[mine].to(device), bounds

    def _dp_sum_grads(self, grads, leaves):
        """Every gradient summed over the dp group in one all_reduce; a
        None (no path from this rank's loss) joins as zeros."""
        flat = torch.cat([(torch.zeros_like(p) if g is None else g)
                          .reshape(-1) for g, p in zip(grads, leaves)])
        flat = dp_sum(flat, self.mesh)
        return [part.reshape(p.shape) for part, p in
                zip(flat.split([p.numel() for p in leaves]), leaves)]

    def _train_block_group(self, units, ios, quant_act: bool, seed: int = 0):
        """Train a group of same-shape blocks, one after the other. The JAX
        package trains a group as one vmapped program and documents it
        equal to training the blocks in sequence (same initial trainables,
        optimizer and sample stream per block), which is what this loop
        does. Returns (per-block trainables, (n, 2) array of first / last
        rec)."""
        per_block, recs = [], []
        for u in units:
            tr, r0, r1 = self._timed_train(u, ios[u.name][0], ios[u.name][1],
                                           quant_act, "mse", seed)
            per_block.append(tr)
            recs.append((r0, r1))
        return per_block, np.asarray(recs)

    def _timed_train(self, unit, raw_in, raw_out, quant_act, rec_kind,
                     seed=0):
        on_cuda = self.device.type == "cuda"
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        tr, r0, r1 = self._train_block(unit, raw_in, raw_out, quant_act,
                                       rec_kind, seed)
        _sync(self.device)
        self.unit_stats[unit.name] = dict(
            rec_first=r0, rec_last=r1, iters=self.cfg.recon_iters,
            seconds=time.perf_counter() - t0,
            peak_bytes=torch.cuda.max_memory_allocated(self.device)
            if on_cuda else None)
        return tr, r0, r1

    def _freeze_block(self, unit: BlockUnit, trainables, quant_act: bool):
        """Write back the trained activation scales; freeze the hard-rounded
        weights into the model (the site keeps no alpha)."""
        rev = {cn: nm for nm, cn in unit.canon.items()}
        rep = dataclasses.replace
        with torch.no_grad():
            for cn, alpha in trainables["w"].items():
                nm = rev[cn]
                site = self.qstate[nm]
                path = self.layout[nm].param_path
                p = tree_get(self.params, path)
                w_hard = adaround_hard_weight(_viewed_weight(p, site),
                                              site.wq.scale,
                                              alpha.to(self.device))
                self.params = tree_set(self.params, path, _with(
                    p, weight=w_hard.reshape(p.weight.shape)))
            if quant_act:
                for cn, tr in trainables["a"].items():
                    nm = rev[cn]
                    site = self.qstate[nm]
                    if isinstance(site, MatMulSite):
                        Aq = rep(site.Aq, scale=tr["A"].clone()) \
                            if "A" in tr else site.Aq
                        self.qstate[nm] = rep(
                            site, Aq=Aq, Bq=rep(site.Bq,
                                                scale=tr["B"].clone()))
                    else:
                        self.qstate[nm] = rep(
                            site, aq=rep(site.aq, scale=tr["a"].clone()))

    # -- every unit -----------------------------------------------------------

    def reconstruct(self, batches: List[np.ndarray], quant_act: bool = True):
        """Reconstruct every block unit; returns (model, qstate).
        ``batches``: NHWC float32 images (numpy or tensors); over a mesh
        every rank passes the same batches.

        Same-shape, non-head units form groups of up to
        ``cfg.recon_block_group``, derated so that one group's I/O plus its
        trainables and optimizer state stays under ``cfg.recon_group_bytes``
        (the JAX package's grouping and log; a group trains its blocks in
        sequence here). The block I/O stays on the device with
        ``cfg.keep_gpu``, else on the host."""
        with _exact_fp32(self.device):
            self._reconstruct(batches, quant_act)
        dp_assert_replicated(
            list(self.params.state_dict().values()) + tensor_leaves(
                [self.qstate[nm] for nm in sorted(self.qstate)]),
            self.mesh, "reconstruction")
        return self.params, self.qstate

    def _reconstruct(self, batches, quant_act):
        done = self._resume_apply()
        all_units = [u for u in block_units(self.spec) if u.name not in done]
        if not all_units:
            log.info("all blocks already reconstructed (resume)")
            return self.params, self.qstate

        t0 = time.perf_counter()
        io = capture_block_io(self.spec, self.params_full, batches,
                              skip=done, keep_on_device=self.cfg.keep_gpu,
                              mesh=self.mesh)
        sizes = [len(xb) for xb in batches]
        if self.mesh is not None:
            self._rows, self._n_rows = dp_rows(sizes, self.mesh), sum(sizes)
        _sync(self.device)
        log.info("block capture: %d units in %.1fs", len(io),
                 time.perf_counter() - t0)

        group_n = max(1, self.cfg.recon_block_group)
        budget = self.cfg.recon_group_bytes
        units = [u for u in all_units if u.name in io]

        def per_block_bytes(u):
            # a block's I/O (of every row, so that every rank of a mesh
            # cuts the same groups) + its params + AdaRound alphas
            # (~weight-size) + 2x Adam moments
            rin, rout = io[u.name]
            pb = sum(p.numel() * 4
                     for p in u.extract(self.params).parameters())
            rows = rin.shape[0]
            return (sum(sizes) * (rin.numel() * rin.element_size()
                                  + rout.numel() * rout.element_size())
                    // rows + 4 * pb)

        groups, singles = {}, []
        for u in units:
            if group_n > 1 and not u.name.endswith("head") and \
                    len(u.canon) > 1:
                key = (u.forward, tuple(io[u.name][0].shape),
                       tuple(io[u.name][1].shape))
                groups.setdefault(key, []).append(u)
            else:
                singles.append(u)

        for us in groups.values():
            n_eff = max(1, min(group_n, budget // max(per_block_bytes(us[0]),
                                                      1)))
            if n_eff < group_n:
                log.info("recon group [%s..]: derated %d -> %d blocks "
                         "(%.0f MB/block, %.0f MB budget)", us[0].name,
                         group_n, n_eff, per_block_bytes(us[0]) / 2**20,
                         budget / 2**20)
            for st in range(0, len(us), n_eff):
                chunk = us[st:st + n_eff]
                if len(chunk) == 1:
                    singles.append(chunk[0])
                    continue
                t1 = time.perf_counter()
                per_block, recs = self._train_block_group(chunk, io,
                                                          quant_act)
                for u, tr in zip(chunk, per_block):
                    self._freeze_block(u, tr, quant_act)
                    self._record_block(u)
                log.info("reconstructed %d blocks [%s..] rec %.4f -> %.4f "
                         "in %.1fs", len(chunk), chunk[0].name,
                         float(recs[:, 0].mean()), float(recs[:, -1].mean()),
                         time.perf_counter() - t1)
                for u in chunk:
                    io[u.name] = None

        for unit in singles:
            raw_in, raw_out = io[unit.name]
            rec_kind = "kl" if unit.name.endswith("head") else "mse"
            tr, rec0, rec1 = self._timed_train(unit, raw_in, raw_out,
                                               quant_act, rec_kind)
            self._freeze_block(unit, tr, quant_act)
            self._record_block(unit)
            io[unit.name] = None
            log.info("reconstructed %-28s rec %.4f -> %.4f in %.1fs",
                     unit.name, rec0, rec1,
                     self.unit_stats[unit.name]["seconds"])
        return self.params, self.qstate
