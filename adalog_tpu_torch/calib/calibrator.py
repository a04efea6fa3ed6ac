"""Calibration orchestration, the counterpart of
``adalog_tpu.calib.calibrator``.

Every quant module stays in 'raw' mode until calibration ends, so all
captured activations are pure FP32: every site's I/O is captured in ONE
forward pass per calibration batch, then each site's search runs on the
device. Same-shape sites are searched together (``batch_sites``): one
``torch.func.vmap``-batched search per group of sites, in chunks under
``batch_group_bytes``.

The LayerNorm channel reparam (sites wired to a preceding norm) rewrites the
model and that site's cached input; downstream sites are unaffected because
the rewrite preserves the composite function. ``finish_calibration`` then
folds the post-GeLU shift into each fc2 bias.

The calibrator works on its own copy of the caller's model, on ``device``
(CUDA unless the caller asks for the CPU). Model rewrites are functional
(``layout.tree_set``): each returned model is a new root that shares its
unchanged submodules with the calibrator's earlier ones.

Over a mesh (``mesh=``, a ``parallel.mesh.Mesh`` in every rank of its
process group) the calibration is data-parallel over the dp group, as the
JAX package's is over its 'dp' axis: each rank captures and keeps only its
slices of the batches (``dp_batches``), the searches run inside
``dp_context`` (every sum over tokens or images a partial plus an
all_reduce, the quantiles selected across the ranks), and every rank ends
with the same model and state, bit for bit, which ``calibrate`` asserts.
The result equals the single-device one up to the order of the float
sums.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import time
from typing import Dict, List

import numpy as np
import torch

from adalog_tpu_torch.calib import search as SRCH
from adalog_tpu_torch.calib.layout import (
    SiteSpec, quant_layout, tree_get, tree_set,
)
from adalog_tpu_torch.calib.reparam import (
    _with, fold_gelu_shift_into_bias, layernorm_channel_reparam,
    rewrite_cached_input,
)
from adalog_tpu_torch.models.layers import ConvSite, LinearSite, MatMulSite
from adalog_tpu_torch.models.zoo import model_forward_fn
from adalog_tpu_torch.ops import scoring
from adalog_tpu_torch.parallel.mesh import (
    dp_assert_replicated, dp_barrier, dp_batches, dp_context, dp_max,
    require_group,
)
from adalog_tpu_torch.quantizers.state import (
    GELU_MIN, QuantizerState, WeightQuantizerState, map_tensors,
    tensor_leaves,
)
from adalog_tpu_torch.utils.config import Config
from adalog_tpu_torch.utils.resume import resume_append, resume_scan

log = logging.getLogger("adalog_tpu_torch")


def _model_device(params):
    return next(params.parameters()).device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tap_shapes(spec, params, batch_shape):
    """{site: (shape of each captured tensor)} of one batch of
    ``batch_shape``, from a forward on the meta device (no data, no
    device memory): the counterpart of the JAX package's jax.eval_shape."""
    meta = copy.deepcopy(params).to("meta")
    with torch.no_grad():
        _, taps = model_forward_fn(spec)(
            spec.cfg, meta, torch.empty(batch_shape, device="meta"),
            capture=True)
    return {nm: tuple(tuple(t.shape) for t in tup) for nm, tup in taps.items()}


def capture_all_sites(spec, params, batches: List[np.ndarray],
                      device_budget_bytes: int = None, names=None,
                      spill_dtype=None, capture_dtype=None, mesh=None):
    """Run the raw model once per batch, capturing every quant site's I/O.

    Returns {name: tuple of tensors concatenated over the batches (inputs...,
    output)}, on the model's device. ``names`` restricts the capture to those
    sites (resume skips the searched ones). When the footprint of all taps
    (known ahead from ``tap_shapes``) exceeds ``device_budget_bytes``, the
    taps spill to host memory per batch and go back to the device site by
    site at search time. ``spill_dtype`` (torch.bfloat16) downcasts the taps
    on the device before a spill; ``capture_dtype`` (torch.bfloat16) keeps
    every tap in that dtype on the device, spilling or not, and the spill
    decision is made against the smaller bytes; the searches upcast to fp32.
    When one batch's taps exceed a quarter of the budget, they are taken in
    groups of sites (a forward a group; each forward keeps only its group).
    With ``mesh`` each rank runs the forward on its slices of the batches
    (``parallel.mesh.dp_batches``; a batch that gives the rank no image is
    skipped) and keeps its rows of the taps; the budget, spill and dtypes
    apply per rank."""
    if mesh is not None:
        require_group(mesh, "capture_all_sites")
        batches = dp_batches(batches, mesh)
    device = _model_device(params)
    fwd = model_forward_fn(spec)
    shapes = tap_shapes(spec, params, tuple(np.shape(batches[0])))
    if names is not None:
        shapes = {nm: shapes[nm] for nm in names}
        if not shapes:
            return {}
    groups = [tuple(shapes)]
    spill = False
    item = 2 if capture_dtype == torch.bfloat16 else 4
    if device_budget_bytes is not None:
        site_bytes = {nm: sum(int(np.prod(s)) * item for s in tup)
                      for nm, tup in shapes.items()}
        per_batch = sum(site_bytes.values())
        total = per_batch * len(batches)
        spill = total > device_budget_bytes
        pass_cap = max(device_budget_bytes // 4, max(site_bytes.values()))
        if per_batch > pass_cap:
            groups, cur, cur_b = [], [], 0
            for nm in shapes:                      # insertion = layout order
                if cur and cur_b + site_bytes[nm] > pass_cap:
                    groups.append(tuple(cur))
                    cur, cur_b = [], 0
                cur.append(nm)
                cur_b += site_bytes[nm]
            if cur:
                groups.append(tuple(cur))
            log.info("capture footprint %.1f GB (budget %.1f GB): %s in "
                     "%d passes/batch", total / 2**30,
                     device_budget_bytes / 2**30,
                     "spilling to host" if spill else
                     "grouped on-device capture", len(groups))
    cast = capture_dtype or (spill_dtype if spill else None)

    per_batch_taps = []
    with torch.no_grad():
        for xb in batches:
            xb = torch.as_tensor(xb).to(device=device, dtype=torch.float32)
            taps = {}
            for g in groups:
                _, all_taps = fwd(spec.cfg, params, xb, capture=True)
                for nm in g:
                    tup = all_taps[nm]
                    if cast is not None:
                        tup = tuple(t.to(cast) for t in tup)
                    if spill:
                        tup = tuple(t.to("cpu") for t in tup)
                    taps[nm] = tup
                del all_taps
            per_batch_taps.append(taps)
    out = {}
    for nm in list(per_batch_taps[0]):
        arity = len(per_batch_taps[0][nm])
        out[nm] = tuple(torch.cat([pb[nm][k] for pb in per_batch_taps])
                        for k in range(arity))
        for pb in per_batch_taps:
            del pb[nm]
    return out


def _flat2d(x):
    return x.reshape(-1, x.shape[-1])


def _resolve_device(device, owner="QuantCalibrator", task="calibrate"):
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}: torch finds no CUDA device; pass device='cpu' "
            f"to {task} on the CPU")
    return dev


def _module_bytes(el):
    """Bytes of a tensor, or of a module's parameters."""
    if isinstance(el, torch.Tensor):
        return el.numel() * 4
    return sum(p.numel() * 4 for p in el.parameters())


class QuantCalibrator:
    """Calibrates a model's quant sites: ``calibrate`` then
    ``finish_calibration``, each returning (model, qstate).

    device: where the search runs; None is the first CUDA device, and
    raises when there is none; the tests pass 'cpu'. On CUDA, fp32 matrix
    products are pinned to full fp32 (``serve.pin_fp32_matmul``) before
    capture and scoring.
    resume_path: optional file; per-site results and reparam folds are
    appended as they finish, so an interrupted calibration restarts where it
    left off (utils/resume.py, the JAX package's file format). Over a mesh
    only its rank 0 writes the file; every rank reads it.
    mesh: a ``parallel.mesh.Mesh``: calibrate data-parallel over its dp
    group (the module's docstring); raises without a process group.
    ``seconds`` holds the wall-clock of the capture and of each search family
    ('reparam', 'linear', 'postgelu', 'matmul', 'matmul_post', 'conv', ...),
    synchronized with the device (per rank over a mesh).
    """

    def __init__(self, spec, params, cfg: Config, reparam: bool = True,
                 mesh=None, resume_path: str = None, device=None):
        self.mesh = None if mesh is None else require_group(
            mesh, "QuantCalibrator")
        self.device = _resolve_device(device)
        if self.device.type == "cuda":
            from adalog_tpu_torch.serve import pin_fp32_matmul
            pin_fp32_matmul()
        self.spec = spec
        self.params = copy.deepcopy(params).to(self.device).requires_grad_(
            False)
        self.cfg = cfg
        self.layout = quant_layout(spec, cfg, reparam)
        self.qstate: Dict[str, object] = {}
        self.resume_path = resume_path
        self.seconds: Dict[str, float] = {}
        self._pending = {}
        self._folded = {}    # name -> (r, b) of resume-restored reparam folds
        # sites whose taps were captured AFTER their fold was restored into
        # the model (streaming resume): the folded norm already outputs
        # x/r - b, so the cached-input rewrite must be skipped
        self._taps_post_fold = set()
        self._spill_dtype = (torch.bfloat16 if getattr(
            cfg, "capture_spill_dtype", "float32") == "bfloat16" else None)
        self._capture_dtype = (torch.bfloat16 if getattr(
            cfg, "capture_dtype", "float32") == "bfloat16" else None)
        scoring.set_score_dtype(cfg.search_dtype)
        scoring.check_score_precision(getattr(cfg, "search_precision",
                                              "highest"))

    @contextlib.contextmanager
    def _timed(self, family):
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.seconds[family] = self.seconds.get(family, 0.0) + \
            time.perf_counter() - t0

    def _dev_f32(self, x):
        """A tap on the search device in fp32 (a spilled or bf16 tap is
        upcast after its transfer)."""
        return x.to(device=self.device, dtype=torch.float32)

    def _on_host(self, t):
        return t.device.type == "cpu" and self.device.type != "cpu"

    def _host_like(self, x2, y):
        """Keep a deferred job's input on the host when its taps spilled."""
        return x2.to("cpu") if self._on_host(y) else x2

    def _t(self, a):
        return torch.as_tensor(a).to(self.device)

    # -- resume file: framed npz records, no pickle ---------------------------
    #
    # Record kinds:
    #   ("site", name, site_state)          a searched site's qstate entry
    #   ("fold", name, {norm, lin, r, b})   a LayerNorm channel reparam: the
    #     folded norm and Linear (as the JAX package's LayerNormP / LinearP)
    #     plus the (r, b) input rewrite. On resume the fold is re-applied to
    #     the model and the site's captured input (captured from the
    #     ORIGINAL model, as in an uninterrupted run) is rewritten with the
    #     stored (r, b) instead of folding a second time.

    def _resume_scan(self):
        """All complete records of the resume file (not applied)."""
        return resume_scan(self.resume_path)

    def _resume_apply(self, recs):
        from adalog_tpu_torch.utils.interop import qstate_from_tree

        n_sites = n_folds = 0
        for tag, name, payload in recs:
            if tag == "site":
                site = qstate_from_tree({name: payload})[name]
                self.qstate[name] = map_tensors(self._t, site)
                n_sites += 1
            elif tag == "fold":
                ss = self.layout[name]
                norm = tree_get(self.params, ss.norm_path)
                lin = tree_get(self.params, ss.param_path)
                nf, lf = payload["norm"].fields, payload["lin"].fields
                self.params = tree_set(self.params, ss.norm_path, _with(
                    norm, weight=self._t(nf["g"]), bias=self._t(nf["b"])))
                self.params = tree_set(self.params, ss.param_path, _with(
                    lin, weight=self._t(lf["w"]), bias=self._t(lf["b"])))
                self._folded[name] = (self._t(payload["r"]),
                                      self._t(payload["b"]))
                n_folds += 1
        if recs:
            log.info("resumed %d calibrated sites (+%d reparam folds) from %s",
                     n_sites, n_folds, self.resume_path)

    def _resume_append(self, records):
        """Append ("site" | "fold", name, payload) records (None entries
        skipped); the tensors are copied to the host by the encoder. Over a
        mesh rank 0 writes, as every rank holds the same records."""
        if self.mesh is None or self.mesh.rank == 0:
            resume_append(self.resume_path,
                          [r for r in records if r is not None])

    def _fold_record(self, name, new_norm, new_lin, r, b):
        """The fold's resume record, or None with no resume file."""
        from adalog_tpu_torch.utils.interop import _linear_node, _ln_node

        if not self.resume_path:
            return None
        return ("fold", name, {"norm": _ln_node(new_norm),
                               "lin": _linear_node(new_lin), "r": r, "b": b})

    def _site_records(self, names):
        return [("site", nm, self.qstate[nm]) for nm in names]

    # -- per-family handlers -------------------------------------------------

    def _common(self):
        c = self.cfg
        return dict(eq_n=c.eq_n, steps=c.steps, use_fpcs=c.fpcs)

    def _ones(self, *shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype, device=self.device)

    def _do_conv(self, name, ss: SiteSpec, x, y):
        p = tree_get(self.params, ss.param_path)
        if getattr(self.cfg, "batch_sites", True):
            # deferred like the other families so same-shape conv sites
            # batch (every zoo model has one, so there the group is a
            # single site)
            key = ("conv", tuple(x.shape), tuple(p.weight.shape), ss.w_bits,
                   ss.a_bits)
            self._pending.setdefault(key, []).append((name, ss, x, y, p))
            return
        self._search_conv_now(name, ss, x, y, p)

    def _conv_dims(self, p):
        return (p.weight.shape[2], p.weight.shape[3], p.stride[0],
                p.padding[0])

    def _search_conv_now(self, name, ss, x, y, p):
        w_s, w_z = SRCH.search_conv(
            self._dev_f32(x), self._dev_f32(y), p.weight, p.bias,
            w_bits=ss.w_bits, conv_dims=self._conv_dims(p), **self._common())
        self._set_conv_state(name, ss, w_s, w_z)

    def _set_conv_state(self, name, ss, w_s, w_z):
        self.qstate[name] = ConvSite(
            wq=WeightQuantizerState(scale=w_s, zero_point=w_z,
                                    bits=ss.w_bits, symmetric=False),
            aq=QuantizerState(scale=self._ones(1, 1, 1, 1), kind="uniform",
                              bits=ss.a_bits, symmetric=True))

    def _linear_site(self, ss, w_s, w_z, aq) -> LinearSite:
        return LinearSite(
            wq=WeightQuantizerState(scale=w_s, zero_point=w_z,
                                    bits=ss.w_bits, symmetric=False),
            aq=aq, n_V=ss.n_V)

    def _reparam(self, name, ssi, p, a_s, a_z):
        """Fold one site's channel ranges into its LayerNorm and Linear;
        returns (new Linear, r, b, the fold's resume record)."""
        norm = tree_get(self.params, ssi.norm_path)
        new_norm, new_lin, r, b, _, _ = layernorm_channel_reparam(
            norm, p, a_s, a_z)
        self.params = tree_set(self.params, ssi.norm_path, new_norm)
        self.params = tree_set(self.params, ssi.param_path, new_lin)
        return new_lin, r, b, self._fold_record(name, new_norm, new_lin, r, b)

    def _do_linear(self, name, ss: SiteSpec, x, y):
        p = tree_get(self.params, ss.param_path)
        x2, y2 = _flat2d(x), _flat2d(y)
        batch = getattr(self.cfg, "batch_sites", True)

        if ss.kind == "linear_reparam":
            if name in self._folded:
                # resume restored this site's fold into the model: go
                # straight to the per-tensor search. A one-pass capture ran
                # from the ORIGINAL model, so the stored (r, b) rewrite the
                # tap; a streaming wave captured AFTER the fold sees the
                # folded norm's output (already x/r - b).
                if name not in self._taps_post_fold:
                    r, b = self._folded[name]
                    x2 = rewrite_cached_input(self._dev_f32(x2), r, b)
                    if self._capture_dtype is not None:
                        x2 = x2.to(self._capture_dtype)
            elif batch and p.bias is not None:
                # stage 1 deferred too: the channel-wise self-searches of
                # every same-shape reparam site run as one batched search;
                # the fold and the per-tensor re-search come at the flush
                key = ("reparam", tuple(x2.shape), ss.a_bits)
                self._pending.setdefault(key, []).append(
                    (name, ss, self._host_like(x2, y), y2, p))
                return
            else:
                # stage 1: channel-wise activation self-search, then the fold
                with self._timed("reparam"):
                    a_s, a_z = SRCH.search_act_channelwise(
                        self._dev_f32(x2), a_bits=ss.a_bits, **self._common())
                    p, r, b, rec = self._reparam(name, ss, p, a_s, a_z)
                    x2 = rewrite_cached_input(self._dev_f32(x2), r, b)
                self._resume_append([rec])

        if batch and p.bias is not None:
            # deferred: same-shape sites are searched together; a spilled
            # stash stays on the host so deferral cannot fill the device
            key = ("linear", tuple(x2.shape), tuple(p.weight.shape),
                   ss.w_bits, ss.a_bits, ss.n_V)
            self._pending.setdefault(key, []).append(
                (name, ss, self._host_like(x2, y), y2, p))
            return

        with self._timed("linear"):
            w_s, w_z, a_s, a_z = SRCH.search_linear_default(
                self._dev_f32(x2), self._dev_f32(y2), p.weight, p.bias,
                w_bits=ss.w_bits, a_bits=ss.a_bits, n_V=ss.n_V,
                rounds=self.cfg.search_round, gram=self.cfg.w_search_gram,
                a_gram=getattr(self.cfg, "a_search_gram", False),
                **self._common())
            self._set_linear_state(name, ss, w_s, w_z, a_s, a_z)

    def _set_linear_state(self, name, ss, w_s, w_z, a_s, a_z):
        aq = QuantizerState(scale=a_s, zero_point=a_z, kind="uniform",
                            bits=ss.a_bits, symmetric=False)
        self.qstate[name] = self._linear_site(ss, w_s, w_z, aq)

    def _group_chunks(self, jobs, stacked_slice=slice(2, None)):
        """Split a same-shape job group so that the stacked tensors of one
        batched search stay under ``batch_group_bytes``; chunks are
        balanced (sizes differ by at most one). ``stacked_slice`` selects the
        job fields that are stacked (reparam stage 1 stacks x2 only)."""
        budget = int(getattr(self.cfg, "batch_group_bytes", 1 << 29))
        per = sum(_module_bytes(el) for el in jobs[0][stacked_slice])
        if self.mesh is not None:
            # the largest rank's bytes: every rank must cut the same chunks
            per = int(dp_max(torch.tensor(per, device=self.device),
                             self.mesh))
        n = max(1, min(len(jobs), budget // max(per, 1)))
        k = -(-len(jobs) // n)                  # number of chunks
        bounds = np.linspace(0, len(jobs), k + 1).astype(int)
        return [jobs[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def _flush_pending(self):
        """Run the deferred searches, batched per shape group. Reparam
        stage-1 groups flush first: their folds enqueue the per-tensor
        re-search jobs that the next sweep of the loop flushes."""
        while self._pending:
            pending, self._pending = self._pending, {}
            for key in sorted(pending, key=lambda k: k[0] != "reparam"):
                if key[0] == "reparam":
                    for jobs in self._group_chunks(pending[key],
                                                   stacked_slice=slice(2, 3)):
                        self._flush_reparam_group(jobs)
                else:
                    for jobs in self._group_chunks(pending[key]):
                        self._flush_one_group(key, jobs)

    def _stack(self, jobs, i):
        """Field i of every job, stacked on the search device in fp32."""
        return self._dev_f32(torch.stack([j[i] for j in jobs]))

    def _flush_reparam_group(self, jobs):
        """Batched stage 1 of the channel-wise Linear: one batched
        channel-wise self-search over all sites in the group, then the
        sequential LayerNorm folds and cached-input rewrites; the per-tensor
        re-searches join the regular pending groups."""
        t1 = time.perf_counter()
        ss = jobs[0][1]
        spill = self._on_host(jobs[0][2])
        folds = []
        with self._timed("reparam"):
            a_ss, a_zs = SRCH.search_act_channelwise_batched(
                self._stack(jobs, 2), a_bits=ss.a_bits, **self._common())
            for i, (name, ssi, x2, y2, p) in enumerate(jobs):
                new_lin, r, b, rec = self._reparam(name, ssi, p, a_ss[i],
                                                   a_zs[i])
                x2r = rewrite_cached_input(self._dev_f32(x2), r, b)
                if self._capture_dtype is not None:
                    # the stash stays in the capture dtype (the rewrite
                    # promoted it to fp32)
                    x2r = x2r.to(self._capture_dtype)
                if spill:
                    if self._spill_dtype is not None and \
                            self._capture_dtype is None:
                        x2r = x2r.to(self._spill_dtype)
                    x2r = x2r.to("cpu")
                key2 = ("linear", tuple(x2r.shape),
                        tuple(new_lin.weight.shape), ssi.w_bits, ssi.a_bits,
                        ssi.n_V)
                self._pending.setdefault(key2, []).append(
                    (name, ssi, x2r, y2, new_lin))
                folds.append(rec)
        self._resume_append(folds)
        log.info("reparamed %d x %-30s [batched] in %.2fs",
                 len(jobs), jobs[0][0], time.perf_counter() - t1)

    def _flush_one_group(self, key, jobs):
        t1 = time.perf_counter()
        with self._timed(key[0]):
            if key[0] in ("matmul", "matmul_post"):
                self._flush_matmul_group(key, jobs)
            elif key[0] == "conv":
                self._flush_conv_group(jobs)
            elif key[0] == "postgelu_twin":
                self._flush_twin_group(jobs)
            else:
                self._flush_linear_group(key[0] == "postgelu", jobs)
        self._resume_append(self._site_records([j[0] for j in jobs]))
        log.info("searched %d x %-30s [batched] in %.2fs",
                 len(jobs), jobs[0][0], time.perf_counter() - t1)

    def _flush_linear_group(self, postgelu, jobs):
        ss = jobs[0][1]
        common = dict(w_bits=ss.w_bits, a_bits=ss.a_bits, n_V=ss.n_V,
                      rounds=self.cfg.search_round,
                      gram=self.cfg.w_search_gram, **self._common())
        a_gram = getattr(self.cfg, "a_search_gram", False)
        if len(jobs) == 1:
            name, ss, x2, y2, p = jobs[0]
            x2, y2 = self._dev_f32(x2), self._dev_f32(y2)
            if postgelu:
                res = SRCH.search_linear_postgelu_adalog(
                    x2, y2, p.weight, p.bias, GELU_MIN, **common)
                self._set_postgelu_state(name, ss, *res)
            else:
                res = SRCH.search_linear_default(
                    x2, y2, p.weight, p.bias, a_gram=a_gram, **common)
                self._set_linear_state(name, ss, *res)
            return
        xs, ys = self._stack(jobs, 2), self._stack(jobs, 3)
        ws = torch.stack([j[4].weight for j in jobs])
        bs = torch.stack([j[4].bias for j in jobs])
        if postgelu:
            w_s, w_z, a_s, q = SRCH.search_linear_postgelu_adalog_batched(
                xs, ys, ws, bs, GELU_MIN, **common)
            for i, (name, ssi, _, _, _) in enumerate(jobs):
                self._set_postgelu_state(name, ssi, w_s[i], w_z[i], a_s[i],
                                         q[i])
        else:
            w_s, w_z, a_s, a_z = SRCH.search_linear_default_batched(
                xs, ys, ws, bs, a_gram=a_gram, **common)
            for i, (name, ssi, _, _, _) in enumerate(jobs):
                self._set_linear_state(name, ssi, w_s[i], w_z[i], a_s[i],
                                       a_z[i])

    def _flush_conv_group(self, jobs):
        if len(jobs) == 1:
            self._search_conv_now(*jobs[0])
            return
        ss, p0 = jobs[0][1], jobs[0][4]
        w_s, w_z = SRCH.search_conv_batched(
            self._stack(jobs, 2), self._stack(jobs, 3),
            torch.stack([j[4].weight for j in jobs]),
            torch.stack([j[4].bias for j in jobs]), w_bits=ss.w_bits,
            conv_dims=self._conv_dims(p0), **self._common())
        for i, (name, ssi, _, _, _) in enumerate(jobs):
            self._set_conv_state(name, ssi, w_s[i], w_z[i])

    def _flush_twin_group(self, jobs):
        ss = jobs[0][1]
        common = dict(w_bits=ss.w_bits, a_bits=ss.a_bits, n_V=ss.n_V,
                      rounds=self.cfg.search_round, **self._common())
        if len(jobs) == 1:
            name, ss, x2, y2, p = jobs[0]
            res = SRCH.search_linear_postgelu_twin(
                self._dev_f32(x2), self._dev_f32(y2), p.weight, p.bias,
                **common)
            self._set_twin_state(name, ss, *res)
            return
        w_s, w_z, s_pos, s_neg = SRCH.search_linear_postgelu_twin_batched(
            self._stack(jobs, 2), self._stack(jobs, 3),
            torch.stack([j[4].weight for j in jobs]),
            torch.stack([j[4].bias for j in jobs]), **common)
        for i, (name, ssi, _, _, _) in enumerate(jobs):
            self._set_twin_state(name, ssi, w_s[i], w_z[i], s_pos[i],
                                 s_neg[i])

    def _set_twin_state(self, name, ss, w_s, w_z, s_pos, s_neg):
        aq = QuantizerState(scale=torch.stack([s_pos, s_neg]), kind="twin",
                            bits=ss.a_bits)
        self.qstate[name] = self._linear_site(ss, w_s, w_z, aq)

    def _matmul_common(self, ss):
        return dict(A_bits=ss.s_bits, B_bits=ss.a_bits,
                    rounds=self.cfg.search_round,
                    head_cw=self.cfg.matmul_head_channel_wise,
                    **self._common())

    def _flush_matmul_group(self, key, jobs):
        if len(jobs) == 1:
            self._search_matmul_now(*jobs[0])
            return
        ss = jobs[0][1]
        As, Bs, ys = (self._stack(jobs, i) for i in (2, 3, 4))
        if key[0] == "matmul":
            A_s, A_z, B_s, B_z = SRCH.search_matmul_batched(
                As, Bs, ys, gram=getattr(self.cfg, "a_search_gram", False),
                **self._matmul_common(ss))
            for i, (name, ssi, _, _, _) in enumerate(jobs):
                Aq = QuantizerState(scale=A_s[i], zero_point=A_z[i],
                                    kind="uniform", bits=ssi.s_bits,
                                    symmetric=False)
                self._set_matmul_state(name, ssi, Aq, B_s[i], B_z[i])
        else:
            q, B_s, B_z = SRCH.search_matmul_postsoftmax_batched(
                As, Bs, ys, a_kind=ss.post_quantizer,
                **self._matmul_common(ss))
            for i, (name, ssi, _, _, _) in enumerate(jobs):
                self._set_matmul_state(name, ssi,
                                       self._postsoftmax_aq(ssi, q[i]),
                                       B_s[i], B_z[i])

    def _do_postgelu(self, name, ss: SiteSpec, x, y):
        p = tree_get(self.params, ss.param_path)
        x2, y2 = _flat2d(x), _flat2d(y)
        if getattr(self.cfg, "batch_sites", True) and p.bias is not None:
            key = (ss.kind, tuple(x2.shape), tuple(p.weight.shape),
                   ss.w_bits, ss.a_bits, ss.n_V)
            self._pending.setdefault(key, []).append(
                (name, ss, self._host_like(x2, y), y2, p))
            return
        x2, y2 = self._dev_f32(x2), self._dev_f32(y2)
        common = dict(w_bits=ss.w_bits, a_bits=ss.a_bits, n_V=ss.n_V,
                      rounds=self.cfg.search_round, **self._common())
        with self._timed(ss.kind):
            if ss.kind == "postgelu_twin":
                res = SRCH.search_linear_postgelu_twin(
                    x2, y2, p.weight, p.bias, **common)
                self._set_twin_state(name, ss, *res)
            else:
                res = SRCH.search_linear_postgelu_adalog(
                    x2, y2, p.weight, p.bias, GELU_MIN,
                    gram=self.cfg.w_search_gram, **common)
                self._set_postgelu_state(name, ss, *res)

    def _set_postgelu_state(self, name, ss, w_s, w_z, a_s, q):
        kind = ss.post_quantizer       # adalog | log2 | logsqrt2
        aq = QuantizerState(
            scale=a_s,
            shift=torch.full((1,), GELU_MIN, dtype=torch.float32,
                             device=self.device),
            log_q=q if kind == "adalog" else None,
            bias_reparamed=torch.zeros((), dtype=torch.bool,
                                       device=self.device),
            kind=kind, bits=ss.a_bits, shifted=True)
        self.qstate[name] = self._linear_site(ss, w_s, w_z, aq)

    def _do_matmul(self, name, ss: SiteSpec, A, B, y):
        if getattr(self.cfg, "batch_sites", True):
            key = (ss.kind, tuple(A.shape), tuple(B.shape), ss.s_bits,
                   ss.a_bits, ss.post_quantizer)
            self._pending.setdefault(key, []).append((name, ss, A, B, y))
            return
        with self._timed(ss.kind):
            self._search_matmul_now(name, ss, A, B, y)

    def _set_matmul_state(self, name, ss, Aq, B_s, B_z):
        Bq = QuantizerState(scale=B_s, zero_point=B_z, kind="uniform",
                            bits=ss.a_bits, symmetric=False)
        self.qstate[name] = MatMulSite(Aq=Aq, Bq=Bq)

    def _postsoftmax_aq(self, ss, q):
        return QuantizerState(
            scale=self._ones(1, 1, 1, 1),
            log_q=q if ss.post_quantizer == "adalog" else None,
            kind=ss.post_quantizer, bits=ss.s_bits)

    def _search_matmul_now(self, name, ss, A, B, y):
        A, B, y = self._dev_f32(A), self._dev_f32(B), self._dev_f32(y)
        if ss.kind == "matmul":
            A_s, A_z, B_s, B_z = SRCH.search_matmul(
                A, B, y, gram=getattr(self.cfg, "a_search_gram", False),
                **self._matmul_common(ss))
            Aq = QuantizerState(scale=A_s, zero_point=A_z, kind="uniform",
                                bits=ss.s_bits, symmetric=False)
        else:
            q, B_s, B_z = SRCH.search_matmul_postsoftmax(
                A, B, y, a_kind=ss.post_quantizer, **self._matmul_common(ss))
            Aq = self._postsoftmax_aq(ss, q)
        self._set_matmul_state(name, ss, Aq, B_s, B_z)

    # -- the calibration loop ------------------------------------------------

    def _run_sites(self, names, taps):
        """Dispatch each site's search (or deferral) from its captured tap,
        freeing taps eagerly; then flush the deferred groups."""
        for name in names:
            if name in self.qstate:      # resumed
                taps.pop(name, None)
                continue
            ss = self.layout[name]
            t1 = time.perf_counter()
            tap = taps[name]
            if ss.kind == "conv":
                self._do_conv(name, ss, *tap)
            elif ss.kind in ("matmul", "matmul_post"):
                self._do_matmul(name, ss, *tap)
            elif ss.kind in ("linear", "linear_reparam"):
                self._do_linear(name, ss, *tap)
            else:
                self._do_postgelu(name, ss, *tap)
            taps[name] = None            # free this site's captures
            if name in self.qstate:      # deferred sites append at flush
                self._resume_append(self._site_records([name]))
            log.info("calibrated %-38s [%s] in %.2fs", name, ss.kind,
                     time.perf_counter() - t1)
        self._flush_pending()

    def _tap_bytes(self, batches, names):
        """Per-site capture footprint (all batches), from ``tap_shapes``;
        over a mesh that of the largest rank slice (the first), so that
        every rank cuts the same waves."""
        shape = list(np.shape(batches[0]))
        if self.mesh is not None:
            shape[0] = -(-shape[0] // self.mesh.dp)
        shapes = tap_shapes(self.spec, self.params, tuple(shape))
        item = 2 if self._capture_dtype == torch.bfloat16 else 4
        return {nm: sum(int(np.prod(s)) * item for s in shapes[nm])
                * len(batches) for nm in names}

    def _streaming_waves(self, batches, need):
        """Partition sites into capture waves under the device budget, or
        None when streaming is off or unnecessary (cfg.streaming_calib:
        'auto' streams only when a one-pass capture would spill)."""
        mode = str(getattr(self.cfg, "streaming_calib", "auto")).lower()
        budget = self.cfg.capture_device_budget_bytes
        if mode in ("off", "false") or budget is None:
            return None
        site_bytes = self._tap_bytes(batches, need)
        total = sum(site_bytes.values())
        if mode == "auto" and total <= budget:
            return None
        waves, cur, cur_b = [], [], 0
        for nm in need:                  # layout order
            if cur and cur_b + site_bytes[nm] > budget:
                waves.append(cur)
                cur, cur_b = [], 0
            cur.append(nm)
            cur_b += site_bytes[nm]
        if cur:
            waves.append(cur)
        if len(waves) > 1 or mode in ("on", "true"):
            log.info("streaming calibration: %.1f GB of taps in %d waves "
                     "(budget %.1f GB, no host spill)",
                     total / 2**30, len(waves), budget / 2**30)
            return waves
        return None

    def _capture(self, batches, names):
        with self._timed("capture"):
            return capture_all_sites(
                self.spec, self.params, batches,
                self.cfg.capture_device_budget_bytes, names=names,
                spill_dtype=self._spill_dtype,
                capture_dtype=self._capture_dtype, mesh=self.mesh)

    def calibrate(self, batches: List[np.ndarray]):
        """Full calibration: capture, then search every site. ``batches``:
        NHWC float32 images (numpy or tensors). Returns (model, qstate), the
        model possibly reparameterized.

        Two capture strategies, equal up to the order of sums: one-pass
        capture of every site (spilling to the host past the budget), or
        streaming waves (cfg.streaming_calib): capture a budget-sized slice
        of sites, search it, free it, rerun the raw forward for the next.
        Raw taps are invariant under the folds already applied, so the
        per-wave recapture is exact. Over a mesh, every rank must call this
        with the same batches."""
        with torch.no_grad(), dp_context(self.mesh):
            self._calibrate(batches)
            dp_assert_replicated(
                list(self.params.state_dict().values()) + tensor_leaves(
                    [self.qstate[nm] for nm in sorted(self.qstate)]),
                self.mesh, "calibration")
        return self.params, self.qstate

    def _calibrate(self, batches):
        recs = self._resume_scan()
        if self.mesh is not None:
            # an all_reduce as a barrier: every rank has read the file
            # before rank 0 appends to it
            dp_barrier(self.mesh)
        done = {name for tag, name, _ in recs if tag == "site"}
        need = [nm for nm in self.layout if nm not in done]

        waves = self._streaming_waves(batches, need)
        if waves is not None:
            # streaming: resume records first, since the waves capture from
            # the folded model, so restored-fold sites' taps come out
            # already rewritten
            self._resume_apply(recs)
            self._taps_post_fold = set(self._folded)
            for i, wave in enumerate(waves):
                taps = self._capture(batches, tuple(wave))
                log.info("wave %d/%d: captured %d sites", i + 1, len(waves),
                         len(taps))
                self._run_sites(wave, taps)
            return

        # one pass: capture BEFORE applying resume records, from the
        # ORIGINAL model: the same taps as an uninterrupted run (folds
        # preserve the function; folded sites' cached inputs are rewritten
        # from the stored (r, b)); searched sites are skipped
        taps = self._capture(batches, None if not recs else tuple(need))
        log.info("capture: %d sites in %.1fs", len(taps),
                 self.seconds["capture"])
        self._resume_apply(recs)
        self._run_sites(list(self.layout), taps)

    def finish_calibration(self):
        """The post-GeLU bias fold for every shifted-log fc2 site. Returns a
        new model root and a new qstate dict: the (model, qstate) that
        ``calibrate`` returned stay as they were, so a caller may
        reconstruct from them first (``recon.brecq``) and set
        ``params`` / ``qstate`` before folding."""
        self.qstate = dict(self.qstate)
        with torch.no_grad():
            for name, ss in self.layout.items():
                site = self.qstate.get(name)
                if site is None or ss.kind != "postgelu" or \
                        not getattr(site.aq, "shifted", False):
                    continue
                if bool(site.aq.bias_reparamed):
                    continue
                p = tree_get(self.params, ss.param_path)
                new_lin = fold_gelu_shift_into_bias(p, site, shift=GELU_MIN)
                self.params = tree_set(self.params, ss.param_path, new_lin)
                self.qstate[name] = dataclasses.replace(
                    site, aq=dataclasses.replace(
                        site.aq, bias_reparamed=torch.ones(
                            (), dtype=torch.bool, device=self.device)))
        return self.params, self.qstate
