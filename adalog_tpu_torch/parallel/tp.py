"""Tensor-parallel serving: the counterpart of ``adalog_tpu.parallel.tp``.

Every rank of a tp group runs the whole forward, fused kernels included, on
its slice of the weights and heads; the only collective is one sum over the
tp group after each row-parallel Linear (``models.layers.qlinear``, by the
site's route in the rank's plan, ops/routes.py). The placement is
Megatron's:

  qkv   column-parallel, its rows pre-permuted chunk-interleaved, [q|k|v]
        per rank, so that the local (3, D/tp, I) row-group view and the
        local (B, N, 3, H/tp, hd) head reshape both hold; needs tp | heads
  fc1   column-parallel (output features sliced); needs tp | hidden
  proj / fc2  row-parallel (input features sliced; partial outputs summed
        over tp, the bias added once on the full sum)
  everything else (norms, embeddings, the patch-embed conv, the head, Swin's
        reductions, per-tensor quantizer state) replicated

Per-head quantizer state goes with its heads: the (1, H, 1, 1) layouts of
the attention matmul sites and Swin's relative-position table (a column per
head) are sliced on their head axis, so each rank's attention kernel sees
its local heads only. A block whose heads (or hidden width) tp does not
divide keeps that sub-block replicated: always correct, only unsharded.

Parameters are named by timm's state-dict keys, which are also the site
names plus ``.weight`` / ``.bias``.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, FrozenSet

import torch

from adalog_tpu_torch.models.layers import LinearSite, MatMulSite

_REL_POS = ".attn.relative_position_bias_table"


def _site(key: str) -> str:
    """State-dict key -> site name."""
    return key.rsplit(".", 1)[0]


def _map_with_path(fn, tree, path=""):
    """``fn(path, tensor)`` on every tensor field of a tree of dataclasses;
    paths are dotted field names ('wq.scale')."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_with_path(fn, getattr(tree, f.name),
                                   f"{path}.{f.name}" if path else f.name)
            for f in dataclasses.fields(tree)})
    return tree


def _slice(t: torch.Tensor, dim, tp: int, index: int) -> torch.Tensor:
    return t if dim is None else t.chunk(tp, dim=dim)[index].clone()


@dataclass(frozen=True)
class TPPlan:
    """The tensor-parallel placement of one (model, qstate, tp) triple."""
    tp: int
    family: str
    col_sites: Dict[str, int] = field(default_factory=dict)   # name -> n_V
    row_sites: FrozenSet[str] = frozenset()
    attn_sharded: FrozenSet[str] = frozenset()                # '...attn'

    # -- parameters --------------------------------------------------------
    def permute_params(self, state: dict) -> dict:
        """Chunk-interleave the fused qkv rows ([q|k|v] per rank chunk), so
        that a contiguous dim-0 slice is the local (3, D/tp, ·) view."""
        out = {}
        for key, t in state.items():
            V = self.col_sites.get(_site(key), 0)
            if V > 1 and key.endswith((".weight", ".bias")):
                R = t.shape[0] // V
                t = t.reshape((V, self.tp, R // self.tp) + tuple(t.shape[1:])
                              ).transpose(0, 1).reshape(t.shape)
            out[key] = t
        return out

    def params_specs(self, state: dict) -> dict:
        """{key: the dim sliced over tp, or None}."""
        out = {}
        for key, t in state.items():
            site, dim = _site(key), None
            if site in self.col_sites and (
                    (key.endswith(".weight") and t.dim() == 2)
                    or (key.endswith(".bias") and t.dim() == 1)):
                dim = 0
            elif site in self.row_sites and key.endswith(".weight") \
                    and t.dim() == 2:
                dim = 1
            elif key.endswith(_REL_POS) and t.dim() == 2 \
                    and key[:-len(_REL_POS)] + ".attn" in self.attn_sharded:
                dim = 1                        # ((2ws-1)^2, heads)
            out[key] = dim
        return out

    def shard_params(self, state: dict, index: int) -> dict:
        """Rank ``index``'s slice of every sliced parameter, qkv rows
        permuted first; the replicated ones are left out."""
        perm = self.permute_params(state)
        return {k: _slice(perm[k], d, self.tp, index)
                for k, d in self.params_specs(perm).items() if d is not None}

    def shard_module(self, model: torch.nn.Module, index: int):
        """A copy of ``model`` holding rank ``index``'s slices."""
        local = copy.deepcopy(model)
        for key, t in self.shard_params(model.state_dict(), index).items():
            path, _, attr = key.rpartition(".")
            setattr(local.get_submodule(path), attr,
                    torch.nn.Parameter(t, requires_grad=False))
        return local

    # -- quantizer state ---------------------------------------------------
    def _leaf_dim(self, name, attn, path, t):
        if name in self.col_sites and path.startswith("wq.") \
                and t.dim() == 3:
            return 1          # (V, R, 1) scale / zp, (V, R, I) alpha: on R
        if name in self.row_sites and path.endswith("alpha") \
                and t.dim() == 3:
            return 2          # (V, R, I) alpha: the input features
        if attn and t.dim() == 4 and t.shape[1] >= self.tp \
                and t.shape[1] % self.tp == 0:
            return 1          # per head (1, H, 1, 1)
        return None           # per-tensor layouts

    def _attn(self, name, site) -> bool:
        return isinstance(site, MatMulSite) and \
            name.rsplit(".", 1)[0] in self.attn_sharded

    def qstate_specs(self, qstate: dict) -> dict:
        """{site: {field path: the dim sliced over tp}} of the sliced
        tensors of a quantizer state."""
        out = {}
        for name, site in qstate.items():
            attn, dims = self._attn(name, site), {}

            def note(path, t, _name=name, _attn=attn, _dims=dims):
                d = self._leaf_dim(_name, _attn, path, t)
                if d is not None:
                    _dims[path] = d
                return t

            _map_with_path(note, site)
            if dims:
                out[name] = dims
        return out

    def shard_qstate(self, qstate: dict, index: int) -> dict:
        """Rank ``index``'s quantizer state: the sliced tensors cut, the rest
        shared with ``qstate``."""
        out = {}
        for name, site in qstate.items():
            attn = self._attn(name, site)
            out[name] = _map_with_path(
                lambda path, t, _n=name, _a=attn: _slice(
                    t, self._leaf_dim(_n, _a, path, t), self.tp, index),
                site)
        return out


def make_tp_plan(spec, qstate, tp: int) -> TPPlan:
    """The placement of a model spec at tp degree; needs no process group."""
    cfg = spec.cfg
    fam = spec.family
    blocks = []
    if fam == "vit":
        hid = int(cfg.dim * cfg.mlp_ratio)
        for i in range(cfg.depth):
            blocks.append((f"blocks.{i}", cfg.heads, hid))
    elif fam == "swin":
        for i, depth in enumerate(cfg.depths):
            hid = int(cfg.stage_dim(i) * cfg.mlp_ratio)
            for j in range(depth):
                blocks.append((f"layers.{i}.blocks.{j}", cfg.heads[i], hid))
    else:
        raise ValueError(f"unknown model family {fam!r}")

    col, row, attn = {}, set(), set()
    for pre, H, hid in blocks:
        if tp > 1 and H % tp == 0:
            col[f"{pre}.attn.qkv"] = 3
            row.add(f"{pre}.attn.proj")
            attn.add(f"{pre}.attn")
        if tp > 1 and hid % tp == 0:
            col[f"{pre}.mlp.fc1"] = 1
            row.add(f"{pre}.mlp.fc2")
    # a qkv that is not a Linear site drops its proj and attention too: a
    # replicated qkv beside a row-sliced proj would not fit
    for nm in list(col):
        if nm in qstate and not isinstance(qstate[nm], LinearSite):
            del col[nm]
            if nm.endswith(".attn.qkv"):
                pre = nm[:-len(".qkv")]
                row.discard(pre + ".proj")
                attn.discard(pre)
    return TPPlan(tp=tp, family=fam, col_sites=col,
                  row_sites=frozenset(row), attn_sharded=frozenset(attn))


def tp_eval_fn(spec, params, qstate, mesh, **predictor_kw):
    """This rank's forward over the (dp, tp) mesh: (run, plan). ``run(x)``
    takes the rank's batch slice and returns its float32 logits, computed on
    the rank's slices of ``params`` and ``qstate``, the row-parallel sites
    summed over the mesh's tp group; ``predictor_kw`` are those of
    ``serve.make_predictor`` (dtype, kernels, device), whose plan is built
    from the slices, so every kernel sees local shapes."""
    from adalog_tpu_torch.serve import local_forward

    plan = make_tp_plan(spec, qstate, mesh.tp)
    run = local_forward(spec, plan.shard_module(params, mesh.tp_index),
                        plan.shard_qstate(qstate, mesh.tp_index),
                        row_group=mesh.tp_group, row_sites=plan.row_sites,
                        **predictor_kw)
    return run, plan
