"""Which kernel serves each quantized site of a loaded model, decided once.

``build`` reads the module and quantizer state a predictor runs (cast to
its dtype, on its device) and returns a frozen ``Plan``: one ``Route`` for
each quantized Linear site, the first of

  "int8"     an integer product (K5, ops/int8_linear.py): with ``use_int8``,
             a site ``int8_linear.supports`` that is not row-parallel;
  "fq_gemm"  the fused activation-quant GEMM (K4, ops/fq_gemm.py): with
             ``use_gemm_kernels``, a site ``fq_gemm.supports`` that is not
             row-parallel;
  "fq_act"   the input's quantizer in one pass (K6, ops/fq_act.py): a site
             whose quantizer K6 takes, row-parallel sites included;
  "eager"    the input through ``apply_quantizer``;

each but "int8" with the site's fake-quantized weight, a row-parallel
site's with its tp group. For the attention (ops/fq_attn.py) the plan
holds whether its kernels are on (``use_kernels`` or ``use_gemm_kernels``),
the verdict of ``fq_attn.integers_exact`` and each matmul site's parameter
rows, by name; and the LayerNorm modules K7 takes (ops/layer_norm.py), on
a CUDA device. A predictor's forward enters ``activate(plan)``;
``models.layers`` and ``ops.fq_attn`` read ``current()``. Calibration and
BRECQ enter none. A route asked for with another quantizer state or
weight shape than it was built from raises.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Mapping, Optional

import torch


@dataclass(frozen=True)
class Route:
    """How one quantized Linear site is served: ``kind`` "int8", "fq_gemm",
    "fq_act" or "eager"; ``site`` and ``shape`` the state and weight shape
    it was built from; ``weight`` the fake-quantized weight (None: computed
    at the call); ``int8`` / ``gemm`` / ``act`` its kernel's entry; ``row``
    the tp group of a row-parallel site."""
    kind: str
    site: object
    shape: torch.Size
    weight: Optional[torch.Tensor] = None
    int8: object = None
    gemm: object = None
    act: object = None
    row: object = None


@dataclass(frozen=True)
class Plan:
    """What ``build`` decided: ``linear`` {site name: Route}; ``attn`` whether
    the attention kernels are on; ``exact_ints`` the verdict on the
    attention's zero points (None: each call reads its own);
    ``attn_params`` {site name: (site, A rows, B rows)}; ``norms`` the
    LayerNorm modules that K7 serves."""
    linear: Mapping[str, Route] = field(default_factory=dict)
    attn: bool = False
    exact_ints: Optional[bool] = None
    attn_params: Mapping[str, tuple] = field(default_factory=dict)
    norms: frozenset = frozenset()

    def route(self, name, site, weight) -> Route:
        """The route of Linear site ``name``; raises unless it was built from
        ``site`` and a weight of ``weight``'s shape."""
        r = self.linear.get(name)
        if r is None or r.site is not site or r.shape != weight.shape:
            raise RuntimeError(
                f"routes: no route for site {name!r} with this quantizer "
                f"state and a weight of {tuple(weight.shape)}; the plan was "
                "built from another model or state")
        return r

    def attn_rows(self, name, site):
        """(A rows, B rows) of attention matmul site ``name``, or None where
        the plan has none; raises where they were built from another
        state."""
        entry = self.attn_params.get(name)
        if entry is None:
            return None
        if entry[0] is not site:
            raise RuntimeError(f"routes: the parameter rows of site {name!r} "
                               "were built from another quantizer state")
        return entry[1:]

    def count(self, kind: str, act_kind: Optional[str] = None) -> int:
        """How many Linear sites take ``kind`` (and, for "fq_act", K6's
        quantizer kind ``act_kind``)."""
        return sum(r.kind == kind and (act_kind is None
                                       or r.act.kind == act_kind)
                   for r in self.linear.values())


def switches(cfg, use_pallas: Optional[bool] = None) -> dict:
    """``make_predictor``'s kernel keywords from a Config: the attention
    kernels as ``use_pallas`` (else ``cfg.use_pallas``) says, None meaning
    on; the fused GEMM as ``cfg.use_pallas_gemm``; int8 as
    ``cfg.eval_int8``, None meaning off. No model has a measured default of
    its own."""
    attn = cfg.use_pallas if use_pallas is None else use_pallas
    return dict(use_kernels=True if attn is None else bool(attn),
                use_gemm_kernels=bool(cfg.use_pallas_gemm),
                use_int8=bool(getattr(cfg, "eval_int8", None)))


def build(spec, model, qstate, cfg=None, dtype=torch.float32, *,
          use_kernels: bool = True, use_gemm_kernels: bool = False,
          use_int8: bool = False, row_group=None, row_sites=()) -> Plan:
    """The plan of a predictor over ``model`` and ``qstate``, as it will run
    them (cast to ``dtype``, on their device); the switches are
    ``serve.make_predictor``'s, with its defaults. ``row_sites`` are a tp
    rank's row-parallel Linear sites, summed over ``row_group``. Reads each
    site's zero points, bases and scales on the host here, once, and raises
    where a kernel that must take a site cannot (int8 codes past int8, an
    AdaLog base K4 cannot take)."""
    from adalog_tpu_torch.calib.layout import quant_layout, tree_get
    from adalog_tpu_torch.models.layers import (
        LinearSite, MatMulSite, quant_linear_weight,
    )
    from adalog_tpu_torch.ops import (
        fq_act, fq_attn, fq_gemm, int8_linear, layer_norm, weight_prep,
    )
    from adalog_tpu_torch.utils.config import Config

    row_sites = frozenset(row_sites)
    linear = {}
    with torch.no_grad():
        for name, ss in quant_layout(spec, cfg or Config()).items():
            site = qstate.get(name)
            if not isinstance(site, LinearSite):
                if name in row_sites:
                    raise ValueError(f"row-parallel site {name!r} is not a "
                                     "quantized Linear site")
                continue
            lin = tree_get(model, ss.param_path)
            row = row_group if name in row_sites else None
            base = dict(site=site, shape=lin.weight.shape, row=row)
            if use_int8 and row is None \
                    and int8_linear.supports(site, "quant"):
                int8_linear.check_fits_int8(name, site)
                linear[name] = Route(
                    "int8", int8=int8_linear.site_weights(lin.weight, site),
                    **base)
                continue
            w = None if site.wq.bits == 32 else quant_linear_weight(lin, site)
            if use_gemm_kernels and row is None \
                    and fq_gemm.supports(site, "quant"):
                # the weights as integers let fp32 inputs take the
                # tensor-core variant; bf16 inputs take it as they are
                codes = weight_prep.weight_codes(lin.weight, site) \
                    if dtype == torch.float32 else None
                linear[name] = Route(
                    "fq_gemm", weight=w,
                    gemm=fq_gemm.gemm_site(name, site, codes), **base)
                continue
            act = fq_act.act_site(site.aq)
            linear[name] = Route("eager" if act is None else "fq_act",
                                 weight=w, act=act, **base)
        attn = bool(use_kernels or use_gemm_kernels)
        exact_ints, attn_params = None, {}
        if attn:
            exact_ints = fq_attn.integers_exact(qstate)
            attn_params = {name: (site, *fq_attn.site_params(site))
                           for name, site in qstate.items()
                           if isinstance(site, MatMulSite)
                           and fq_attn.supports(site, "quant")}
    return Plan(MappingProxyType(linear), attn, exact_ints,
                MappingProxyType(attn_params), layer_norm.plan_norms(model))


_PLAN: contextvars.ContextVar = contextvars.ContextVar(
    "adalog_routes", default=None)


@contextmanager
def activate(plan: Optional[Plan]):
    """Serve the forward inside the block by ``plan``; None serves every
    site eagerly."""
    tok = _PLAN.set(plan)
    try:
        yield
    finally:
        _PLAN.reset(tok)


def current() -> Optional[Plan]:
    """The active plan, or None."""
    return _PLAN.get()
