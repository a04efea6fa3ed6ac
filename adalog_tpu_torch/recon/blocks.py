"""Block-unit registry for BRECQ reconstruction, the counterpart of
``adalog_tpu.recon.blocks``.

The reference reconstructs per "block": the patch embedding, each ViT block,
each Swin block and PatchMerging, and the classifier head. Each unit has:

  - canon: the global quant-site name -> its canonical (block-local) name
  - extract(model): the block's own submodule (the whole model for the
    patch embedding and the head)
  - forward(block_params, qstate_canon, x, modes_canon, training, soft)

Forwards are canonical: one function object and the same canonical site
names for every block of one shape, with the block's module and quantizer
state passed as arguments. The resume records and the grouping of
same-shape blocks key on the canonical names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

from adalog_tpu_torch.models import eva as E
from adalog_tpu_torch.models import swin as SW
from adalog_tpu_torch.models import vit as V

VIT_BLOCK_SITES = ("attn.qkv", "attn.matmul1", "attn.matmul2", "attn.proj",
                   "mlp.fc1", "mlp.fc2")


@dataclass
class BlockUnit:
    name: str
    canon: Dict[str, str]           # global site name -> canonical name
    extract: Callable               # model -> the block's submodule
    forward: Callable               # (block_params, qs, x, modes, training, soft)


def _vit_units(spec) -> List[BlockUnit]:
    cfg = spec.cfg

    def patch_fwd(p, qs, x, modes, training, soft):
        return V.vit_patch_embed(cfg, p, qs, x, modes, None,
                                 training=training, soft=soft)

    def block_fwd(bp, qs, x, modes, training, soft):
        return V.vit_block(cfg, bp, qs, "blk", x, modes, None,
                           training=training, soft=soft)

    def head_fwd(p, qs, x, modes, training, soft):
        return V.vit_head(cfg, p, qs, x, modes, None,
                          training=training, soft=soft)

    units = [BlockUnit("patch_embed",
                       {"patch_embed.proj": "patch_embed.proj"},
                       lambda p: p, patch_fwd)]
    for i in range(cfg.depth):
        pre = f"blocks.{i}"
        canon = {f"{pre}.{s}": f"blk.{s}" for s in VIT_BLOCK_SITES}
        units.append(BlockUnit(pre, canon,
                               lambda p, i=i: p.blocks[i], block_fwd))
    units.append(BlockUnit("head", {"head": "head"}, lambda p: p, head_fwd))
    return units


def _eva_units(spec) -> List[BlockUnit]:
    cfg = spec.cfg

    def patch_fwd(p, qs, x, modes, training, soft):
        return E.eva_patch_embed(cfg, p, qs, x, modes, None,
                                 training=training, soft=soft)

    def block_fwd(bp, qs, x, modes, training, soft):
        return E.eva_block(cfg, bp, qs, "blk", x, modes, None,
                           training=training, soft=soft)

    def head_fwd(p, qs, x, modes, training, soft):
        return E.eva_head(cfg, p, qs, x, modes, None,
                          training=training, soft=soft)

    units = [BlockUnit("patch_embed",
                       {"patch_embed.proj": "patch_embed.proj"},
                       lambda p: p, patch_fwd)]
    for i in range(cfg.depth):
        pre = f"blocks.{i}"
        canon = {f"{pre}.{s}": f"blk.{s}" for s in VIT_BLOCK_SITES}
        units.append(BlockUnit(pre, canon,
                               lambda p, i=i: p.blocks[i], block_fwd))
    units.append(BlockUnit("head", {"head": "head"}, lambda p: p, head_fwd))
    return units


def _swin_units(spec) -> List[BlockUnit]:
    cfg = spec.cfg

    def patch_fwd(p, qs, x, modes, training, soft):
        return SW.swin_patch_embed(cfg, p, qs, x, modes, None,
                                   training=training, soft=soft)

    def merge_fwd(pm, qs, x, modes, training, soft):
        return SW.patch_merging(pm, qs, "down", x, modes, None,
                                training=training, soft=soft)

    def head_fwd(p, qs, x, modes, training, soft):
        return SW.swin_head(p, qs, x, modes, None,
                            training=training, soft=soft)

    units = [BlockUnit("patch_embed",
                       {"patch_embed.proj": "patch_embed.proj"},
                       lambda p: p, patch_fwd)]
    fwd_cache = {}
    for i, depth in enumerate(cfg.depths):
        if i > 0:
            dname = f"layers.{i}.downsample"
            units.append(BlockUnit(
                dname, {f"{dname}.reduction": "down.reduction"},
                lambda p, i=i: p.layers[i].downsample, merge_fwd))
        for j in range(depth):
            pre = f"layers.{i}.blocks.{j}"
            canon = {f"{pre}.{s}": f"blk.{s}" for s in VIT_BLOCK_SITES}
            # one forward object per (window, shift, heads, dim) class, so
            # same-shape blocks group together
            key = (cfg.stage_window_shift(i, j), cfg.heads[i],
                   cfg.stage_dim(i))
            if key not in fwd_cache:
                def block_fwd(bp, qs, x, modes, training, soft, i=i, j=j):
                    return SW.swin_block(cfg, bp, qs, "blk", i, j, x, modes,
                                         None, training=training, soft=soft)
                fwd_cache[key] = block_fwd
            units.append(BlockUnit(pre, canon,
                                   lambda p, i=i, j=j: p.layers[i].blocks[j],
                                   fwd_cache[key]))
    units.append(BlockUnit("head", {"head.fc": "head.fc"},
                           lambda p: p, head_fwd))
    return units


def block_units(spec) -> List[BlockUnit]:
    return {"vit": _vit_units, "eva": _eva_units,
            "swin": _swin_units}[spec.family](spec)
