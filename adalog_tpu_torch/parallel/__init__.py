"""Multi-device serving on ``torch.distributed``: one process per rank.

  mesh.py  the (dp, tp) mesh of ranks, its process groups and device, the
           batch split and gather, the placement table of the Megatron
           pattern, and a launcher of ranks on one host
  tp.py    the tensor-parallel plan: column- and row-parallel sites, the
           per-rank slices of the module and of the quantizer state, and the
           per-rank forward under the row-parallel context
"""
