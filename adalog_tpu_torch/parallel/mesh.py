"""The device mesh of a multi-process run: the counterpart of
``adalog_tpu.parallel.mesh``.

JAX runs one program over a ``jax.sharding.Mesh`` and lets GSPMD place the
collectives. Here one process runs per rank, on its own device, and the
collectives are explicit: a ``Mesh`` holds this rank's place in the
(dp, tp) grid and the process groups of its row and column of that grid.
Ranks are laid out as JAX lays out ``np.array(devices).reshape(dp, tp)``:
rank = dp_index * tp + tp_index.

Devices and backends are the caller's choice and are never switched:
``device="cuda"`` is ``cuda:{LOCAL_RANK}`` (torchrun sets it; without it,
the rank), an explicit ``cuda:0`` puts every rank on that one card, and
``backend=None`` is ``nccl`` for CUDA devices and ``gloo`` for the CPU.
NCCL refuses two ranks on one card, so ranks that share a card name
``backend="gloo"`` (gloo reduces CUDA tensors through the host).

``dp_shard_map`` has no counterpart: the port's forward already runs per
rank, each on its own batch slice (``shard_batch``), and ``gather_batch``
returns the whole batch's output to every rank.

Calibration and reconstruction over a mesh hold each rank's slices of the
images (``dp_batches``: a round robin, so batches smaller than dp work);
where GSPMD turns a reduction over the sharded token or image axis into a
psum, the port takes the local partial and ``dp_sum``s it. The
searches keep the JAX package's signatures: the calibrator enters
``dp_context(mesh)``, and the scorers and candidate grids read ``dp_mesh()``.
``dp_sum`` and ``dp_max`` run inside ``torch.func.vmap`` (the batched site
searches): their vmap rule reduces the stacked tensor, the same on every
rank since every rank searches the same group. ``dp_order_stats`` gives the
k-th smallest values along a sharded axis bit for bit as a sort of the whole
axis on one device would.
"""

from __future__ import annotations

import contextvars
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, tp) grid of ranks. ``dp_group`` holds the
    ranks of this rank's tp index (one per batch slice), ``tp_group`` those
    of its dp index (one per weight shard)."""
    dp: int
    tp: int
    dp_index: int
    tp_index: int
    dp_group: Any
    tp_group: Any
    device: torch.device
    backend: str

    @property
    def rank(self) -> int:
        return self.dp_index * self.tp + self.tp_index


def world_size() -> int:
    """Ranks of this run: those of the initialized process group, else
    torchrun's WORLD_SIZE, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _launch_hint(n: int) -> str:
    return (f"launch one process per rank (torchrun --nproc-per-node {n} "
            "...) or initialize torch.distributed with that many ranks first")


def _rank_device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.index >= n:
            raise RuntimeError(f"rank {rank}: {dev} does not exist (torch "
                               f"finds {n} CUDA device(s)); pass device='cpu' "
                               "to run the ranks on the CPU")
    return dev


def make_mesh_2d(dp_size: int, tp_size: int, *, device="cuda",
                 backend: Optional[str] = None) -> Mesh:
    """The (dp_size, tp_size) mesh over a process group of exactly
    dp_size * tp_size ranks. Initializes the group from torchrun's env://
    variables when the caller has not; every rank must call this with the
    same sizes, since each process group is made collectively."""
    need = dp_size * tp_size
    if dp_size < 1 or tp_size < 1:
        raise ValueError(f"make_mesh_2d({dp_size}, {tp_size}): sizes must "
                         "be positive")
    if world_size() != need:
        raise ValueError(f"make_mesh_2d({dp_size}, {tp_size}) needs {need} "
                         f"ranks; this run has {world_size()}: "
                         + _launch_hint(need))
    probe = torch.device(device)
    if not dist.is_initialized():
        if "MASTER_ADDR" not in os.environ:
            raise ValueError(f"make_mesh_2d({dp_size}, {tp_size}): no process "
                             "group and no torchrun environment: "
                             + _launch_hint(need))
        dist.init_process_group(
            backend or ("nccl" if probe.type == "cuda" else "gloo"),
            init_method="env://")
    actual = dist.get_backend()
    if backend is not None and backend != actual:
        raise ValueError(f"the process group runs {actual}, not the "
                         f"{backend} asked for")
    rank = dist.get_rank()
    dev = _rank_device(device, rank)
    if actual == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl reduces CUDA tensors only, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dp_index, tp_index = divmod(rank, tp_size)
    # every rank makes every group, in the same order
    dp_group = tp_group = None
    for t in range(tp_size):
        g = dist.new_group([d * tp_size + t for d in range(dp_size)])
        if t == tp_index:
            dp_group = g
    for d in range(dp_size):
        g = dist.new_group([d * tp_size + t for t in range(tp_size)])
        if d == dp_index:
            tp_group = g
    return Mesh(dp_size, tp_size, dp_index, tp_index, dp_group, tp_group,
                dev, actual)


def make_mesh(n_devices: Optional[int] = None, *, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """The data-parallel mesh over all ``n_devices`` ranks (default: every
    rank of the run)."""
    return make_mesh_2d(world_size() if n_devices is None else n_devices, 1,
                        device=device, backend=backend)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's dp slice of a batch every rank holds whole; the batch
    must divide by dp (callers pad)."""
    n = x.shape[0]
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} does not split over dp={mesh.dp}")
    b = n // mesh.dp
    return x[mesh.dp_index * b:(mesh.dp_index + 1) * b]


def require_group(mesh: Mesh, what: str) -> Mesh:
    """``mesh`` itself, after checking that torch.distributed has a process
    group: a mesh without one raises, so that no path calibrates on one
    rank alone."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what}: mesh= needs an initialized process "
                           "group; " + _launch_hint(getattr(mesh, "dp", 2)))
    return mesh


def _batch_cuts(sizes, dp: int):
    """Each batch's cut into dp contiguous slices, in rank order: a batch of
    n images gives every rank n // dp, and the n % dp left over go one each
    to the ranks that follow those of the batches before (a round robin
    over the images of all the batches). A batch dp divides is cut as
    ``torch.tensor_split`` cuts it; so is the first. A batch smaller than
    dp leaves ranks without an image. Returns [(dp + 1) offsets]."""
    cuts, seen = [], 0
    for n in sizes:
        base, extra = divmod(n, dp)
        counts = [base + ((r - seen) % dp < extra) for r in range(dp)]
        cuts.append([sum(counts[:r]) for r in range(dp + 1)])
        seen += n
    return cuts


def dp_batches(batches, mesh: Mesh):
    """This rank's slices of a list of batches (``_batch_cuts``), the empty
    ones left out: a rank skips the forward of a batch that gives it no
    image. Raises on every rank, and so before any collective, when the
    batches leave some rank without an image at all."""
    require_group(mesh, "dp_batches")
    cuts = _batch_cuts([np.shape(xb)[0] for xb in batches], mesh.dp)
    empty = [r for r in range(mesh.dp) if all(c[r] == c[r + 1]
                                               for c in cuts)]
    if empty:
        raise ValueError(
            f"{sum(np.shape(xb)[0] for xb in batches)} images leave dp "
            f"ranks {empty} of dp={mesh.dp} without one; use at least "
            f"{mesh.dp} images")
    i = mesh.dp_index
    return [xb[c[i]:c[i + 1]] for xb, c in zip(batches, cuts)
            if c[i + 1] > c[i]]


def dp_rows(sizes, mesh: Mesh) -> torch.Tensor:
    """The global row indices this rank holds, in its local order, when a
    list of batches of ``sizes`` rows is cut by ``dp_batches`` and the
    slices are concatenated."""
    out, start = [], 0
    i = mesh.dp_index
    for n, c in zip(sizes, _batch_cuts(sizes, mesh.dp)):
        out.append(torch.arange(start + c[i], start + c[i + 1]))
        start += n
    return torch.cat(out)


_DP: contextvars.ContextVar = contextvars.ContextVar("adalog_dp_mesh",
                                                     default=None)
# dp_count's results inside the innermost dp_context, by local size
_DP_COUNTS: contextvars.ContextVar = contextvars.ContextVar(
    "adalog_dp_counts", default=None)


@contextmanager
def dp_context(mesh: Optional[Mesh]):
    """Inside the block, the calibration searches reduce their token and
    image sums over ``mesh``'s dp group (``dp_mesh``); a mesh of dp 1 or
    None reduces nothing. ``dp_count`` keeps its results for the block."""
    if mesh is not None:
        require_group(mesh, "dp_context")
    tok = _DP.set(mesh if mesh is not None and mesh.dp > 1 else None)
    tok_counts = _DP_COUNTS.set({})
    try:
        yield
    finally:
        _DP_COUNTS.reset(tok_counts)
        _DP.reset(tok)


def dp_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``dp_context`` (None outside one)."""
    return _DP.get()


class _AllReduce(torch.autograd.Function):
    """An all_reduce over a group that returns a new tensor; its vmap rule
    reduces the whole stacked tensor (every rank stacks the same sites)."""

    @staticmethod
    def forward(x, group, op):
        y = x.clone()
        dist.all_reduce(y, op=op, group=group)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, group, op):
        return _AllReduce.apply(x, group, op), in_dims[0]


def dp_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``t`` over the dp group; ``t`` itself with no mesh or
    dp 1."""
    if mesh is None or mesh.dp == 1:
        return t
    return _AllReduce.apply(t, mesh.dp_group, dist.ReduceOp.SUM)


def dp_max(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The elementwise max of ``t`` over the dp group."""
    if mesh is None or mesh.dp == 1:
        return t
    return _AllReduce.apply(t, mesh.dp_group, dist.ReduceOp.MAX)


def dp_count(n: int, mesh: Optional[Mesh]) -> int:
    """The global size of an axis of which this rank holds ``n``. Inside a
    ``dp_context`` over ``mesh`` the result is kept by ``n``, so that only
    the first call for a size makes the all_reduce. This is the same on
    every rank: a sharded axis always holds the rank's images (of all the
    batches, a number fixed for the calibration and never 0, which
    ``dp_batches`` sees to) times a per-image size, so two sizes are equal
    on one rank where they are on all."""
    if mesh is None or mesh.dp == 1:
        return n
    counts = _DP_COUNTS.get() if mesh is _DP.get() else None
    if counts is not None and n in counts:
        return counts[n]
    t = torch.tensor([n], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, group=mesh.dp_group)
    if counts is not None:
        counts[n] = int(t.item())
        return counts[n]
    return int(t.item())


def dp_barrier(mesh: Optional[Mesh]):
    """Return once every rank of the dp group has come here (an
    all_reduce)."""
    if mesh is None or mesh.dp == 1:
        return
    dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.dp_group)


class _OrderKey(torch.autograd.Function):
    """float32 <-> int32 order keys (the map is its own inverse on the
    bits). A Function so that its vmap rule reinterprets the stacked
    tensor's bits: torch has no batching rule for a dtype view."""

    @staticmethod
    def forward(x, to_key):
        k = x.contiguous()
        k = k.view(torch.int32) if to_key else k
        k = k ^ ((k >> 31) & 0x7FFFFFFF)
        return k if to_key else k.view(torch.float32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, to_key):
        return _OrderKey.apply(x, to_key), in_dims[0]


def order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys in the floats' total order (-0.0 before +0.0):
    a sort of the keys is a sort of the values that depends on the values
    only. ``from_order_key`` inverts it."""
    return _OrderKey.apply(x, True)


def from_order_key(k: torch.Tensor) -> torch.Tensor:
    return _OrderKey.apply(k, False)


def dp_order_stats(keys_sorted: torch.Tensor, ks: torch.Tensor,
                   mesh: Optional[Mesh]) -> torch.Tensor:
    """The ks-th smallest (0-based, (K,) int64) of the ``order_key`` keys
    along the last dim of ``keys_sorted`` (sorted along it), that dim
    sharded over dp: (..., K) int32 keys, equal to indexing the sorted
    whole axis on one device. Without a mesh, that indexing. Over a mesh,
    a binary search on the 32 bits of the key from the top: at each bit the
    ranks count their keys at or below the candidate (``searchsorted`` on
    the sorted slice) and ``dp_sum`` the counts, 32 all_reduces of (..., K)
    counts."""
    if mesh is None or mesh.dp == 1:
        return keys_sorted[..., ks]
    u = keys_sorted.to(torch.int64) + 2 ** 31          # unsigned, [0, 2^32)
    want = ks.to(device=u.device, dtype=torch.int64)
    prefix = torch.zeros(u.shape[:-1] + want.shape, dtype=torch.int64,
                         device=u.device)
    for b in range(31, -1, -1):
        cand = prefix | ((1 << b) - 1)          # bit b clear, lower bits set
        count = dp_sum(torch.searchsorted(u, cand.contiguous(), right=True),
                       mesh)
        # fewer than k + 1 keys at or below cand: the k-th has bit b set
        prefix = prefix | ((count <= want).to(torch.int64) << b)
    return (prefix - 2 ** 31).to(torch.int32)


def dp_assert_replicated(tensors, mesh: Optional[Mesh], what: str):
    """Raise unless every rank of the dp group holds bit-identical
    ``tensors`` (a list): a digest of each tensor's bytes (their sum and
    their position-weighted sum, int64) is all_reduced as max and as min,
    and the two must agree."""
    if mesh is None or mesh.dp == 1:
        return
    rows = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8).to(
            torch.int64)
        w = torch.arange(1, b.numel() + 1, dtype=torch.int64,
                         device=b.device)
        rows.append(torch.stack([b.sum(), (b * w).sum()]).to(mesh.device))
    d = torch.stack(rows) if rows else torch.zeros(
        (0, 2), dtype=torch.int64, device=mesh.device)
    hi, lo = d.clone(), d.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.dp_group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.dp_group)
    bad = (hi != lo).any(dim=1).nonzero().reshape(-1).tolist()
    if bad:
        raise RuntimeError(f"{what}: the dp ranks disagree on {len(bad)} of "
                           f"{len(rows)} tensors (first: #{bad[0]})")


def gather_batch(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch's output on every rank from each rank's dp slice:
    each rank writes its slice into a zero-filled buffer and the dp group
    sums the buffers (adding zeros is exact; gloo reduces CUDA tensors where
    its all_gather may not)."""
    if mesh.dp == 1:
        return y
    b = y.shape[0]
    out = y.new_zeros((mesh.dp * b,) + tuple(y.shape[1:]))
    out[mesh.dp_index * b:(mesh.dp_index + 1) * b] = y
    dist.all_reduce(out, group=mesh.dp_group)
    return out


# Megatron-pattern placement of the transformer zoo, on timm's state-dict
# keys: column-parallel layers (qkv, fc1, the head) shard their output
# features (weight dim 0 and the bias), row-parallel layers (proj, fc2) their
# input features (weight dim 1). Everything else is replicated. The tp
# predictor's own plan (parallel/tp.py) refines this table: it interleaves
# the fused qkv rows, keeps the head whole and shards the per-head state.
_TP_COL = (".qkv", ".fc1")
_TP_HEAD = ("head", "head.fc")
_TP_ROW = (".proj.weight", ".fc2.weight")


def tp_shardings(state: dict, tp: int) -> dict:
    """{key: the dim sharded over tp, or None} of a state dict. A dimension
    that tp does not divide stays replicated (a 10-class head at tp=4)."""
    out = {}
    for key, t in state.items():
        site = key.rsplit(".", 1)[0]
        col = site.endswith(_TP_COL) or site in _TP_HEAD
        if col and key.endswith((".weight", ".bias")) and t.dim() >= 1 \
                and t.shape[0] % tp == 0:
            out[key] = 0
        elif key.endswith(_TP_ROW) and t.dim() == 2 and t.shape[1] % tp == 0:
            out[key] = 1
        else:
            out[key] = None
    return out


def shard_params_tp(model: torch.nn.Module, mesh: Mesh) -> dict:
    """This rank's slice of every parameter under ``tp_shardings``, as a
    state dict."""
    state = model.state_dict()
    return {k: state[k] if d is None else
            state[k].chunk(mesh.tp, dim=d)[mesh.tp_index].clone()
            for k, d in tp_shardings(state, mesh.tp).items()}


def _rank_main(rank, fn, world, init_file, backend, args):
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), *, init_file: str, backend: str = "gloo",
          timeout: float = 600.0):
    """Run ``fn(*args)`` in ``world`` fresh processes (start method spawn)
    that form one process group through the file rendezvous ``init_file``
    (which must not exist yet), each on one CPU thread. ``fn`` is a
    module-level function; it reads its rank from torch.distributed. Raises
    when a rank fails, or when ``timeout`` seconds pass; every rank still
    running is then killed."""
    import torch.multiprocessing as mp

    if os.path.exists(init_file):
        raise ValueError(f"the rendezvous file {init_file} exists already")
    ctx = mp.start_processes(_rank_main,
                             args=(fn, world, init_file, backend, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                                   f"running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
