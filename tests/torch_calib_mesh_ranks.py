"""Rank entry points of tests/test_torch_calib_mesh.py, each run in every
rank of a process group by ``adalog_tpu_torch.parallel.mesh.spawn``.

A spawned rank imports the module of its entry point, so this module
imports torch and the port only: no jax, nothing of adalog_tpu. Inputs come
from ``inputs.npz`` in the work directory, written by the pytest process;
each rank writes its results there as ``<what>_r<rank>.npz`` (or .json) for
the pytest process to hold against the JAX package and the single-device
port.
"""

import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist

SMALL = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4, eq_n=32, steps=2,
             search_round=1, fpcs=True, calib_size=8, calib_batch_size=8)
# family searches: test_calib_search's numbers
FAMILY_KW = dict(eq_n=32, steps=3, rounds=2, use_fpcs=True)
QS = np.array([0.9, 1.0, 0.1, 0.0, 0.5, 0.37], np.float32)
RECON = dict(recon_iters=20, optim_size=8)


def sub_mesh(dp):
    """A dp mesh over ranks 0..dp-1 of the world (every rank makes the
    group; the rest get None)."""
    from adalog_tpu_torch.parallel.mesh import Mesh

    group = dist.new_group(list(range(dp)))
    rank = dist.get_rank()
    if rank >= dp:
        return None
    return Mesh(dp, 1, rank, 0, group, None, torch.device("cpu"), "gloo")


def model(work, name):
    """(spec, the model with the JAX package's weights of ``name``, as the
    pytest process saved them)."""
    from adalog_tpu_torch.models import zoo

    spec, m = zoo.build_model(name, seed=0)
    m.load_state_dict(torch.load(os.path.join(work, f"{name}.pt")))
    return spec, m


def _save(work, what, **arrays):
    np.savez(os.path.join(work, f"{what}_r{dist.get_rank()}.npz"), **arrays)


def _flat(prefix, tree):
    """{prefix.path: numpy} of every tensor of a site state or a dict."""
    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(_flat(f"{prefix}.{f.name}", getattr(tree, f.name)))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(f"{prefix}.{k}", v))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(f"{prefix}.{i}", v))
    return out


# ---------------------------------------------------------------------------
# order statistics
# ---------------------------------------------------------------------------

def order_stats(work, mesh, cases):
    """Each case's sharded ``quantile`` / ``positive_percentile`` on this
    rank's ``dp_split`` of the case's array (along its shard dim)."""
    from adalog_tpu_torch.calib.candidates import positive_percentile, quantile
    from adalog_tpu_torch.parallel.mesh import dp_split

    if mesh is None:
        return
    inputs = np.load(os.path.join(work, "inputs.npz"))
    qs = torch.from_numpy(QS)
    out = {}
    for name, kind, shard, dim in cases:
        x = dp_split(torch.from_numpy(inputs[name]), mesh, shard)
        if kind == "positive":
            got = positive_percentile(x.reshape(-1), qs, mesh)
        else:
            got = quantile(x, qs, dim=dim, mesh=mesh)
        out[name] = got.numpy()
    if mesh.dp_index == 0:
        np.savez(os.path.join(work, f"order_dp{mesh.dp}.npz"), **out)


# ---------------------------------------------------------------------------
# capture, the search families, whole calibrations
# ---------------------------------------------------------------------------

def capture(work, mesh, keys):
    """This rank's taps of each batch in ``keys``."""
    from adalog_tpu_torch.calib.calibrator import capture_all_sites

    inputs = np.load(os.path.join(work, "inputs.npz"))
    spec, m = model(work, "test_tiny")
    for key in keys:
        taps = capture_all_sites(spec, m, [inputs[key]], mesh=mesh)
        _save(work, f"capture_{key}_dp{mesh.dp}",
              **{f"{nm}.{i}": t.numpy() for nm, tup in taps.items()
                 for i, t in enumerate(tup)})


def families(work, mesh, cases):
    """Each family's search (calib/search.py) inside ``dp_context`` on this
    rank's images of the test_tiny taps in ``inputs.npz``: (fn name, the
    tap keys of its tensor arguments, the image axis of each, kwargs)."""
    from adalog_tpu_torch.calib import search as S
    from adalog_tpu_torch.parallel.mesh import dp_context, dp_split

    inputs = np.load(os.path.join(work, "inputs.npz"))
    out = {}
    with torch.no_grad(), dp_context(mesh):
        for name, fn, keys, axes, kw in cases:
            args = []
            for k, ax in zip(keys, axes):
                if k == "shift":
                    args.append(float(inputs[k]))
                    continue
                a = torch.from_numpy(inputs[k])
                if ax is not None:
                    a = dp_split(a, mesh, ax)
                    # the token forms: (.., N, S, C) -> (.., N * S, C)
                    if kw.get("_tokens"):
                        a = a.reshape(a.shape[:ax] + (-1, a.shape[-1]))
                args.append(a)
            kw = {k: v for k, v in kw.items() if not k.startswith("_")}
            res = getattr(S, fn)(*args, **kw)
            for i, r in enumerate(res):
                out[f"{name}.{i}"] = r.numpy()
    _save(work, "families", **out)


def calibrate(work, mesh, runs):
    """Whole calibrations of ``inputs.npz``'s ``images`` over ``mesh``:
    each run (tag, model, config overrides) saves this rank's calibrated
    model and state as a v2 checkpoint."""
    from adalog_tpu_torch.calib import calibrator as C
    from adalog_tpu_torch.utils.checkpoint import save_checkpoint
    from adalog_tpu_torch.utils.config import Config

    images = np.load(os.path.join(work, "inputs.npz"))["images"]
    rank = dist.get_rank()
    for tag, model_name, over in runs:
        spec, m = model(work, model_name)
        cfg = Config(**dict(SMALL, **over))
        c = C.QuantCalibrator(spec, m, cfg, mesh=mesh, device="cpu")
        p, q = c.calibrate([images])
        save_checkpoint(os.path.join(work, f"{tag}_r{rank}.ckpt"), p, q)


def resume(work, mesh, model_name, cut):
    """A calibration with a resume file, stopped by an error in every rank
    after ``cut`` sites have been searched, then resumed to its end; counts
    this rank's writes to the file."""
    from adalog_tpu_torch.calib import calibrator as C
    from adalog_tpu_torch.utils.checkpoint import save_checkpoint
    from adalog_tpu_torch.utils.config import Config

    images = np.load(os.path.join(work, "inputs.npz"))["images"]
    path = os.path.join(work, "mesh.resume")
    writes = []
    real_append = C.resume_append

    def counting(p, recs):
        writes.append(len(recs))
        return real_append(p, recs)

    C.resume_append = counting
    spec, m = model(work, model_name)
    cfg = Config(**SMALL, batch_sites=False)
    first = C.QuantCalibrator(spec, m, cfg, mesh=mesh, device="cpu",
                              resume_path=path)
    real_set = first._set_linear_state

    class Stop(Exception):
        pass

    def stopping(*a, **k):
        real_set(*a, **k)
        if len(first.qstate) >= cut:
            raise Stop
    first._set_linear_state = stopping
    try:
        first.calibrate([images])
        raise AssertionError("the calibration was not stopped")
    except Stop:
        pass
    done_at_cut = len(first.qstate)
    second = C.QuantCalibrator(spec, m, cfg, mesh=mesh, device="cpu",
                               resume_path=path)
    p, q = second.calibrate([images])
    C.resume_append = real_append
    save_checkpoint(os.path.join(work, f"resumed_r{dist.get_rank()}.ckpt"),
                    p, q)
    with open(os.path.join(work, f"resume_r{dist.get_rank()}.json"),
              "w") as f:
        json.dump({"writes": sum(writes), "done_at_cut": done_at_cut}, f)


# ---------------------------------------------------------------------------
# reconstruction
# ---------------------------------------------------------------------------

def reconstruct(work, mesh, cases):
    """BRECQ over ``mesh`` from the calibrated checkpoint ``calibrated.ckpt``
    on ``inputs.npz``'s ``images`` (two batches of 4): per case (tag,
    optim_batch_size), each unit's trained alphas and scales, the first
    step's gradients, the unit stats and the block-I/O rows this rank
    held."""
    from adalog_tpu_torch.calib.layout import quant_layout
    from adalog_tpu_torch.utils.checkpoint import load_checkpoint

    images = np.load(os.path.join(work, "inputs.npz"))["images"]
    spec, m = model(work, "test_tiny")
    params, qstate, _ = load_checkpoint(os.path.join(work, "calibrated.ckpt"),
                                        spec.cfg)
    for tag, batch in cases:
        r, out, rows = recorded_recon(spec, params, m, qstate, batch, mesh,
                                      quant_layout)
        r.reconstruct([images[:4], images[4:]])
        _save(work, f"recon_{tag}", **out)
        with open(os.path.join(work, f"recon_{tag}_r{dist.get_rank()}.json"),
                  "w") as f:
            json.dump({"rows": rows, "stats": r.unit_stats}, f)


def recorded_recon(spec, params, full, qstate, batch, mesh, quant_layout):
    """A BlockReconstructor at SMALL + RECON whose reconstruct keeps, in
    the returned dicts, the gradients of its first optimizer steps
    (``grad0.w.*``, ``grad0.a.*``), every unit's trained leaves
    (``trained.<unit>.*``) and the block-I/O rows captured per unit."""
    from adalog_tpu_torch.recon import brecq as B
    from adalog_tpu_torch.utils.config import Config

    cfg = Config(**SMALL, **RECON, optim_batch_size=batch)
    r = B.BlockReconstructor(spec, params, full, qstate,
                             quant_layout(spec, cfg), cfg, mesh=mesh,
                             device="cpu")
    out, rows = {}, {}
    train = r._train_block

    def recording_train(unit, *a, **k):
        # the first two optimizer steps (alphas, then activation scales)
        # are the first unit's first step
        real_step, calls = B._Adam.step, []

        def step(opt, grads):
            if len(calls) < 2:
                calls.append("wa"[len(calls)])
                out.update({f"grad0.{calls[-1]}.{i}": (
                    torch.zeros_like(p) if g is None else g).numpy()
                    for i, (g, p) in enumerate(zip(grads, opt.params))})
            return real_step(opt, grads)

        if not out:
            B._Adam.step = step
        try:
            tr, r0, r1 = train(unit, *a, **k)
        finally:
            B._Adam.step = real_step
        out.update(_flat(f"trained.{unit.name}", tr))
        return tr, r0, r1

    r._train_block = recording_train
    capture = B.capture_block_io

    def counting(*a, **k):
        io = capture(*a, **k)
        rows.update({nm: int(t[0].shape[0]) for nm, t in io.items()})
        B.capture_block_io = capture
        return io
    B.capture_block_io = counting
    return r, out, rows


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def cli(argvs, n_val):
    """The port's CLI in every rank, once for each argv, on a synthetic val
    set of ``n_val`` images."""
    import argparse

    import adalog_tpu_torch.data.imagenet as data
    from adalog_tpu_torch import cli as c
    from torch_parallel_ranks import small_synthetic_init

    data.SyntheticLoader.__init__ = small_synthetic_init(n_val)
    for argv in argvs:
        c.main(argparse.ArgumentParser(
            parents=[c.get_args_parser()]).parse_args(argv))


# ---------------------------------------------------------------------------
# the suites: one spawn each
# ---------------------------------------------------------------------------

def suite(work, plan):
    """Run the steps of ``plan`` (a list of (step name, kwargs)) in order in
    every rank; the dp mesh over the whole world unless a step names its
    own dp."""
    from adalog_tpu_torch.parallel.mesh import make_mesh

    torch.manual_seed(0)
    world = make_mesh(device="cpu")
    for step, kw in plan:
        kw = dict(kw)
        dp = kw.pop("dp", None)
        if step == "cli":
            cli(**kw)
            continue
        mesh = world if dp is None or dp == world.dp else sub_mesh(dp)
        globals()[step](work, mesh, **kw)


def card_calibrate(work):
    """test_tiny calibrated over dp=2 ranks on cuda:0 through gloo (NCCL
    refuses two ranks on one card); each rank saves its model and state."""
    from adalog_tpu_torch.calib.calibrator import QuantCalibrator
    from adalog_tpu_torch.models import zoo
    from adalog_tpu_torch.parallel.mesh import make_mesh
    from adalog_tpu_torch.utils.checkpoint import save_checkpoint
    from adalog_tpu_torch.utils.config import Config

    mesh = make_mesh(device="cuda:0", backend="gloo")
    spec, m = zoo.build_model("test_tiny", seed=0)
    images = np.load(os.path.join(work, "images.npy"))
    p, q = QuantCalibrator(spec, m, Config(**SMALL), mesh=mesh,
                           device=mesh.device).calibrate([images])
    save_checkpoint(os.path.join(work, f"card_r{mesh.rank}.ckpt"), p, q)
