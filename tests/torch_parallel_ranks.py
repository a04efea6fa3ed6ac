"""Rank entry points of tests/test_torch_parallel.py, each run in every rank
of a process group by ``adalog_tpu_torch.parallel.mesh.spawn``.

A spawned rank imports the module of its entry point, so this module
imports torch and the port only: no jax, nothing of adalog_tpu. The JAX
side of each comparison is computed in the pytest process; inputs and
results cross as .npz / .json files in the test's directory.
"""

import json
import os

import numpy as np
import torch
import torch.distributed as dist

W4A4 = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4)


def small_synthetic_init(n_val):
    """A ``SyntheticLoader.__init__`` for a val set of ``n_val`` images of
    test_tiny's 10 classes at the caller's batch size."""
    def init(self, spec, val_batch_size=200, *args, **kwargs):
        self.spec, self.val_batch_size = spec, val_batch_size
        self.n_val, self.num_classes, self.seed = n_val, 10, 0
    return init


class _Spy:
    """Counts wrapper calls and records the site names whose route the
    forward reads, by the kernel it names (K4 or K5), in this rank."""

    def __init__(self):
        from adalog_tpu_torch.ops import fq_attn, fq_gemm, int8_linear, routes

        self.looked_up = {"K4": set(), "K5": set()}
        kernel = {"fq_gemm": "K4", "int8": "K5"}
        real = routes.Plan.route

        def route(plan, name, *a):
            r = real(plan, name, *a)
            if r.kind in kernel:
                self.looked_up[kernel[r.kind]].add(name)
            return r

        routes.Plan.route = route
        self.wrappers = {"K1": fq_attn.fq_flash_attn, "K4": fq_gemm.fq_gemm,
                         "K5": int8_linear.int8_gemm}

    def zero(self):
        for w in self.wrappers.values():
            w.calls = 0

    def read(self):
        return {k: w.calls for k, w in self.wrappers.items()}


def predictor_cases(workdir, cases):
    """Serve each case's checkpoint through ``load_quantized`` over the
    case's mesh and write, per rank, the logits of each input batch and the
    calls of K1, K4 and K5 for each batch, and the sites whose route took
    the GEMM (K4) and int8 (K5) kernels."""
    from adalog_tpu_torch.serve import load_quantized
    from adalog_tpu_torch.utils.config import Config

    rank = dist.get_rank()
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    spy = _Spy()
    for case in cases:
        cfg = Config(**W4A4, use_pallas_gemm=case["gemm"],
                     eval_int8=case["int8"])
        predict, *_ = load_quantized(
            case["model"], case["ckpt"], config=cfg, eval_dtype=case["dtype"],
            device="cpu", mesh_devices=case["dp"] * case["tp"],
            mesh_tp=case["tp"])
        out, calls = {}, []
        for key in case["inputs"]:
            spy.zero()
            out[key] = predict(inputs[key]).numpy()
            calls.append(spy.read())
        np.savez(os.path.join(workdir, f"{case['name']}_r{rank}.npz"), **out)
        with open(os.path.join(workdir, f"{case['name']}_r{rank}.json"),
                  "w") as f:
            json.dump({"calls": calls, "looked_up": {
                k: sorted(v) for k, v in spy.looked_up.items()}}, f)
        for v in spy.looked_up.values():
            v.clear()


def cli_run(argv, n_val):
    """The port's CLI in every rank, on a synthetic val set of ``n_val``
    images."""
    import argparse

    import adalog_tpu_torch.data.imagenet as data
    from adalog_tpu_torch import cli

    data.SyntheticLoader.__init__ = small_synthetic_init(n_val)
    args = argparse.ArgumentParser(
        parents=[cli.get_args_parser()]).parse_args(argv)
    cli.main(args)
