"""The port's CLI — the reference test_quant.py surface, preserved:

  python -m adalog_tpu_torch.cli --model deit_small --config configs/4bit.py
      --dataset /path/imagenet [--calibrate | --load-calibrate-checkpoint P]
      [--test-calibrate-checkpoint] [--optimize | --load-optimize-checkpoint P]
      [--test-optimize-checkpoint] [--calib-size N] [--calib-batch-size N]
      [--val-batch-size N] [--w_bit N] [--a_bit N] [--s_bit N] [--seed N]
      [--device cuda|cpu]

The counterpart of ``adalog_tpu.cli``, flag for flag: the mutually exclusive
calibrate / load groups, the timestamped run dir with collision retry
(test_quant.py:21-29), file + stdout logging, config-file import with CLI
overrides (test_quant.py:139-152) and the same orchestration (197-241).
Additions of the JAX package kept: --synthetic-data, --checkpoint-path (timm
weights), --eval-dtype, --no-augment-calib, --crop-pct, --resume, --profile
(a torch.profiler trace of calibration). ``--device`` defaults to the first
CUDA device, as the reference's did; model, calibrator, reconstructor and
predictor all run there, and with no card the run raises unless
``--device cpu`` is given. One device only: ``--mesh-devices`` above one and
``--mesh-tp`` above one raise NotImplementedError, as does ``eval_int8``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import logging
import os
import time
from datetime import datetime

import numpy as np
import torch

log = logging.getLogger("adalog_tpu_torch")

MODELS = ["vit_tiny", "vit_small", "vit_base", "vit_large", "deit_tiny",
          "deit_small", "deit_base", "swin_tiny", "swin_small", "swin_base",
          "swin_base_384", "test_tiny", "test_tiny_swin"]


def get_args_parser():
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--model", default="deit_small", choices=MODELS)
    p.add_argument("--config", type=str, default="./configs/4bit.py",
                   help="path to a .py file defining Config")
    p.add_argument("--dataset", default="/dataset/imagenet/")
    p.add_argument("--calib-size", default=argparse.SUPPRESS, type=int)
    p.add_argument("--calib-batch-size", default=argparse.SUPPRESS, type=int)
    p.add_argument("--val-batch-size", default=200, type=int)
    p.add_argument("--num-workers", default=8, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device of the whole run; 'cuda' raises where "
                        "torch finds no CUDA device")

    cal = p.add_mutually_exclusive_group()
    cal.add_argument("--calibrate", action="store_true")
    cal.add_argument("--load-calibrate-checkpoint", type=str, default=None)
    p.add_argument("--test-calibrate-checkpoint", action="store_true")

    opt = p.add_mutually_exclusive_group()
    opt.add_argument("--optimize", action="store_true")
    opt.add_argument("--load-optimize-checkpoint", type=str, default=None)
    p.add_argument("--test-optimize-checkpoint", action="store_true")

    p.add_argument("--print-freq", default=10, type=int)
    p.add_argument("--seed", default=5, type=int)
    p.add_argument("--w_bit", type=int, default=argparse.SUPPRESS)
    p.add_argument("--a_bit", type=int, default=argparse.SUPPRESS)
    p.add_argument("--s_bit", type=int, default=argparse.SUPPRESS)
    p.add_argument("--checkpoint-path", type=str, default=None,
                   help="timm-format pretrained weights; defaults to "
                        "./checkpoints/vit_raw/<timm_id>.bin when present")
    p.add_argument("--synthetic-data", action="store_true",
                   help="use a deterministic synthetic dataset")
    p.add_argument("--eval-dtype", default=None,
                   choices=[None, "float32", "bfloat16"])
    p.add_argument("--output-dir", default="./checkpoints/quant_result")
    p.add_argument("--no-augment-calib", action="store_true",
                   help="use the deterministic eval transform for the "
                        "calibration set instead of the reference's "
                        "training-transform distribution")
    p.add_argument("--crop-pct", type=float, default=None,
                   help="override the model spec's eval crop percentage "
                        "(timm resolve_data_config parity tuning)")
    p.add_argument("--profile", action="store_true",
                   help="trace calibration with torch.profiler into the run "
                        "dir (trace/trace.json; Perfetto or TensorBoard)")
    p.add_argument("--resume", type=str, default=None, metavar="PATH",
                   help="calibration / reconstruction resume file: an "
                        "interrupted run restarts where it left off (the "
                        "JAX package's framed file format)")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="0, 1 or -1 (all local devices) on one device; "
                        "more devices are not ported")
    p.add_argument("--mesh-tp", type=int, default=1,
                   help="tensor-parallel eval factor; only 1 is ported")
    return p


def make_run_dir(base: str) -> str:
    """Timestamped run dir with collision retry (test_quant.py:21-29)."""
    while True:
        stamp = datetime.now().strftime("%Y%m%d_%H%M")
        path = os.path.join(base, stamp)
        try:
            os.makedirs(path)
            return path
        except FileExistsError:
            time.sleep(10)


def setup_logging(run_dir: str):
    logging.basicConfig(
        level=logging.INFO, format="%(message)s",
        handlers=[logging.FileHandler(os.path.join(run_dir, "output.log")),
                  logging.StreamHandler()], force=True)


def seed_all(seed: int):
    np.random.seed(seed)
    torch.manual_seed(seed)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA device; pass --device cpu to "
                           "run on the CPU")
    return device


def check_mesh(args, device: torch.device):
    """One device: --mesh-devices 0, 1 or -1 (all local devices, one here)
    and --mesh-tp 1; anything else is multi-device, not ported."""
    n = args.mesh_devices
    if n == -1:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > 1 or args.mesh_tp > 1:
        raise NotImplementedError(
            f"--mesh-devices {args.mesh_devices} / --mesh-tp {args.mesh_tp}: "
            "multi-device calibration and serving are not ported to PyTorch "
            "yet")


def main(args):
    from adalog_tpu_torch.calib.calibrator import QuantCalibrator
    from adalog_tpu_torch.calib.layout import quant_layout
    from adalog_tpu_torch.data.imagenet import ImageNetLoader, SyntheticLoader
    from adalog_tpu_torch.models.zoo import build_model, model_spec
    from adalog_tpu_torch.ops.kernel_defaults import resolve_kernel_config
    from adalog_tpu_torch.quantizers.state import map_tensors
    from adalog_tpu_torch.recon.brecq import BlockReconstructor
    from adalog_tpu_torch.serve import make_predictor
    from adalog_tpu_torch.utils.checkpoint import (
        checkpoint_name, load_checkpoint, save_checkpoint,
    )
    from adalog_tpu_torch.utils.config import load_config
    from adalog_tpu_torch.utils.metrics import validate

    device = resolve_device(args.device)
    check_mesh(args, device)
    run_dir = make_run_dir(args.output_dir)
    setup_logging(run_dir)
    log.info("%s - start the process.", datetime.now())
    log.info("%s", args)

    cfg = load_config(args.config)
    for f in ("calib_size", "calib_batch_size", "w_bit", "a_bit", "s_bit"):
        if hasattr(args, f):
            setattr(cfg, f, getattr(args, f))
    if args.eval_dtype:
        cfg.eval_dtype = args.eval_dtype
    for name, value in vars(cfg).items():
        log.info("%s: %s", name, value)

    seed_all(args.seed)

    log.info("Building model ...")
    spec = model_spec(args.model)
    ckpt = args.checkpoint_path
    if ckpt is None:
        default = f"./checkpoints/vit_raw/{spec.timm_id}.bin"
        ckpt = default if os.path.exists(default) else None
        if ckpt is None:
            log.warning("no pretrained weights found at %s; using random "
                        "init (accuracy numbers will be meaningless)", default)
    spec, params = build_model(args.model, checkpoint_path=ckpt,
                               seed=args.seed, device=device)
    if args.crop_pct is not None:
        spec = dataclasses.replace(spec, crop_pct=args.crop_pct)
    params_full = copy.deepcopy(params)   # pristine FP32 twin for BRECQ

    log.info("Building dataloaders ...")
    if args.synthetic_data or not os.path.isdir(args.dataset):
        if not args.synthetic_data:
            log.warning("dataset %s not found; falling back to synthetic data",
                        args.dataset)
        loader = SyntheticLoader(spec, args.val_batch_size)
    else:
        loader = ImageNetLoader(args.dataset, spec, args.val_batch_size,
                                args.num_workers)

    reparam = (args.load_calibrate_checkpoint is None and
               args.load_optimize_checkpoint is None)
    qstate = None

    resolve_kernel_config(cfg, spec)   # None = auto -> measured per-model
    log.info("eval kernels: use_pallas=%s use_pallas_gemm=%s eval_int8=%s",
             cfg.use_pallas, cfg.use_pallas_gemm, cfg.eval_int8)
    if cfg.eval_int8:
        raise NotImplementedError(
            "eval_int8: the int8 GEMM path is not ported to PyTorch yet")

    def eval_forward(p, qs):
        return make_predictor(
            spec, p, qs, eval_dtype=cfg.eval_dtype, cfg=cfg,
            use_kernels=bool(cfg.use_pallas),
            use_gemm_kernels=bool(cfg.use_pallas_gemm), device=device)

    def load_any_checkpoint(path):
        """Route by format: the reference's torch.save(state_dict)
        .pth/.pt/.bin (test_quant.py:109-127 semantics), or a native .ckpt
        (v2, or the JAX package's round-1 pickle); on the run's device."""
        if path.endswith((".pth", ".pt", ".bin")):
            from adalog_tpu_torch.utils.ref_checkpoint import \
                load_reference_checkpoint
            log.info("loading reference-format (torch state_dict) checkpoint")
            p2, qs = load_reference_checkpoint(spec, cfg, path, params)
        else:
            p2, qs, _ = load_checkpoint(path, spec.cfg)
        return (p2.to(device), map_tensors(lambda t: t.to(device), qs))

    calibrator = QuantCalibrator(spec, params, cfg, reparam=reparam,
                                 resume_path=args.resume, device=device)

    if not args.load_optimize_checkpoint:
        if args.load_calibrate_checkpoint:
            log.info("Restoring checkpoint from '%s'",
                     args.load_calibrate_checkpoint)
            params, qstate = load_any_checkpoint(
                args.load_calibrate_checkpoint)
            calibrator.params, calibrator.qstate = params, dict(qstate)
            if args.test_calibrate_checkpoint:
                validate(loader.val_loader(), eval_forward(params, qstate),
                         args.print_freq)
        else:
            log.info("%s - start calibration", datetime.now())
            t0 = time.time()
            calib_kw = ({"augment": not args.no_augment_calib}
                        if hasattr(loader, "_train") else {})
            batches = loader.calib_batches(cfg.calib_size,
                                           cfg.calib_batch_size, args.seed,
                                           **calib_kw)
            if args.profile:
                from adalog_tpu_torch.utils.profiling import device_trace
                with device_trace(os.path.join(run_dir, "trace")):
                    params, qstate = calibrator.calibrate(batches)
            else:
                params, qstate = calibrator.calibrate(batches)
            if not args.optimize:
                params, qstate = calibrator.finish_calibration()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            log.info("%s - calibration finished in %.1fs.",
                     datetime.now(), time.time() - t0)
            save_checkpoint(
                os.path.join(run_dir, checkpoint_name(args.model, cfg,
                                                      "calibrate")),
                params, qstate)
            log.info("Validating after calibration ...")
            validate(loader.val_loader(), eval_forward(params, qstate),
                     args.print_freq)

    calib_loader_batches = None
    if args.optimize and qstate is None:
        raise SystemExit("--optimize requires a calibrated model: pass "
                         "--calibrate or --load-calibrate-checkpoint")
    if args.optimize:
        log.info("%s - start block reconstruction", datetime.now())
        t0 = time.time()
        calib_loader_batches = loader.calib_batches(
            cfg.optim_size, cfg.optim_batch_size, args.seed)
        recon = BlockReconstructor(spec, params, params_full, qstate,
                                   quant_layout(spec, cfg, reparam), cfg,
                                   resume_path=args.resume, device=device)
        params, qstate = recon.reconstruct(calib_loader_batches,
                                           quant_act=cfg.train_act)
        calibrator.params, calibrator.qstate = params, dict(qstate)
        params, qstate = calibrator.finish_calibration()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log.info("%s - block reconstruction finished in %.1fs.",
                 datetime.now(), time.time() - t0)
        save_checkpoint(
            os.path.join(run_dir, checkpoint_name(args.model, cfg,
                                                  "optimize")),
            params, qstate)
    if args.load_optimize_checkpoint:
        params, qstate = load_any_checkpoint(args.load_optimize_checkpoint)
        calib_loader_batches = loader.calib_batches(
            cfg.optim_size, cfg.optim_batch_size, args.seed)
    if args.optimize or args.test_optimize_checkpoint:
        log.info("Validating on calibration set after block reconstruction ...")
        f = eval_forward(params, qstate)
        calib_iter = zip(calib_loader_batches,
                         loader.calib_labels(cfg.optim_batch_size))
        validate(calib_iter, f, args.print_freq)
        log.info("Validating on test set after block reconstruction ...")
        validate(loader.val_loader(), f, args.print_freq)
    log.info("%s - finished the process.", datetime.now())
    return params, qstate


def run():
    parser = argparse.ArgumentParser(parents=[get_args_parser()])
    main(parser.parse_args())


if __name__ == "__main__":
    run()
