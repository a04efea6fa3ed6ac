"""Drive the PyTorch/CUDA port (adalog_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # every phase, each a hard check
    python3 chip_smoke.py --profile    # phases 1-2, then the profiles below

Phases, each a hard check (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
  2. build the four kernel sources with nvcc, one process each, started
     together: K1 (csrc/fq_flash_attn.cu), K2 and K3
     (csrc/fq_attn_matmul.cu), K4 (csrc/fq_gemm.cu) and K5
     (csrc/int8_gemm.cu, variants "wgmma" and "mma"); each kernel's
     registers and static shared memory are printed, none may spill, and
     the compiler may not serialize a wgmma;
  3. K1 kernel phase: the fused attention kernel against its plain PyTorch
     version at the deit_small attention shapes (batch 64: G=384, S=197,
     D=64), fp32 and bf16, with and without a (6, S, S) bias, per-slice
     scales and AdaLog bases other than 37, as the wrapper routes it
     (variant "mma", asserted); variant "fma" forced at the same shape in
     fp32, and taken by the routing at S=300; "mma" at swin_tiny's two
     window shapes with their bias; max|diff|, share past tolerance,
     median times of one call a timing, of ten in a row, and of ten
     replayed from a CUDA graph (the device alone);
  4. K4 kernel phase: the fused activation-quant GEMM against its plain
     version at the five deit_small Linear shapes of batch 32 (T=6304:
     qkv 384->1152, proj 384->384, fc1 384->1536, fc2 1536->384 in both
     kinds; the head at T=32, 384->1000) and at swin_tiny's longest and
     deepest Linear (T=100352, 96->288; T=1568, 3072->768, adalog_shift),
     fp32 and bf16, on a weight fake-quantized to 4 bits with its integer
     codes as a served site has it: as the wrapper routes it (variant
     "mma", asserted), variant "fma" forced, and in fp32 a bare call
     without codes (must take "fma"): max|diff|, share past tolerance, the
     quantized activations themselves (through an identity weight: uniform
     bit for bit, AdaLog flips bounded; fp32 "mma" forms an AdaLog value
     as (steps * 2^-shift) * (ts * s), held to 2 ulp), the fused bias equal
     to the unfused add bit for bit, median times of one call a timing, of
     ten in a row, and of ten replayed from a CUDA graph (the device
     alone);
  5. K2/K3 kernel phase: the fused attention matmuls against their plain
     versions at the attention shapes of batch 32 of deit_small (G=192,
     S=197, D=64) and of swin_tiny's first and last stage (S=49, D=32,
     G=6144 and 768), fp32 and bf16: K3 on q @ kT (uniform A), K3 on
     probabilities @ v (AdaLog A), K2 on logits and v, each as the wrapper
     routes it (variant "mma", asserted; share past tolerance and a cap of
     one probability times the largest |uq(B)|) and with variant "fma"
     forced (bit for bit), timed as one call, ten in a row and ten replayed
     from a CUDA graph; K2 at S=300 as routed ("fma", asserted); and K2 on
     the plain matmul1's logits against K1 on the same q, kT, v (fp32):
     "fma" against "fma" bit for bit, "mma" against "mma" to K1's own
     tolerance;
  6. serving phase, for deit_small and for swin_tiny (embed 96, depths
     2-2-6-2, heads 3-6-12-24, window 7, 224 px), each at full depth and
     width with random weights from a numpy seed and a smoke quantizer
     state whose fc2 biases carry the folded GeLU shift (calib/reparam.py):
     K1 against its plain version on the q/kT/v of all 12 blocks (for
     swin_tiny with each block's rel-pos bias and, in the shifted blocks,
     its mask) and K4, called as the served path calls it (the table entry
     with its weight codes; every launch "mma", asserted), against its plain
     version on the inputs of all 49 (deit_small) or 52 (swin_tiny) Linear
     sites (block check); then the
     state saved as a v2 .ckpt and served through load_quantized in float32
     and bfloat16, with the attention kernel only, with the attention and
     GEMM kernels, and plain, on 4 batches of 32 images each: per batch K1
     must run 12 times with either kernel switch on and K4 49 or 52 times
     with the GEMM switch on (0 off), K2 and K3 never, and every K1 and
     every K4 launch is variant "mma"; logits finite and of
     the right shape; img/s and the agreement of the logits between the
     settings are reported;
  7. fall-back phase, for both models: K2 and K3 against their plain
     versions, and against the forward with the kernels off, on the tensors
     all 12 attentions of the quantized model form (block check); then the
     three configurations that reach them, launch counts asserted: a
     post_softmax_quantizer='log2' state served through load_quantized (K3
     12 times a batch), a quant-mode forward with capture=True (K3 24
     times), and the forward's modes with every matmul1 site 'raw' (K2 12
     times); every one of these launches is variant "mma", asserted;
  8. calibration phase: deit_small at full depth and width, random weights
     from the numpy seed (no smoke state, no hand fold), calibrated on the
     card through QuantCalibrator.calibrate and finish_calibration at the
     shipped configs/4bit.py numbers from 32 images, twice (cold, then
     warm): wall-clock, the capture and each search family apart, peak
     device memory, the card's name and power limit; every layout site has
     a state and every AdaLog base is a positive integer fq_gemm.prepare
     takes; on 32 held-out images its logit MSE to the raw model must be
     below the min/max smoke state's; then the state saved, block-checked
     and served as in phase 6 (K1 12 and K4 49 launches a batch asserted;
     each launch's variant printed, the reason for any "fma"); and
     test_tiny calibrated at the same numbers on the card and on the CPU:
     integer picks exact or adjacent, scales to a stated tolerance;
  9. int8 phase: K5, the int8 GEMM of eval_int8, both variants forced
     ("wgmma" where wgmma_refusal takes the shape, "mma" everywhere)
     against the plain version bit for bit, with and without the bias, at
     deit_small's int8 sites at batch 32 (qkv, proj, fc1, the head),
     deit_base's three block sites, vit_large's three and its head,
     swin_base_384's stage 0 qkv, stage 2 fc1 and stage 2-3 reduction, and
     two ragged shapes ("wgmma" must take every shape but the ragged ones,
     whose reason is printed; the routed call takes the variant
     int8_variant names), fp32 and bf16, each variant timed as K4 (one
     call, ten in a row, ten from a CUDA graph) beside torch._int_mm on the
     activation codes (the product alone; one call and from a CUDA graph),
     the sums over deit_small's four sites printed; then
     the calibrated deit_small of phase 8 and the smoke swin_tiny: every
     int8 site through K5 against the fake-quant path on the same inputs
     (block check, fp32), then served through load_quantized with
     eval_int8, with the attention kernel and with the attention and GEMM
     kernels, fp32 and bf16: per batch K5 37 (deit_small) or 40 (swin_tiny)
     times, every launch "wgmma" (the heads' 32 rows too), K1 12, K4 12
     (the AdaLog fc2 sites) with the GEMM switch, else 0; img/s; then
     site_error_report on the calibrated deit_small (its top rows and
     seconds) and its export round trip (export_quantized, then
     load_exported on the card, logits against the plain predictor);
 10. reconstruction phase: BRECQ (BlockReconstructor.reconstruct) on the
     warm calibration's deit_small state before the post-GeLU fold, all 14
     units on the card in exact fp32 with train_act, RECON_ITERS steps on
     RECON_OPTIM_SIZE images of standard-normal pixels, the kernel launch
     counts asserted 0 across it; per unit rec first / last, seconds, ms a
     step and peak device memory, the total, and the shipped 20000-step run
     extrapolated from the ms a step; every loss finite, the geometric mean
     of rec last / first below 1, the frozen weights on their grid, every
     post-softmax AdaLog scale exactly 1; then the fold, the held-out logit
     MSE to the raw model of the reconstructed and the calibrated state
     (reported), the state saved, block-checked and served as in phase 6
     (K1 12 and K4 49 launches a batch, every launch "mma"); and test_tiny
     reconstructed on the card and on the CPU from one CPU calibration:
     flipped hard decisions, activation scales and recs to stated bounds;
 11. CLI phase: the reference-compatible CLI (adalog_tpu_torch.cli.main,
     what `python -m adalog_tpu_torch.cli` runs) on deit_small at full
     depth and width with its own random weights from a seed, on a train/
     and val/ ImageFolder of 4 classes x 16 JPEGs each at odd sizes written
     from seeded noise (the decoder used, native or PIL, printed):
     --calibrate at configs/4bit.py, its checkpoint held to a direct
     QuantCalibrator run on the same calib_batches (every integer pick
     equal, scales within the calibration phase's tolerance) and its logged
     Prec@1 / Prec@5 to make_predictor's own on the same val batches
     (hits equal); the checkpoint loaded with use_pallas_gemm on and
     validated, then exported to a reference .pth and loaded the same way
     (hits equal, logits within CLI_PTH_ATOL); loaded and validated with a
     config that sets eval_int8; --load-calibrate-checkpoint --optimize at
     CLI_RECON_ITERS steps on CLI_OPTIM_SIZE images (an optimize checkpoint
     saved, the calibration set and val validated). Launches per
     validation batch asserted: K1 12 every run, K4 49 with the GEMM
     switch, else 0, K5 37 with eval_int8 (all "wgmma"), else 0. The
     decoder used (and
     the compiler's error if the native one did not build) is printed. Each run's seconds and each validation's
     img/s and the loader's share of its wall time are printed;
 12. mesh phase (run after phase 7): serving over a mesh of ranks, spawned
     with torch.multiprocessing (start method spawn) once the kernels are
     built, every rank on cuda:0 with backend gloo (the machine shows one
     card, and NCCL refuses two ranks on one device; the nccl path is not
     run); each case loaded through load_quantized(mesh_devices=,
     mesh_tp=) with the attention and GEMM kernels at full width:
     deit_small tp=2 in fp32, bf16 and with eval_int8, deit_small dp=2 and
     swin_tiny tp=2 (stage 0's 3 heads keep its attention whole) in two
     ranks, test_tiny dp=2 x tp=2 in four. Per rank, 4 batches of 32 with
     the launch counts set to 0 just before and read just after, asserted
     (MESH_LAUNCHES: deit_small tp=2 K1 12, K4 25, with eval_int8 K5 25,
     all "wgmma";
     dp=2 K1 12, K4 49; swin_tiny tp=2 K1 12, K4 30; K4 and K5 never at
     the row-parallel sites), every K1 and K4 launch "mma"; each rank's
     kernels held to their plain versions on its own batch slice and
     weight and head slices (block checks, phase 6's bounds); rank 0's
     gathered logits against the single-device predictor on the same card
     (max|diff| and top-1 agreement reported; test_tiny's within 2e-4, the
     JAX package's own tolerance) and its img/s, labelled as ranks sharing
     one card through gloo, not a scaling number;
 13. mesh calibration phase (run after phase 8): the calibration of phase
     8 over dp=2 ranks on cuda:0 through gloo (QuantCalibrator(mesh=):
     each rank captures its 16 images, every token sum an all_reduce, the
     quantiles selected across the ranks), the two ranks' states asserted
     bit-equal and held to phase 8's single-device state with its
     compare_qstates gates (the count of integer picks that differ
     printed); BRECQ over the same ranks (BlockReconstructor(mesh=)) at
     the CLI phase's cut, CLI_RECON_ITERS steps a unit on CLI_OPTIM_SIZE
     images, from phase 8's state before the fold, held to a single-device
     reconstruction with the same draws (compare_recons); the mesh state
     served on the dp=2 predictor, K1 12 and K4 49 launches a batch on
     each rank asserted, all "mma", each rank's kernels held to their
     plain versions on its slice (block checks); per rank the capture and
     per-family seconds, wall-clock, peak device memory, the dp
     all_reduces with their bytes and seconds, BRECQ's ms a step, labelled
     as ranks sharing one card, not a scaling number;
 14. zoo phase (run after phase 7): every other zoo shape served as in
     phase 6, at full depth and width, batch 32, with its smoke state:
     deit_tiny (3 heads) and deit_base (K 768 and 3072, fc2's 768 columns
     over two of K4's 384-column blocks), K1 12 and K4 49 a batch;
     vit_large (24 blocks, 16 heads, fc2 4096 -> 1024 with a ragged last
     block), K1 24 and K4 97; swin_base and swin_base_384 (S=144 windows,
     4-32 heads), K1 24 and K4 100; block checks on every block, every K1
     and K4 launch "mma"; then K2 and K3 at vit_large and swin_base_384 as
     in phase 7;
 15. bits phase (run after phase 13): deit_small calibrated on the card at
     the shipped configs/3bit.py and configs/6bit.py (cut to BITS_DEPTH
     blocks, PERF.md section 4), timed, every site at the config's widths
     and every AdaLog base an integer fq_gemm.prepare takes, its held-out
     logit MSE to the raw model printed beside phase 8's W4A4; served as in
     phase 6 (every K1 and K4 launch "mma") and with eval_int8 as in phase
     9 (K5 at every uniform Linear site, all "wgmma"); and test_tiny
     calibrated at each width on the card and on the CPU, held with phase
     8's compare_qstates gates.
The last two lines are a JSON summary of the kernels (launches summed over
the main paths of phases 6 to 15, every rank's; times of the fp32 kernel
phases; the bound
from those phases' shapes; K1-K4's entries are the variant their paths
launch, "mma", K5's "wgmma", with "mma"'s times beside it; K5's
library_ms is torch._int_mm's, library_ms_graph the same from a CUDA
graph) and the ok line.

With --profile, after the build: the share of K1's, K2's, K3's and K4's
cycles in each phase of the kernel, and of K5's two variants at deit_small's
qkv and fc1 (second, instrumented builds), then each smoke
model served in
each dtype and setting, 5 batches of 32 after 3 warm-up, wall ms untraced,
then one torch.profiler trace: device busy ms a batch, idle share of the
traced span, device time split into K1, K4, cuBLAS/cuDNN GEMM and
convolution, and the rest (the top kernels of the last two are printed);
then one deit_small calibration traced after a cold one: the share of the
span in the scoring GEMMs, in elementwise and reduction kernels (the
quantize / compare work), in sorts, and idle; last, a short deit_small
reconstruction traced after an untraced one: ms a step, device events a
step, the device's busy share, GEMMs against the rest.
"""

import copy
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
KERNELS = ("fq_flash_attn", "fq_attn_matmul", "fq_gemm",    # csrc/<name>.cu
           "int8_gemm")
KERNEL_SHAPE = dict(G=384, S=197, D=64, P=6)     # deit_small, batch 64
BATCH, N_BATCHES = 32, 4
# K2 and K3 at the attention shapes of batch 32: (model, G, S, D)
MATMUL_SHAPES = (("deit_small", 192, 197, 64),
                 ("swin_tiny stage 0", 6144, 49, 32),
                 ("swin_tiny stage 3", 768, 49, 32))
# K4 at deit_small's Linear sites, batch 32 (T = 32 images x 197 tokens):
# (site, T, K, O, kind)
GEMM_SHAPES = (("qkv", 6304, 384, 1152, "uniform"),
               ("proj", 6304, 384, 384, "uniform"),
               ("fc1", 6304, 384, 1536, "uniform"),
               ("fc2", 6304, 1536, 384, "uniform"),
               ("fc2", 6304, 1536, 384, "adalog_shift"),
               ("head", 32, 384, 1000, "uniform"))
# and at swin_tiny's longest (stage 0 qkv) and deepest (stage 3 fc2) Linear
GEMM_SWIN_SHAPES = (("swin_tiny stage 0 qkv", 100352, 96, 288, "uniform"),
                    ("swin_tiny stage 3 fc2", 1568, 3072, 768,
                     "adalog_shift"))
# K5 at deit_small's int8 sites at batch 32 (qkv, proj and fc1 of a block
# and the head; fc2 is an AdaLog site), deit_base's three block sites, the
# int8 sites of the models the JAX package serves with int8 by default at
# batch 32 (vit_large's block sites and head; swin_base_384's longest
# Linear, stage 0's qkv, stage 2's fc1 and its deepest, the stage 2-3
# reduction) and two ragged shapes (K neither a multiple of 16 nor of a
# stage, odd O), which variant "wgmma" refuses: (site, T, K, O)
INT8_SHAPES = (("deit_small qkv", 6304, 384, 1152),
               ("deit_small proj", 6304, 384, 384),
               ("deit_small fc1", 6304, 384, 1536),
               ("deit_small head", 32, 384, 1000),
               ("deit_base qkv", 6304, 768, 2304),
               ("deit_base proj", 6304, 768, 768),
               ("deit_base fc1", 6304, 768, 3072),
               ("vit_large qkv", 6304, 1024, 3072),
               ("vit_large proj", 6304, 1024, 1024),
               ("vit_large fc1", 6304, 1024, 4096),
               ("vit_large head", 32, 1024, 1000),
               ("swin_base_384 stage 0 qkv", 294912, 128, 384),
               ("swin_base_384 stage 2 fc1", 18432, 512, 2048),
               ("swin_base_384 reduction 2-3", 4608, 2048, 1024),
               ("ragged", 777, 100, 130),
               ("ragged", 6304, 40, 1001))
SMOKE_LOG_Q = 29.0          # AdaLog base of the smoke state, not 37
# qkv weight std: q.k logits of LayerNormed tokens then have a std of about
# (QKV_STD**2 * dim) * head_dim**0.5 / 8 ~ 2
QKV_STD = 0.075
# kernel vs plain: the two sum in different orders and log2f/exp2f may
# differ by an ulp, so a probability near an AdaLog code boundary may take
# the neighbouring code and move its row's outputs. At most FLIP_SHARE of
# the outputs may leave ATOL + RTOL*|ref|. None may leave it by more than a
# flipped code can move it: for K1 one whole probability times the largest
# |uq(v)| of the inputs (flash_cap), for K2 and K3 the same of uq(B)
# (matmul_cap); FLIP_MAX for K4 at the kernel phase's inputs.
ATOL = RTOL = 1e-5
FLIP_SHARE = 1e-3
FLIP_MAX = 0.1
# K1 past the 256 columns variant "mma" holds in registers: "fma" by routing
LONG_SHAPE = dict(G=64, S=300, D=64, P=2)
# K4 vs plain: ATOL + GEMM_RTOL[dtype]*|ref|, with the same share and max.
# fp32: the two sum in different orders; bf16: both round their fp32 sum to
# bf16, and sums a last bit apart may round to neighbours one bf16 ulp
# (2**-7 relative) apart. AdaLog flips move a whole output row (FLIP_*).
GEMM_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# Served logits, kernel on vs off (the unfused plain path), are reported,
# not held to a bound: W4A4 fake quantization is discontinuous, and with
# random weights every code flipped by a last-bit difference grows through
# the 12 blocks' quantizers until the two outputs differ by the model's
# whole quantization noise. The kernel is instead held to its plain version
# on the real q/kT/v of every block of the served model (block check).

def quant_config(bits=4, **kw):
    """A Config at w, a, s and head-input bits ``bits`` (the patch
    embedding's input stays at 8), the shipped configs' search numbers."""
    from adalog_tpu_torch.utils.config import Config

    return Config(w_bit=bits, a_bit=bits, s_bit=bits, qhead_a_bit=bits, **kw)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


@functools.lru_cache(maxsize=1)
def card_line():
    """The card's name and power limit, as nvidia-smi gives them (read
    once)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(torch, fn, reps=20, warmup=3, calls=1):
    """Median milliseconds of one fn() over reps timings by CUDA events,
    each of ``calls`` calls in a row. One call a timing includes the host's
    time to launch it (tens of microseconds through a Python wrapper, while
    the device waits); several queue up behind one another as the launches
    of a served batch do, and show the device's time alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def cuda_graph_ms(torch, fn, calls=10, reps=20):
    """Median milliseconds of one fn() on the device alone: ``calls`` calls
    captured into one CUDA graph, whose replay launches them with no host
    time between; fn launches on the current stream and allocates with
    torch only."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def kernel_name(mangled):
    """name<template arguments> of a kernel in an anonymous namespace, from
    its mangled name (_ZN <len> <namespace> <len> <name> [I <args> E] ...);
    the mangled name where it is not of that form."""
    import re

    m = re.match(r"_ZN(\d+)", mangled)
    if m is None:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if m is None:
        return mangled
    n = int(m.group(1))
    name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    if not rest.startswith("I"):
        return name
    args, rest = [], rest[1:]
    while rest and not rest.startswith("E"):
        lit = re.match(r"L[ib](\d+)E", rest)
        named = re.match(r"(\d+)", rest)
        if lit:
            args.append(lit.group(1))
            rest = rest[lit.end():]
        elif named:
            k = int(named.group(1))
            args.append(rest[named.end():named.end() + k])
            rest = rest[named.end() + k:]
        else:
            args.append({"f": "float", "i": "int", "b": "bool"}.get(
                rest[0], rest[0]))
            rest = rest[1:]
    return f"{name}<{', '.join(args)}>"


def ptxas_report(log_path):
    """([(kernel, registers, spill bytes, static shared memory bytes)],
    [the compiler's warnings and performance notes]) of one build's
    report."""
    import re

    with open(log_path) as f:
        txt = f.read()
    rows = []
    for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
            r"(\d+) bytes spill loads.*?Used (\d+) registers"
            r"(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?", txt, re.S):
        name = kernel_name(m.group(1))
        rows.append((name, int(m.group(4)),
                     int(m.group(2)) + int(m.group(3)), int(m.group(5) or 0)))
    warnings = [ln.strip() for ln in txt.splitlines()
                if "arning" in ln or "Performance Loss" in ln]
    return rows, warnings


# NVIDIA's published H100 SXM peaks, for the kernels' bounds: device memory
# rate, fp32 outside the tensor cores (fp32 inputs: the reference's exact
# fp32 products rule TF32 out), dense bf16 and dense int8 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def bound_ms(nbytes, flops, dtype):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move nbytes once and do flops operations on inputs of dtype."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_inputs(torch, G, S, D, P, seed, device, bits=4):
    """[q, kT, v, m1a, m1b, m2q, m2b, bias (P, S, S)] float32 tensors from a
    numpy seed: logits spread over several units, per-slice uniform scales
    and zero points for ``bits``, AdaLog bases in 23..51 other than 37."""
    rng = np.random.default_rng(seed)
    q = 2 * rng.standard_normal((G, S, D))
    kT = 2 * rng.standard_normal((G, D, S))
    v = rng.standard_normal((G, S, D))
    levels = 2 ** bits - 1

    def prm(spread):
        s = spread / levels * rng.uniform(0.8, 1.2, G)
        return np.stack([s, rng.integers(levels // 2 - 1, levels // 2 + 3,
                                         G)], 1)

    arrays = [q, kT, v, prm(12.0), prm(12.0),
              rng.choice([a for a in range(23, 52) if a != 37], G), prm(6.0),
              rng.standard_normal((P, S, S))]
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device)
            for a in arrays]


def flash_bound_ms(G, S, D, P, dtype, variant="mma"):
    """(bound ms, what binds) of one K1 call: q, kT, v in ``dtype``, the
    fp32 output, parameters and (P, S, S) bias each once, against the
    4*G*S*S*D operations of its two products. Variant "mma" runs the
    products of fp32 inputs too as bf16 on the tensor cores (exact integer
    operands), so its operations are reckoned at the bf16 tensor rate
    whatever the input dtype; "fma" at the rate of its inputs' type."""
    itemsize = 2 if "bfloat16" in str(dtype) else 4
    nbytes = G * S * D * (3 * itemsize + 4) + (7 * G + P * S * S) * 4
    return bound_ms(nbytes, 4 * G * S * S * D,
                    "bfloat16" if variant == "mma" else dtype)


def flash_cap(torch, v, m2b, bits):
    """The most one flipped AdaLog code can move an output of K1: one whole
    probability times the largest |uq(v)| of these inputs."""
    s = m2b[:, 0].float().reshape(-1, 1, 1)
    z = torch.round(m2b[:, 1].float()).reshape(-1, 1, 1)
    c = torch.clamp(torch.round(v.float() / s) + z, 0.0, 2.0 ** bits - 1)
    return ((c - z) * s).abs().max().item()


def gemm_bound_ms(T, K, O, dtype, variant="mma"):
    """(bound ms, what binds) of one K4 call with a bias: x, w, bias and the
    output in ``dtype`` and the (4,) parameters each once, against 2*T*K*O
    operations. Variant "mma" runs the products of fp32 inputs too as bf16
    on the tensor cores (exact integer operands), so its operations are
    reckoned at the bf16 tensor rate whatever the input dtype; "fma" at the
    rate of its inputs' type."""
    itemsize = 2 if "bfloat16" in str(dtype) else 4
    return bound_ms((T * K + O * K + O + T * O) * itemsize + 16,
                    2 * T * K * O, "bfloat16" if variant == "mma" else dtype)


def flash_case(torch, fq_attn, args, bias, kw, tag, variant, took):
    """One K1 call of ``variant`` against the plain version, checked and
    timed; ``took`` is the variant the wrapper must have launched. Returns
    ((kernel ms of one call a timing, of 10 calls in a row a timing, of 10
    calls replayed from a CUDA graph, plain ms), max|diff|)."""
    G, S, D = args[0].shape
    before = dict(fq_attn.fq_flash_attn.variant_launches)
    got = fq_attn.fq_flash_attn(*args, bias, variant=variant, **kw)
    want = fq_attn.fq_flash_attn_plain(*args, bias, **kw)
    torch.cuda.synchronize()
    before[took] += 1
    check(fq_attn.fq_flash_attn.variant_launches == before,
          f"[{tag}] variant '{variant}' did not launch '{took}'")
    check(tuple(got.shape) == (G, S, D) and got.dtype == torch.float32,
          f"[{tag}] kernel output shape/dtype")
    check(bool(torch.isfinite(got).all()), f"[{tag}] kernel output not finite")
    max_diff, share = compare(got, want, RTOL)
    cap = flash_cap(torch, args[2], args[6], kw["m2b_bits"])
    # timed as a predictor calls it: the verdict on the zero points read
    # once, not by every call (that waits for the device)
    exact = all(fq_attn.zero_points_exact(args[i], kw[b]) for i, b in
                ((3, "m1a_bits"), (4, "m1b_bits"), (6, "m2b_bits")))

    def call():
        return fq_attn.fq_flash_attn(*args, bias, variant=variant,
                                     exact_ints=exact, **kw)

    k_ms = cuda_ms(torch, call)
    q_ms = cuda_ms(torch, call, calls=10)
    g_ms = cuda_graph_ms(torch, call)
    p_ms = cuda_ms(torch, lambda: fq_attn.fq_flash_attn_plain(
        *args, bias, **kw))
    P = 0 if bias is None else bias.shape[0]
    b_ms, by = flash_bound_ms(G, S, D, P, args[0].dtype, took)
    print(f"kernel K1 fq_flash_attn [{tag}] variant={took} G={G} S={S} "
          f"D={D}: max|diff|={max_diff:.3e} share_past_tol={share:.3e} "
          f"(atol={ATOL} rtol={RTOL}; allowed share {FLIP_SHARE}, max "
          f"{cap:.3f}, the largest |uq(v)|) kernel_ms={k_ms:.4f} "
          f"back_to_back_ms={q_ms:.4f} graph_ms={g_ms:.4f} "
          f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({by})")
    check(share <= FLIP_SHARE, f"[{tag}] share past tolerance {share}")
    check(max_diff <= cap, f"[{tag}] max|diff| {max_diff} above {cap}")
    return (k_ms, q_ms, g_ms, p_ms), max_diff


def kernel_phase(torch, fq_attn, device):
    """Hold the kernel against its plain version: as routed ("mma",
    asserted) at KERNEL_SHAPE in fp32 and bf16, with and without bias;
    "fma" forced at KERNEL_SHAPE in fp32, and as routed at LONG_SHAPE; "mma"
    at swin_tiny's window shapes with a bias of their period. Returns the
    fp32 no-bias times (flash_case's three) of the routed variant at
    KERNEL_SHAPE and the largest max|diff| of all cases."""
    G, S, D, P = (KERNEL_SHAPE[k] for k in "GSDP")
    q, kT, v, m1a, m1b, m2q, m2b, bias = attention_inputs(
        torch, G, S, D, P, SEED, device)
    kw = dict(m1a_bits=4, m1b_bits=4, m2a_bits=4, m2b_bits=4,
              logit_scale=D ** -0.5)
    worst, fp32_times = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        args = [t.to(dtype) for t in (q, kT, v)] + [m1a, m1b, m2q, m2b]
        for b in (None, bias):
            tag = f"{dt}, {'bias' if b is not None else 'no bias'}"
            times, d = flash_case(torch, fq_attn, args, b, kw, tag, "auto",
                                  "mma")
            worst = max(worst, d)
            if dtype == torch.float32 and b is None:
                fp32_times = times
        if dtype == torch.float32:
            _, d = flash_case(torch, fq_attn, args, None, kw,
                              f"{dt}, no bias", "fma", "fma")
            worst = max(worst, d)

    lg, ls, ld, lp = (LONG_SHAPE[k] for k in "GSDP")
    *args, bias = attention_inputs(torch, lg, ls, ld, lp, SEED + 2, device)
    kw["logit_scale"] = ld ** -0.5
    _, d = flash_case(torch, fq_attn, args, bias, kw,
                      "float32, bias, S > 256", "auto", "fma")
    worst = max(worst, d)

    for model, wg, ws, wd in MATMUL_SHAPES[1:]:
        # the bias's period: windows x heads of one image
        *args, bias = attention_inputs(torch, wg, ws, wd, wg // BATCH,
                                       SEED + 3, device)
        kw["logit_scale"] = 1.0
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[-1]
            a = [t.to(dtype) for t in args[:3]] + args[3:]
            _, d = flash_case(torch, fq_attn, a, bias, kw,
                              f"{model}, {dt}, bias", "auto", "mma")
            worst = max(worst, d)
    return fp32_times, worst


def matmul_cases(torch, fq_attn, G, S, D, seed, device, dtype):
    """The three K2/K3 calls of one attention at (G, S, D), on
    attention_inputs' tensors: {name: (wrapper, plain version, args,
    kwargs)} for K3 on q @ kT (uniform A), K3 on probabilities @ v (AdaLog
    A, the probabilities from the plain softmax of the plain matmul1's
    logits) and K2 on those logits and v. A and B are in ``dtype``; also
    returns the fp32 logits."""
    q, kT, v, m1a, m1b, m2q, m2b, _ = attention_inputs(
        torch, G, S, D, 1, seed, device)
    logits = fq_attn.fq_attn_matmul_plain(
        q, kT, m1a, m1b, a_kind="uniform", a_bits=4, b_bits=4) * D ** -0.5
    probs = torch.softmax(logits, dim=-1)
    m2a = torch.stack([m2q, torch.zeros_like(m2q)], dim=1)
    q, kT, v, lg, probs = (t.to(dtype) for t in (q, kT, v, logits, probs))
    return {
        "K3 uniform A (q @ kT)": (
            fq_attn.fq_attn_matmul, fq_attn.fq_attn_matmul_plain,
            (q, kT, m1a, m1b), dict(a_kind="uniform", a_bits=4, b_bits=4)),
        "K3 AdaLog A (probs @ v)": (
            fq_attn.fq_attn_matmul, fq_attn.fq_attn_matmul_plain,
            (probs, v, m2a, m2b), dict(a_kind="adalog", a_bits=4, b_bits=4)),
        "K2 (softmax, AdaLog, @ v)": (
            fq_attn.fq_softmax_attn_matmul,
            fq_attn.fq_softmax_attn_matmul_plain,
            (lg, v, m2a, m2b), dict(a_bits=4, b_bits=4)),
    }, logits


def matmul_bound_ms(args, variant="mma", itemsize_out=4):
    """(bound ms, what binds) of one K2/K3 call: the larger of its bytes
    (A, B, the parameters and the fp32 output, each once) over the memory
    rate and its 2*G*S*K*C operations over the peak rate of their type.
    Variant "mma" runs the product of fp32 inputs too as bf16 on the tensor
    cores (exact integer operands), so its operations are reckoned at the
    bf16 tensor rate whatever the input dtype; "fma" at the rate of its
    inputs' type."""
    A, B, ap, bp = args
    G, S, K = A.shape
    C = B.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + G * S * C * itemsize_out
    return bound_ms(nbytes, 2 * G * S * K * C,
                    "bfloat16" if variant == "mma" else A.dtype)


def matmul_cap(torch, args, kw, want):
    """The most an output of K2 / K3 may differ from its reference. With
    AdaLog A one flipped code moves an output by at most one whole
    probability times the largest |uq(B)| of these inputs (flash_cap). With
    uniform A no code can flip (kernel and plain version take the same IEEE
    quotients), so only the rounding of the fp32 sums is left: 1e-4 of the
    largest |output|."""
    _, B, _, bp = args
    if kw.get("a_kind") == "uniform":
        return 1e-4 * max(1.0, want.abs().max().item())
    return flash_cap(torch, B, bp, kw["b_bits"])


def matmul_case(torch, fq_attn, fn, plain, args, kw, tag, variant, took,
                p_ms=None, bitwise=None):
    """One K2 / K3 call of ``variant`` against the plain version, checked
    and timed; ``took`` is the variant the wrapper must have launched.
    With ``bitwise`` (by default where "fma" was launched) it must equal the
    plain version bit for bit. Returns (dict(ms of one
    call a timing, ms_back_to_back of ten in a row, ms_graph of ten replayed
    from a CUDA graph, plain_ms, bound_ms, bound_by), max|diff|, the
    output). The first two times hold the wrapper's host time, which is
    longer than these kernels; the graph's replay is the device alone."""
    G, S, K = args[0].shape
    C = args[1].shape[2]
    before, by_variant = fn.launches, dict(fn.variant_launches)
    got = fn(*args, variant=variant, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    by_variant[took] += 1
    check(fn.launches == before + 1 and fn.variant_launches == by_variant,
          f"[{tag}] variant '{variant}' did not launch '{took}' once")
    check(tuple(got.shape) == (G, S, C) and got.dtype == torch.float32,
          f"[{tag}] kernel output shape/dtype")
    check(bool(torch.isfinite(got).all()), f"[{tag}] not finite")
    max_diff, share = compare(got, want, RTOL)
    cap = matmul_cap(torch, args, kw, want)
    bitwise = took == "fma" if bitwise is None else bitwise
    # timed as a predictor calls it: the verdict on the zero points read
    # once, not by every call (that waits for the device)
    exact = fq_attn.zero_points_exact(args[3], kw["b_bits"]) and (
        kw.get("a_kind") != "uniform"
        or fq_attn.zero_points_exact(args[2], kw["a_bits"]))

    def call():
        return fn(*args, variant=variant, exact_ints=exact, **kw)

    t = dict(ms=cuda_ms(torch, call), ms_back_to_back=cuda_ms(torch, call,
                                                              calls=10),
             ms_graph=cuda_graph_ms(torch, call),
             plain_ms=cuda_ms(torch, lambda: plain(*args, **kw))
             if p_ms is None else p_ms)
    t["bound_ms"], t["bound_by"] = matmul_bound_ms(args, took)
    print(f"kernel {tag} variant={took} G={G} S={S} K={K} C={C}: max|diff|="
          f"{max_diff:.3e} share_past_tol={share:.3e} (atol={ATOL} "
          f"rtol={RTOL}; allowed share {FLIP_SHARE}, max {cap:.3e}"
          + (", bit for bit" if bitwise else "")
          + f") kernel_ms={t['ms']:.4f} back_to_back_ms="
          f"{t['ms_back_to_back']:.4f} graph_ms={t['ms_graph']:.4f} "
          f"plain_ms={t['plain_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
          f"({t['bound_by']})")
    check(share <= FLIP_SHARE, f"[{tag}] share past tolerance {share}")
    check(max_diff <= cap, f"[{tag}] max|diff| {max_diff} above {cap}")
    if bitwise:
        check(torch.equal(got, want),
              f"[{tag}] 'fma' is not bit for bit the plain version")
    return t, max_diff, got


def matmul_kernel_phase(torch, fq_attn, device):
    """Hold K2 and K3 against their plain versions at MATMUL_SHAPES, fp32
    and bf16: as routed (variant "mma", asserted) and with "fma" forced
    (bit for bit); K2 at LONG_SHAPE's S > 256 as routed ("fma", asserted);
    and K2 on the plain matmul1's logits against K1 on the same q, kT, v
    (fp32): "fma" against "fma" bit for bit, "mma" against "mma" to K1's
    own tolerance. Returns {"K2" | "K3": dict(ms, ms_back_to_back,
    ms_graph, plain_ms, bound_ms, bound_by, max_abs_err)} with the times and
    bounds of the routed deit_small fp32 calls (K3: its two calls summed)
    and the largest max|diff| of all cases."""
    keys = ("ms", "ms_back_to_back", "ms_graph", "plain_ms", "bound_ms")
    res = {k: dict({key: 0.0 for key in keys}, by=[], max_abs_err=0.0)
           for k in ("K2", "K3")}
    for i, (model, G, S, D) in enumerate(MATMUL_SHAPES):
        for dt in ("float32", "bfloat16"):
            cases, logits = matmul_cases(torch, fq_attn, G, S, D,
                                         SEED + 20 + i, device,
                                         getattr(torch, dt))
            outs = {}
            for name, (fn, plain, args, kw) in cases.items():
                tag = f"{name}, {model}, {dt}"
                t, d, outs[name, "mma"] = matmul_case(
                    torch, fq_attn, fn, plain, args, kw, tag, "auto", "mma")
                r = res[name[:2]]
                r["max_abs_err"] = max(r["max_abs_err"], d)
                if model == "deit_small" and dt == "float32":
                    for key in keys:
                        r[key] += t[key]
                    r["by"].append((t["bound_ms"], t["bound_by"]))
                _, d, outs[name, "fma"] = matmul_case(
                    torch, fq_attn, fn, plain, args, kw, tag, "fma", "fma",
                    t["plain_ms"])
                r["max_abs_err"] = max(r["max_abs_err"], d)
            if dt == "float32":
                # K1 forms the same logits inside; K2 must land where K1
                # does: "fma" on the same bits as K1 "fma" (the same fp32
                # products and sums in the same order), "mma" within K1's
                # own tolerance of K1 "mma" (K1 forms exact integer logits,
                # K2 is handed the plain matmul1's rounded fp32 ones)
                q, kT, v, m1a, m1b, m2q, m2b, _ = attention_inputs(
                    torch, G, S, D, 1, SEED + 20 + i, device)
                cap = flash_cap(torch, v, m2b, 4)
                for variant in ("fma", "mma"):
                    k2 = outs["K2 (softmax, AdaLog, @ v)", variant]
                    k1 = fq_attn.fq_flash_attn(
                        q, kT, v, m1a, m1b, m2q, m2b, m1a_bits=4, m1b_bits=4,
                        m2a_bits=4, m2b_bits=4, logit_scale=D ** -0.5,
                        variant=variant)
                    torch.cuda.synchronize()
                    max_diff, share = compare(k2, k1, RTOL)
                    print(f"kernel K2 '{variant}' on the plain matmul1's "
                          f"logits vs K1 '{variant}', {model}, float32: "
                          f"max|diff|={max_diff:.3e} share_past_tol="
                          f"{share:.3e} "
                          + ("(must be bit for bit)" if variant == "fma" else
                             f"(allowed share {FLIP_SHARE}, max {cap:.3f})"))
                    if variant == "fma":
                        check(torch.equal(k2, k1),
                              f"K2 vs K1 'fma' {model}: not bit for bit")
                    check(share <= FLIP_SHARE,
                          f"K2 vs K1 '{variant}' {model}: share {share}")
                    check(max_diff <= cap,
                          f"K2 vs K1 '{variant}' {model}: {max_diff}")
            del cases, outs, logits
            torch.cuda.empty_cache()

    # a row of logits past the 256 columns "mma" holds in registers: K2 goes
    # to "fma" by routing; K3 with AdaLog A streams its rows and stays "mma"
    # (rows of 300 sum in another order than the plain version's: to
    # tolerance, not bit for bit)
    lg, ls, ld = (LONG_SHAPE[k] for k in "GSD")
    cases, _ = matmul_cases(torch, fq_attn, lg, ls, ld, SEED + 30, device,
                            torch.float32)
    for name, took in (("K2 (softmax, AdaLog, @ v)", "fma"),
                       ("K3 AdaLog A (probs @ v)", "mma")):
        fn, plain, args, kw = cases[name]
        _, d, _ = matmul_case(torch, fq_attn, fn, plain, args, kw,
                              f"{name}, S > 256, float32", "auto", took,
                              bitwise=False)
        res[name[:2]]["max_abs_err"] = max(res[name[:2]]["max_abs_err"], d)
    for r in res.values():
        r["bound_by"] = max(r.pop("by"))[1]
    return res


def gemm_inputs(torch, T, K, O, kind, seed, device, bits=4):
    """[x (T, K), w (O, K), params (4,), bias (O,)] float32 tensors from a
    numpy seed: normal x (a LayerNorm's output) with min/max uniform params,
    or GeLU'd normal x with AdaLog scale max(x + shift) and base
    SMOKE_LOG_Q; w and bias normal with std 0.02."""
    from adalog_tpu_torch.quantizers.state import GELU_MIN

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32))
    if kind == "uniform":
        lo, hi = min(x.min().item(), 0.0), max(x.max().item(), 0.0)
        scale = (hi - lo) / (2 ** bits - 1)
        params = [scale, round(-lo / scale), 0.0, 0.0]
    else:
        x = torch.nn.functional.gelu(x)
        params = [(x + GELU_MIN).max().item(), 0.0, GELU_MIN, SMOKE_LOG_Q]
    w = 0.02 * rng.standard_normal((O, K))
    bias = 0.02 * rng.standard_normal(O)
    return [x.to(device)] + [torch.from_numpy(np.asarray(a, np.float32))
                             .to(device) for a in (w, params, bias)]


def weight_with_codes(torch, fq_gemm, w, bits=4):
    """w (O, K) float32 fake-quantized per output row (asymmetric min/max at
    ``bits``) as a served weight is: (w_q float32, its WeightCodes), with
    codes * scale == w_q bit for bit."""
    lo = torch.clamp(w.amin(dim=1, keepdim=True), max=0.0)
    hi = torch.clamp(w.amax(dim=1, keepdim=True), min=0.0)
    scale = torch.clamp((hi - lo) / (2 ** bits - 1), min=1e-8)
    z = torch.round(-lo / scale)
    codes = torch.clamp(torch.round(w / scale) + z, 0.0, 2.0 ** bits - 1) - z
    return codes * scale, fq_gemm.WeightCodes(
        codes.to(torch.bfloat16).contiguous(), scale.reshape(-1).contiguous())


def identity_codes(torch, fq_gemm, K, device):
    """The identity weight as WeightCodes: it passes variant "mma"'s staged
    activations of fp32 inputs through the product."""
    return fq_gemm.WeightCodes(
        torch.eye(K, dtype=torch.bfloat16, device=device),
        torch.ones(K, dtype=torch.float32, device=device))


def quantized_x_flips(torch, fq_gemm, xq, x, prm, kind, bits, int_mode):
    """Share of the quantized activations xq (read through an identity
    weight) that differ from quantize_plain's: bit for bit, but for fp32
    inputs through variant "mma" with adalog_shift, whose value is (steps *
    2^-shift) * (ts * s) where the plain version forms (2^-shift * (steps *
    ts)) * s: the same code within 2 ulp."""
    ref = fq_gemm.quantize_plain(x, prm, kind=kind, bits=bits).to(x.dtype)
    if int_mode and kind == "adalog_shift":
        return ((xq - ref).abs() > 2.5e-7 * ref.abs()).float().mean().item()
    return (xq != ref).float().mean().item()


def compare(got, want, rtol):
    """(max|diff|, share of outputs past ATOL + rtol*|want|), in fp32."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return (diff.max().item(),
            (diff > ATOL + rtol * want.abs()).float().mean().item())


def gemm_case(torch, fq_gemm, x, w, prm, b, codes, kind, variant, took, tag):
    """One K4 call of ``variant`` against the plain version, checked and
    timed; ``took`` is the variant the wrapper must have launched. Returns
    ((kernel ms of one call a timing, of 10 calls in a row a timing, of 10
    calls replayed from a CUDA graph, plain ms), max|diff|). The first two
    hold the wrapper's host time, which is longer than some of these
    kernels; the graph's replay is the device's time alone."""
    (T, K), O, dt = x.shape, w.shape[0], str(x.dtype).split(".")[-1]
    kw = dict(kind=kind, bits=4, variant=variant, codes=codes)
    plain_kw = dict(kind=kind, bits=4)
    before = dict(fq_gemm.fq_gemm.variant_launches)
    got = fq_gemm.fq_gemm(x, w, prm, **kw)
    got_b = fq_gemm.fq_gemm(x, w, prm, b, **kw)
    # an identity weight passes the quantized activations through the
    # product exactly
    xq = fq_gemm.fq_gemm(
        x, torch.eye(K, dtype=x.dtype, device=x.device), prm,
        **dict(kw, codes=None if codes is None else identity_codes(
            torch, fq_gemm, K, x.device)))
    want = fq_gemm.fq_gemm_plain(x, w, prm, **plain_kw)
    torch.cuda.synchronize()
    before[took] += 3
    check(fq_gemm.fq_gemm.variant_launches == before,
          f"[{tag}] variant '{variant}' did not launch '{took}'")
    check(tuple(got.shape) == (T, O) and got.dtype == x.dtype,
          f"[{tag}] kernel output shape/dtype")
    check(bool(torch.isfinite(got).all()), f"[{tag}] not finite")
    check(torch.equal(got_b, got + b), f"[{tag}] fused bias differs "
          "from the product plus the bias")
    flips = quantized_x_flips(torch, fq_gemm, xq, x, prm, kind, 4,
                              took == "mma" and dt == "float32")
    max_diff, share = compare(got, want, GEMM_RTOL[dt])
    # as a served call: the verdict on the zero point read once, not by
    # every call (that waits for the device)
    exact = fq_gemm.activation_ints_exact(prm, kind, 4)

    def call():
        return fq_gemm.fq_gemm(x, w, prm, b, exact_ints=exact, **kw)

    k_ms = cuda_ms(torch, call)
    q_ms = cuda_ms(torch, call, calls=10)
    g_ms = cuda_graph_ms(torch, call)
    p_ms = cuda_ms(torch, lambda: fq_gemm.fq_gemm_plain(x, w, prm, b,
                                                        **plain_kw))
    print(f"kernel K4 fq_gemm [{tag}] variant={took} T={T} K={K} O={O}: "
          f"max|diff|={max_diff:.3e} share_past_tol={share:.3e} "
          f"(atol={ATOL} rtol={GEMM_RTOL[dt]:.3e}; allowed share "
          f"{FLIP_SHARE}, max {FLIP_MAX}) quantized_x_differ={flips:.3e} "
          f"kernel_ms={k_ms:.4f} back_to_back_ms={q_ms:.4f} "
          f"graph_ms={g_ms:.4f} plain_ms={p_ms:.4f} "
          "bound_ms=%.4f (%s)" % gemm_bound_ms(T, K, O, x.dtype, took))
    check(flips == 0.0 if kind == "uniform" else flips <= FLIP_SHARE,
          f"[{tag}] quantized activations differ: share {flips}")
    check(share <= FLIP_SHARE, f"[{tag}] share past tolerance {share}")
    check(max_diff <= FLIP_MAX, f"[{tag}] max|diff| {max_diff}")
    return (k_ms, q_ms, g_ms, p_ms), max_diff


def gemm_kernel_phase(torch, fq_gemm, device):
    """Hold K4 against its plain version at the deit_small Linear shapes and
    at two of swin_tiny's, fp32 and bf16, on a weight fake-quantized to 4
    bits with its codes, as a served site has it: as routed ("mma",
    asserted) and "fma" forced; and, in fp32, a bare call on the weight
    without codes, which must take "fma". Returns (the fp32 times of "mma"
    summed over one deit_small block's four sites, fc2 as adalog_shift, and
    the head: gemm_case's four) and the largest max|diff| of all cases."""
    worst, sums = 0.0, [0.0, 0.0, 0.0, 0.0]
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for i, (site, T, K, O, kind) in enumerate(GEMM_SHAPES
                                                  + GEMM_SWIN_SHAPES):
            x, w, prm, b = gemm_inputs(torch, T, K, O, kind, SEED + 10 + i,
                                       device)
            w, codes = weight_with_codes(torch, fq_gemm, w)
            x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
            tag = f"{dt}, {site} {kind}"
            times, d = gemm_case(torch, fq_gemm, x, w, prm, b, codes, kind,
                                 "auto", "mma", tag)
            worst = max(worst, d)
            if dt == "float32" and i < len(GEMM_SHAPES) \
                    and (site, kind) != ("fc2", "uniform"):
                sums = [a + t for a, t in zip(sums, times)]
            _, d = gemm_case(torch, fq_gemm, x, w, prm, b, codes, kind, "fma",
                             "fma", tag)
            worst = max(worst, d)
            if dt == "float32":
                _, d = gemm_case(torch, fq_gemm, x, w, prm, b, None, kind,
                                 "auto", "fma", tag + ", no weight codes")
                worst = max(worst, d)
            del x, w, b
            torch.cuda.empty_cache()
    return tuple(sums), worst


def int8_inputs(torch, T, K, O, seed, device, bits=4):
    """[x (T, K) float32, w_int (O, K) int8, a_params (2,), scale_row (O,),
    bias (O,) float32] from a numpy seed: normal x with min/max uniform
    activation params, a normal weight (std 0.02) quantized per row by
    min/max at ``bits`` as a served site's codes, bias std 0.02."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, K)).astype(np.float32)
    lo, hi = min(float(x.min()), 0.0), max(float(x.max()), 0.0)
    scale = np.float32((hi - lo) / (2 ** bits - 1))
    a_params = torch.tensor([scale, round(-lo / float(scale))],
                            dtype=torch.float32)
    w = torch.from_numpy(0.02 * rng.standard_normal((O, K))).float()
    lo_w = torch.clamp(w.amin(dim=1, keepdim=True), max=0.0)
    hi_w = torch.clamp(w.amax(dim=1, keepdim=True), min=0.0)
    s_w = torch.clamp((hi_w - lo_w) / (2 ** bits - 1), min=1e-8)
    z_w = torch.round(-lo_w / s_w)
    w_int = (torch.clamp(torch.round(w / s_w) + z_w, 0.0, 2.0 ** bits - 1)
             - z_w).to(torch.int8)
    bias = torch.from_numpy(0.02 * rng.standard_normal(O)).float()
    return [torch.from_numpy(x).to(device), w_int.to(device),
            a_params.to(device), (a_params[0] * s_w.reshape(-1)).to(device),
            bias.to(device)]


def int8_bound_ms(T, K, O, dtype):
    """K5's bound: x read once, the int8 codes, row scales and bias read
    once, the output written once; 2 T K O integer operations at the int8
    peak."""
    item = 4 if dtype == "float32" else 2
    nbytes = T * K * item + O * K + O * 4 + O * item + 8 + T * O * item
    return bound_ms(nbytes, 2.0 * T * K * O, "int8")


def int8_case(torch, x, w_int, a_params, scale_row, b, tag):
    """K5 on one shape: each variant that takes it ("wgmma" unless
    wgmma_refusal refuses, "mma" always) forced, against the plain version
    bit for bit with and without the bias, and timed; the routed call
    launches the variant int8_variant names. Returns ({variant: {"ms": one
    call a timing, "ms_back_to_back": ten in a row, "ms_graph": ten replayed
    from a CUDA graph (the device alone)}, "refused": why "wgmma" does not
    take the shape or None, "plain_ms", "library_ms": torch._int_mm on the
    activation codes (the integer product alone) one call a timing, and
    "library_ms_graph" from a CUDA graph, both None where it does not take
    the shape (T > 16, K and O multiples of 8), "bound_ms", "bound_by"},
    the largest max|diff|)."""
    from adalog_tpu_torch.ops import int8_linear

    (T, K), O, dt = x.shape, w_int.shape[0], str(x.dtype).split(".")[-1]
    args = (x, w_int, a_params, scale_row)
    counts = int8_linear.int8_gemm.variant_launches
    refused = int8_linear.wgmma_refusal(T, K, O, K, x.data_ptr() % 16,
                                        x.dtype)
    routed = "mma" if refused else "wgmma"
    w_map = None if refused else int8_linear.weight_map(w_int)
    want = int8_linear.int8_gemm_plain(*args, b, bits=4)
    want_nb = int8_linear.int8_gemm_plain(*args, bits=4)
    before = dict(counts)
    int8_linear.int8_gemm(*args, b, bits=4, w_map=w_map)
    check(counts[routed] == before[routed] + 1,
          f"[{tag}] the routed call did not launch '{routed}'")
    r, worst = {"refused": refused}, 0.0
    for v in ("mma",) if refused else ("wgmma", "mma"):
        before = dict(counts)
        got = int8_linear.int8_gemm(*args, b, bits=4, variant=v,
                                    w_map=w_map)
        got_nb = int8_linear.int8_gemm(*args, bits=4, variant=v,
                                       w_map=w_map)
        torch.cuda.synchronize()
        check(counts[v] == before[v] + 2,
              f"[{tag}] the wrapper did not launch K5 '{v}'")
        check(tuple(got.shape) == (T, O) and got.dtype == x.dtype,
              f"[{tag}] '{v}' output shape/dtype")
        check(bool(torch.isfinite(got).all()), f"[{tag}] '{v}' not finite")
        max_diff = max((got.float() - want.float()).abs().max().item(),
                       (got_nb.float() - want_nb.float()).abs().max().item())
        n_diff = int((got != want).sum()) + int((got_nb != want_nb).sum())

        def call(v=v):
            return int8_linear.int8_gemm(*args, b, bits=4, variant=v,
                                         w_map=w_map)

        r[v] = {"ms": cuda_ms(torch, call),
                "ms_back_to_back": cuda_ms(torch, call, calls=10),
                "ms_graph": cuda_graph_ms(torch, call)}
        print(f"kernel K5 int8_gemm '{v}' [{tag}] T={T} K={K} O={O}: outputs "
              f"differing from the plain version {n_diff} (want 0), "
              f"max|diff|={max_diff:.3e} kernel_ms={r[v]['ms']:.4f} "
              f"back_to_back_ms={r[v]['ms_back_to_back']:.4f} "
              f"graph_ms={r[v]['ms_graph']:.4f}")
        check(n_diff == 0, f"[{tag}] K5 '{v}' differs from its plain "
              f"version in {n_diff} outputs")
        worst = max(worst, max_diff)
        del got, got_nb
    r["plain_ms"] = cuda_ms(torch, lambda: int8_linear.int8_gemm_plain(
        *args, b, bits=4))
    r["library_ms"] = r["library_ms_graph"] = None
    if T > 16 and K % 8 == 0 and O % 8 == 0:
        codes = int8_linear.activation_codes(x, a_params, bits=4).to(
            torch.int8)
        wt = w_int.t()
        r["library_ms"] = cuda_ms(torch, lambda: torch._int_mm(codes, wt))
        r["library_ms_graph"] = cuda_graph_ms(
            torch, lambda: torch._int_mm(codes, wt))
    r["bound_ms"], r["bound_by"] = int8_bound_ms(T, K, O, dt)
    lib = "n/a (shape)" if r["library_ms"] is None else \
        f"{fmt_ms(r['library_ms'])} graph {fmt_ms(r['library_ms_graph'])}"
    print(f"kernel K5 int8_gemm [{tag}] T={T} K={K} O={O}: routed "
          f"'{routed}'" + (f" ('wgmma' refused: {refused})" if refused
                           else "")
          + f"; plain_ms={r['plain_ms']:.4f} int_mm_ms(product alone)={lib} "
          f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
    return r, worst


def fmt_ms(ms):
    return "n/a" if ms is None else f"{ms:.4f}"


def int8_kernel_phase(torch, device):
    """K5's variants against the plain version, bit for bit, at INT8_SHAPES
    in fp32 and bf16; every shape but the ragged ones must take "wgmma".
    Returns ({dtype: {key: the numbers summed over deit_small's four int8
    sites, its block's three and the head; for "wgmma" and "mma" a dict of
    their times}}, the largest max|diff|)."""
    from adalog_tpu_torch.ops import int8_linear

    lib = int8_linear._library()
    print("K5 'wgmma' a block (one an SM): dynamic shared memory bytes / "
          "ring stages: " + "; ".join(
              f"K={K} " + ", ".join(
                  f"{dt} " + "/".join(str(lib.int8_gemm_layout(d, K, what))
                                      for what in range(2))
                  for d, dt in enumerate(("fp32", "bf16")))
              for K in sorted({K for _, _, K, _ in INT8_SHAPES
                               if K % 16 == 0})))
    worst, sums = 0.0, {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        tot, bounds = {}, []
        for i, (site, T, K, O) in enumerate(INT8_SHAPES):
            x, w_int, prm, srow, b = int8_inputs(torch, T, K, O,
                                                 SEED + 40 + i, device)
            r, d = int8_case(torch, x.to(dtype), w_int, prm, srow,
                             b.to(dtype), f"{dt}, {site}")
            check((r["refused"] is None) == (site != "ragged"),
                  f"[{dt}, {site}] 'wgmma' refusal: {r['refused']}")
            worst = max(worst, d)
            if site.startswith("deit_small"):
                bounds.append((r.pop("bound_ms"), r.pop("bound_by")))
                for k, v in r.items():
                    if k == "refused":
                        continue
                    if isinstance(v, dict):
                        tot.setdefault(k, {})
                        for kk, vv in v.items():
                            tot[k][kk] = tot[k].get(kk, 0.0) + vv
                    else:                      # None where one is None
                        prev = tot.get(k, 0.0)
                        tot[k] = None if v is None or prev is None \
                            else prev + v
            del x, w_int, b
            torch.cuda.empty_cache()
        tot["bound_ms"] = sum(b for b, _ in bounds)
        tot["bound_by"] = max(bounds)[1]
        sums[dt] = tot
        print(f"kernel K5 int8_gemm [{dt}, deit_small's four int8 sites "
              f"summed]: 'wgmma' graph {tot['wgmma']['ms_graph']:.4f} ms "
              f"({100 * tot['bound_ms'] / tot['wgmma']['ms_graph']:.1f}% of "
              f"the bound), 'mma' graph {tot['mma']['ms_graph']:.4f} ms "
              f"({100 * tot['bound_ms'] / tot['mma']['ms_graph']:.1f}%), "
              f"torch._int_mm graph {fmt_ms(tot['library_ms_graph'])} ms, "
              f"bound {tot['bound_ms']:.4f} ms; {card_line()}")
    return sums, worst


def fold_fc2(torch, model, qstate):
    """Fold the GeLU shift through each fc2's quantized weight into its
    bias (calib/reparam.py), as calibration finishes, and set the flag: fc2
    then quantizes x + shift with no subtract-back and takes K4."""
    from adalog_tpu_torch.calib.reparam import fold_gelu_shift_into_bias
    from adalog_tpu_torch.quantizers.state import GELU_MIN

    for name, site in qstate.items():
        if not name.endswith(".mlp.fc2"):
            continue
        mlp = model.get_submodule(name[:-len(".fc2")])
        mlp.fc2 = fold_gelu_shift_into_bias(mlp.fc2, site, shift=GELU_MIN)
        site.aq.bias_reparamed = torch.ones((), dtype=torch.bool,
                                            device=site.aq.scale.device)


def timm_weights(cfg, seed):
    """A timm-keyed deit state dict from a numpy seed: normal weights (std
    0.02, qkv QKV_STD so attention rows are peaked as in a trained model
    rather than near uniform), zero biases, unit LayerNorms."""
    rng = np.random.default_rng(seed)
    D, hidden, P = cfg.dim, int(cfg.dim * cfg.mlp_ratio), cfg.patch_size

    def w(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def zeros(n):
        return np.zeros((n,), np.float32)

    sd = {"patch_embed.proj.weight": w(D, cfg.in_chans, P, P),
          "patch_embed.proj.bias": zeros(D),
          "cls_token": w(1, 1, D), "pos_embed": w(1, cfg.num_patches + 1, D),
          "norm.weight": np.ones(D, np.float32), "norm.bias": zeros(D),
          "head.weight": w(cfg.num_classes, D),
          "head.bias": zeros(cfg.num_classes)}
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        for nm in ("norm1", "norm2"):
            sd[f"{p}.{nm}.weight"] = np.ones(D, np.float32)
            sd[f"{p}.{nm}.bias"] = zeros(D)
        for nm, o, n, std in (("attn.qkv", 3 * D, D, QKV_STD),
                              ("attn.proj", D, D, 0.02),
                              ("mlp.fc1", hidden, D, 0.02),
                              ("mlp.fc2", D, hidden, 0.02)):
            sd[f"{p}.{nm}.weight"] = w(o, n, std=std)
            sd[f"{p}.{nm}.bias"] = zeros(o)
    return sd


def swin_weights(cfg, seed):
    """A timm-keyed Swin state dict from a numpy seed: normal weights and
    rel-pos tables (std 0.02; qkv of a stage of width C std sqrt(2 / C), so
    the window logits have a std of about 2 and attention rows are peaked),
    zero biases, unit LayerNorms, bias-free reductions."""
    import torch
    from adalog_tpu_torch.models.swin import SwinTransformer

    rng = np.random.default_rng(seed)
    sd = {}
    for key, t in SwinTransformer(cfg, device="meta").state_dict().items():
        shape = tuple(t.shape)
        if key.endswith("bias"):
            sd[key] = np.zeros(shape, np.float32)
        elif ".norm" in key or key.startswith("norm"):
            sd[key] = np.ones(shape, np.float32)
        else:
            std = (2.0 / shape[1]) ** 0.5 if key.endswith("qkv.weight") \
                else 0.02
            sd[key] = (std * rng.standard_normal(shape)).astype(np.float32)
    return sd


def smoke_qstate(torch, spec, model, images, device, post="adalog", bits=4):
    """A SMOKE quantizer state, not an FPCS calibration: init_qstate at
    ``bits`` with activation scales and zero points set by min/max from one
    raw capture pass (per head at the attention matmuls) and the AdaLog
    bases of the post-GeLU and post-softmax sites set to SMOKE_LOG_Q.
    ``post`` is the configuration's post_softmax_quantizer."""
    from adalog_tpu_torch.calib.init_state import init_qstate
    from adalog_tpu_torch.models.layers import LinearSite, MatMulSite
    from adalog_tpu_torch.models.zoo import model_forward_fn

    qstate = init_qstate(spec, quant_config(bits, post_softmax_quantizer=post),
                         model)
    with torch.no_grad():
        _, taps = model_forward_fn(spec)(spec.cfg, model, images.to(device),
                                         capture=True)

    def minmax(qs, x, dims):
        n = 2 ** qs.bits - 1
        lo = torch.clamp(x.amin(dim=dims, keepdim=True), max=0.0)
        hi = torch.clamp(x.amax(dim=dims, keepdim=True), min=0.0)
        scale = torch.clamp((hi - lo) / n, min=1e-8)
        qs.scale = scale.reshape(qs.scale.shape)
        qs.zero_point = torch.round(-lo / scale).reshape(qs.scale.shape)

    log_q = torch.tensor(SMOKE_LOG_Q, device=device)
    with torch.no_grad():
        for name, site in qstate.items():
            if isinstance(site, LinearSite):
                x = taps[name][0]
                if site.aq.kind == "uniform":
                    minmax(site.aq, x, tuple(range(x.dim())))
                elif site.aq.kind == "adalog":        # shifted post-GeLU
                    site.aq.scale = (x + site.aq.shift).amax().reshape(1)
                    site.aq.log_q = log_q
            elif isinstance(site, MatMulSite):
                A, B = taps[name][0], taps[name][1]
                if site.Aq.kind == "uniform":
                    minmax(site.Aq, A, (0, 2, 3))
                elif site.Aq.kind == "adalog":
                    site.Aq.log_q = log_q
                minmax(site.Bq, B, (0, 2, 3))
    return qstate


def attention_blocks(spec):
    """[(site prefix '….attn', attention module path, stage, block)] of
    every attention of the model, in forward order."""
    if spec.family == "vit":
        return [(f"blocks.{i}.attn", f"blocks.{i}.attn", 0, i)
                for i in range(spec.cfg.depth)]
    return [(f"layers.{i}.blocks.{j}.attn", f"layers.{i}.blocks.{j}.attn",
             i, j)
            for i, depth in enumerate(spec.cfg.depths) for j in range(depth)]


def attention_bias(spec, model, path, stage, blk, dtype):
    """(logit_scale, flash bias or None, shift mask or None) of one
    attention: ViT scales the logits and has no bias; Swin scales q before
    matmul1 and adds the rel-pos bias and, in a shifted block, the mask."""
    if spec.family == "vit":
        return spec.cfg.head_dim ** -0.5, None, None
    from adalog_tpu_torch.models import swin

    ap = model.get_submodule(path)
    mask = swin.block_shift_mask(spec.cfg, stage, blk,
                                 ap.qkv.weight.device, dtype)
    return 1.0, swin.flash_bias(ap, mask), mask


def block_check(torch, fq_attn, fq_gemm, spec, model, qstate, x, dt,
                require_mma=True, n_linear=None, skip=(), bits=4):
    """Hold K1 against its plain version on the q/kT/v (and, for Swin, the
    rel-pos bias and shift mask) that every block of the quantized model
    gives it for images x (as the wrapper routes it: variant "mma",
    asserted; max|diff| of each block at most its largest |uq(v)|), and K4
    on the input of every Linear site that takes it, called as the served
    path calls it (``fq_gemm.run`` on the table entry, weight codes
    included for fp32; every launch variant "mma", asserted), from one
    capture pass with the served path's tables active; returns {kernel: (largest
    max|diff|, largest share past tolerance)}. With ``require_mma`` False a
    call of variant "fma" is reported with the reason, not failed. On a tp
    rank's slices the caller enters the row-parallel context and names the
    row-parallel sites (``skip``, which take no K4) and the count of the
    rest that do (``n_linear``)."""
    from adalog_tpu_torch.models.zoo import model_forward_fn
    from adalog_tpu_torch.ops import weight_prep

    cfg = quant_config(bits)
    wprep = weight_prep.prepare(spec, model, qstate, cfg)
    # as make_predictor builds it: fp32 sites carry their weight codes
    table = fq_gemm.prepare(
        qstate, weight_prep.weight_codes(spec, model, qstate, cfg)
        if dt == "float32" else None, skip=skip)
    if n_linear is None:
        n_linear = MODELS[spec.name]["K4"]
    check(len(table) == n_linear,
          f"{len(table)} Linear sites take K4, want {n_linear}")
    worst = {"K1": (0.0, 0.0), "K4": (0.0, 0.0)}
    fma_before = fq_attn.fq_flash_attn.variant_launches["fma"]
    gemm_fma_before = fq_gemm.fq_gemm.variant_launches["fma"]

    def note(k, d, share):
        worst[k] = (max(worst[k][0], d), max(worst[k][1], share))

    with torch.inference_mode(), weight_prep.activate(wprep), \
            fq_gemm.activate(table):
        _, taps = model_forward_fn(spec)(spec.cfg, model, x, qstate,
                                         {"*": "quant"}, capture=True)
        for p, path, stage, blk in attention_blocks(spec):
            q, kT, _ = taps[f"{p}.matmul1"]
            _, v, _ = taps[f"{p}.matmul2"]
            args, bits = fq_attn.flash_args(qstate[f"{p}.matmul1"],
                                            qstate[f"{p}.matmul2"], q, kT, v)
            scale, bias, _ = attention_bias(spec, model, path, stage, blk,
                                            x.dtype)
            kw = dict(logit_scale=scale, **bits)
            got = fq_attn.fq_flash_attn(*args, bias, **kw)
            want = fq_attn.fq_flash_attn_plain(*args, bias, **kw)
            check(bool(torch.isfinite(got).all()), f"{p}: K1 not finite")
            d, share = compare(got, want, RTOL)
            cap = flash_cap(torch, args[2], args[6], bits["m2b_bits"])
            check(d <= cap, f"{p} {dt}: K1 max|diff| {d} above the largest "
                  f"|uq(v)| {cap}")
            note("K1", d, share)
        for name, site in table.items():
            xin = taps[name][0]
            xin = xin.reshape(-1, xin.shape[-1])
            w, bias = wprep[name], model.get_submodule(name).bias
            got = fq_gemm.run(site, xin, w, bias)      # the served call
            want = fq_gemm.fq_gemm_plain(xin, w, site.params, bias,
                                         kind=site.kind, bits=site.bits)
            check(bool(torch.isfinite(got).all()), f"{name}: K4 not finite")
            note("K4", *compare(got, want, GEMM_RTOL[dt]))
    fma = (fq_attn.fq_flash_attn.variant_launches["fma"] - fma_before,
           fq_gemm.fq_gemm.variant_launches["fma"] - gemm_fma_before)
    if any(fma):
        print(f"block check {spec.name} {dt}: variant 'fma' launches K1 "
              f"{fma[0]}, K4 {fma[1]}; why: "
              f"{fma_reasons(torch, fq_attn, fq_gemm, spec, model, qstate,
                             dt, bits)}")
    check(not require_mma or fma[0] == 0,
          f"{spec.name} {dt}: a block's K1 call took variant 'fma'")
    check(not require_mma or fma[1] == 0,
          f"{spec.name} {dt}: a Linear site's K4 call took variant 'fma'")
    return worst


def fma_reasons(torch, fq_attn, fq_gemm, spec, model, qstate, dt, bits=4):
    """{site: why variant "mma" refuses it} for every attention (K1) and
    Linear (K4) site of a served model in dtype ``dt``."""
    from adalog_tpu_torch.ops import weight_prep

    dtype = getattr(torch, dt)
    cfg = spec.cfg
    S = cfg.num_patches + 1 if spec.family == "vit" else cfg.window ** 2
    D = cfg.head_dim if spec.family == "vit" else cfg.embed_dim // cfg.heads[0]
    exact = fq_attn.integers_exact(qstate)
    why = {}
    for p, *_ in attention_blocks(spec):
        m1, m2 = qstate[f"{p}.matmul1"], qstate[f"{p}.matmul2"]
        bits = (m1.Aq.bits, m1.Bq.bits, m2.Aq.bits, m2.Bq.bits)
        reason = fq_attn.mma_refusal(S, D, dtype, bits, exact)
        if reason is not None:
            why[p] = reason
    codes = weight_prep.weight_codes(spec, model, qstate, quant_config(bits)) \
        if dt == "float32" else None
    for name, site in fq_gemm.prepare(qstate, codes).items():
        reason = fq_gemm.mma_refusal(
            dtype, site.kind, site.bits, site.codes,
            fq_gemm.activation_ints_exact(site.params, site.kind, site.bits))
        if reason is not None:
            why[name] = reason
    return why


# serving settings: (name, use_pallas, use_pallas_gemm)
SETTINGS = (("attention kernel", True, False),
            ("attention + GEMM kernels", True, True),
            ("plain", False, False))
# launches a batch with the kernels on: K1 once a block (deit_small 12;
# swin_tiny 2 + 2 + 6 + 2), K4 at every Linear site (deit_small 4 a block
# and the head; swin_tiny 4 a block, 3 reductions and head.fc); the zoo
# phase's models beside them (vit_large 24 blocks; swin_base and
# swin_base_384 2 + 2 + 18 + 2)
MODELS = {"deit_small": {"K1": 12, "K4": 49},
          "swin_tiny": {"K1": 12, "K4": 52},
          "deit_tiny": {"K1": 12, "K4": 49},
          "deit_base": {"K1": 12, "K4": 49},
          "vit_large": {"K1": 24, "K4": 97},
          "swin_base": {"K1": 24, "K4": 100},
          "swin_base_384": {"K1": 24, "K4": 100}}
# the smoke models of the serving, fall-back and profile phases
SMOKE_MODELS = ("deit_small", "swin_tiny")
# the zoo phase: every other zoo shape at full depth and width (vit_tiny
# and vit_base have deit_tiny's and deit_base's shapes, swin_small
# swin_tiny's widths at swin_base's depths); K2 and K3 at the two with the
# most blocks and the largest windows
ZOO_MODELS = ("deit_tiny", "deit_base", "vit_large", "swin_base",
              "swin_base_384")
ZOO_FALLBACK = ("vit_large", "swin_base_384")
# K5 launches a batch with eval_int8: every uniform Linear site (deit_small
# qkv, proj and fc1 of each block and the head; swin_tiny the same, its 3
# reductions and head.fc); the AdaLog fc2 sites stay on K4 (12 a batch)
# with the GEMM switch, else on the plain path
INT8_MODELS = {"deit_small": 37, "swin_tiny": 40}
# int8 serving settings: (name, use_pallas, use_pallas_gemm)
INT8_SETTINGS = (("int8 + attention kernel", True, False),
                 ("int8 + attention + GEMM kernels", True, True))


def wrappers(fq_attn, fq_gemm):
    from adalog_tpu_torch.ops import int8_linear

    return {"K1": fq_attn.fq_flash_attn, "K2": fq_attn.fq_softmax_attn_matmul,
            "K3": fq_attn.fq_attn_matmul, "K4": fq_gemm.fq_gemm,
            "K5": int8_linear.int8_gemm}


def zero_launches(fq_attn, fq_gemm):
    for w in wrappers(fq_attn, fq_gemm).values():
        w.launches = 0
        for v in w.variant_launches:
            w.variant_launches[v] = 0


def k5_variants():
    """K5's launches by variant since the counts were last set to 0."""
    from adalog_tpu_torch.ops import int8_linear

    return dict(int8_linear.int8_gemm.variant_launches)


def check_k5_variants(n, tag):
    """Every one of the n K5 launches of a served path was "wgmma": each
    block site, and the heads' 32-row calls, whose rows past 32 the kernel
    computes and never stores."""
    got = k5_variants()
    check(got == {"wgmma": n, "mma": 0},
          f"{tag}: K5 launches by variant {got}, want all {n} 'wgmma'")


def read_launches(fq_attn, fq_gemm):
    return {k: w.launches for k, w in wrappers(fq_attn, fq_gemm).items()}


def smoke_model(torch, device, ckpt_dir, name="deit_small", post="adalog",
                bits=4):
    """Model ``name`` at full depth and width with random weights from SEED
    and its smoke state at ``bits`` (post-softmax quantizer ``post``) with
    fc2 folded, saved as a v2 .ckpt; returns (spec, model, qstate, ckpt
    path, N_BATCHES numpy batches of BATCH images)."""
    from adalog_tpu_torch.models.load import load_state_dict
    from adalog_tpu_torch.models.zoo import model_spec
    from adalog_tpu_torch.utils.checkpoint import save_checkpoint

    spec = model_spec(name)
    cfg = spec.cfg
    rng = np.random.default_rng(SEED + 1)
    shape = (BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    batches = [rng.standard_normal(shape).astype(np.float32)
               for _ in range(N_BATCHES)]
    calib = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    weights = timm_weights if spec.family == "vit" else swin_weights
    model = load_state_dict(spec, weights(cfg, SEED)).to(device)
    qstate = smoke_qstate(torch, spec, model, calib, device, post, bits)
    fold_fc2(torch, model, qstate)
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(ckpt_dir, f"{name}_smoke_w{bits}a{bits}_{post}.ckpt")
    save_checkpoint(ckpt, model, qstate, {"model": name,
                                          "state": "smoke, not FPCS"})
    return spec, model, qstate, ckpt, batches


def predictors(ckpt, device, batch, name="deit_small", settings=SETTINGS,
               bits=4, **cfg_kw):
    """{(dtype, setting): predict} for every serving setting in float32 and
    bfloat16, loaded through load_quantized at ``bits`` and run once on
    ``batch``."""
    from adalog_tpu_torch.serve import load_quantized

    preds = {}
    for dt in ("float32", "bfloat16"):
        for setting, attn, gemm in settings:
            predict, *_ = load_quantized(
                name, ckpt, device=device, eval_dtype=dt, use_pallas=attn,
                config=quant_config(bits, use_pallas_gemm=gemm, **cfg_kw))
            predict(batch)                           # warm-up
            preds[dt, setting] = predict
    return preds


def serve(torch, predict, batches):
    """(logits of all batches, img/s) of one pass, synchronized."""
    t0 = time.perf_counter()
    outs = [predict(x) for x in batches]
    torch.cuda.synchronize()
    return torch.cat(outs), len(batches) * BATCH / (time.perf_counter() - t0)


def check_logits(torch, y, spec, n, tag):
    check(tuple(y.shape) == (n, spec.cfg.num_classes),
          f"{tag} logits shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), f"{tag} logits not finite")
    check(y.float().std().item() > 0, f"{tag} logits constant")


def serving_phase(torch, fq_attn, fq_gemm, device, ckpt_dir,
                  name="deit_small"):
    """Serve model ``name`` with its smoke state through load_quantized;
    returns serve_checked's pair."""
    spec, model, qstate, ckpt, batches = smoke_model(torch, device, ckpt_dir,
                                                     name)
    return serve_checked(torch, fq_attn, fq_gemm, device, spec, model, qstate,
                         ckpt, batches)


def serve_checked(torch, fq_attn, fq_gemm, device, spec, model, qstate, ckpt,
                  batches, tag=None, require_mma=True, bits=4):
    """Block checks on the model's own tensors in both dtypes, then the
    state in ``ckpt`` served through load_quantized in every setting and
    dtype, launch counts asserted (every launch a kernel); with
    ``require_mma`` every launch also variant "mma", else the variants are
    printed with the reason for any "fma". Deletes ``ckpt``; leaves
    ``model`` as it was (the checks run on copies in each dtype, since a
    calibrated model shares its modules with the state it came from).
    Returns
    ({kernel: launches on the main path, attention + GEMM kernels},
    {kernel: largest block-check max|diff|})."""
    name = spec.name
    tag = tag or name
    n_attn, n_linear = MODELS[name]["K1"], MODELS[name]["K4"]
    worst = {"K1": 0.0, "K4": 0.0}
    x0 = torch.from_numpy(batches[0]).to(device)
    for dt, dtype in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        m = copy.deepcopy(model).to(dtype)
        res = block_check(torch, fq_attn, fq_gemm, spec, m, qstate,
                          x0.to(dtype), dt, require_mma, bits=bits)
        for k, what in (("K1", f"the q/kT/v of all {n_attn} blocks"),
                        ("K4", f"the inputs of all {n_linear} Linear sites")):
            d, share = res[k]
            cap = "each block's largest |uq(v)|" if k == "K1" else FLIP_MAX
            print(f"block check {tag} {dt}: {k} vs plain on {what}, batch "
                  f"{BATCH}: max|diff|={d:.3e} share_past_tol={share:.3e} "
                  f"(allowed share {FLIP_SHARE}, max {cap})")
            check(share <= FLIP_SHARE,
                  f"{tag} {dt} {k} block check share {share}")
            check(k == "K1" or d <= FLIP_MAX,
                  f"{tag} {dt} {k} block check max|diff| {d}")
            worst[k] = max(worst[k], d)
    reasons = {dt: fma_reasons(torch, fq_attn, fq_gemm, spec, copy.deepcopy(
        model).to(getattr(torch, dt)), qstate, dt, bits)
        for dt in ("float32", "bfloat16")}
    del model, qstate, m
    torch.cuda.empty_cache()

    preds = predictors(ckpt, device, batches[0], name, bits=bits)
    os.remove(ckpt)
    torch.cuda.synchronize()

    # each setting is a path of its own, driven in both dtypes with the
    # launch counts set to 0 just before and read just after; the main path
    # is the second, attention + GEMM kernels
    per_batch = {"attention kernel": (n_attn, 0),
                 "attention + GEMM kernels": (n_attn, n_linear),
                 "plain": (0, 0)}
    served, launches = {}, {}
    for setting, *_ in SETTINGS:
        zero_launches(fq_attn, fq_gemm)
        for dt in ("float32", "bfloat16"):
            served[dt, setting] = serve(torch, preds[dt, setting], batches)
        got = read_launches(fq_attn, fq_gemm)
        want = {"K1": per_batch[setting][0] * N_BATCHES * 2, "K2": 0, "K3": 0,
                "K4": per_batch[setting][1] * N_BATCHES * 2, "K5": 0}
        print(f"serving path {tag} '{setting}': launches {got} for 2 x "
              f"{N_BATCHES} batches of {BATCH} (want K1 "
              f"{per_batch[setting][0]}, K4 {per_batch[setting][1]} per "
              f"batch: {want}); by variant K1 "
              f"{fq_attn.fq_flash_attn.variant_launches}, K4 "
              f"{fq_gemm.fq_gemm.variant_launches}")
        check(got == want, f"{tag} '{setting}' launches {got} != {want}")
        for k, wrapper in (("K1", fq_attn.fq_flash_attn),
                           ("K4", fq_gemm.fq_gemm)):
            by_variant = wrapper.variant_launches
            check(sum(by_variant.values()) == want[k],
                  f"{tag} '{setting}': {k} launches by variant {by_variant}")
            if by_variant["fma"]:
                print(f"serving path {tag} '{setting}': {k} took variant "
                      f"'fma' {by_variant['fma']} times; why: {reasons}")
            check(not require_mma or by_variant["fma"] == 0,
                  f"{tag} '{setting}': {k} launches by variant {by_variant}, "
                  "want every one 'mma'")
        launches[setting] = got

    for dt in ("float32", "bfloat16"):
        for setting, *_ in SETTINGS:
            y, ips = served[dt, setting]
            check_logits(torch, y, spec, BATCH * N_BATCHES,
                         f"{tag} {dt} {setting}")
            print(f"serving {tag} {dt}, {setting}: {ips:.1f} img/s; "
                  f"{card_line()}")
        for a, b in ((1, 0), (1, 2), (0, 2)):
            (ya, _), (yb, _) = served[dt, SETTINGS[a][0]], \
                served[dt, SETTINGS[b][0]]
            agree = (ya.argmax(-1) == yb.argmax(-1)).float().mean().item()
            rel = ((ya - yb).norm() / yb.norm()).item()
            print(f"serving {tag} {dt} logits, {SETTINGS[a][0]} vs "
                  f"{SETTINGS[b][0]}: top-1 agreement {agree:.4f}, max|diff| "
                  f"{(ya - yb).abs().max().item():.4e}, rel L2 {rel:.4e} "
                  f"(max|logit| {yb.abs().max().item():.4e})")
    return launches["attention + GEMM kernels"], worst


def matmul_block_check(torch, fq_attn, spec, model, qstate, x, dt):
    """Hold K2 and K3 against their plain versions, and against the forward
    with the kernels off, on the tensors every attention of the quantized
    model forms for images x: one capture pass with the kernels off gives
    each block's q, kT, matmul1 output, probabilities, v and matmul2 output;
    the logits K2 takes are formed from the matmul1 output as the forward
    forms them. Every launch must be variant "mma". Returns {"K2" | "K3": (largest max|diff| to the plain
    version, largest share past tolerance to it, largest share past
    tolerance to the forward's own output)}."""
    from adalog_tpu_torch.models.zoo import model_forward_fn

    worst = {"K2": (0.0, 0.0, 0.0), "K3": (0.0, 0.0, 0.0)}
    fma_before = [w.variant_launches["fma"] for w in
                  (fq_attn.fq_softmax_attn_matmul, fq_attn.fq_attn_matmul)]

    def hold(k, tag, fn, plain, args, kw, fwd_out):
        got = fn(*args, **kw)
        check(bool(torch.isfinite(got).all()), f"{tag}: {k} not finite")
        d, share = compare(got, plain(*args, **kw), RTOL)
        # a batch holds ~1e8 probabilities, so a few lie within an ulp of an
        # AdaLog code boundary, large ones among them (p = 0.76 is one): a
        # flipped code moves p by less than one whole probability, so an
        # output by less than the largest value of B
        cap = max(FLIP_MAX, args[1].abs().max().item())
        check(d <= cap, f"{tag} {dt}: {k} max|diff| {d} above {cap}")
        # the forward's output is in the compute dtype
        _, fwd_share = compare(got.reshape(fwd_out.shape).to(fwd_out.dtype),
                               fwd_out, GEMM_RTOL[dt])
        worst[k] = tuple(max(a, b) for a, b in
                         zip(worst[k], (d, share, fwd_share)))

    with torch.inference_mode():
        _, taps = model_forward_fn(spec)(spec.cfg, model, x, qstate,
                                         {"*": "quant"}, capture=True)
        for p, path, stage, blk in attention_blocks(spec):
            q, kT, attn = taps[f"{p}.matmul1"]
            probs, v, out = taps[f"{p}.matmul2"]
            (qf, kTf, vf, m1a, m1b, m2q, m2b), bits = fq_attn.flash_args(
                qstate[f"{p}.matmul1"], qstate[f"{p}.matmul2"], q, kT, v)
            scale, _, mask = attention_bias(spec, model, path, stage, blk,
                                            x.dtype)
            if spec.family == "vit":
                logits = attn * scale
            else:
                from adalog_tpu_torch.models.swin import add_window_bias
                logits = add_window_bias(model.get_submodule(path), attn,
                                         mask)
            G, S = qf.shape[:2]
            m2a = torch.stack([m2q, torch.zeros_like(m2q)], dim=1)
            hold("K3", f"{p}.matmul1", fq_attn.fq_attn_matmul,
                 fq_attn.fq_attn_matmul_plain, (qf, kTf, m1a, m1b),
                 dict(a_kind="uniform", a_bits=bits["m1a_bits"],
                      b_bits=bits["m1b_bits"]), attn)
            hold("K3", f"{p}.matmul2", fq_attn.fq_attn_matmul,
                 fq_attn.fq_attn_matmul_plain,
                 (probs.reshape(G, S, S), vf, m2a, m2b),
                 dict(a_kind="adalog", a_bits=bits["m2a_bits"],
                      b_bits=bits["m2b_bits"]), out)
            hold("K2", f"{p}.matmul2", fq_attn.fq_softmax_attn_matmul,
                 fq_attn.fq_softmax_attn_matmul_plain,
                 (logits.reshape(G, S, S), vf, m2a, m2b),
                 dict(a_bits=bits["m2a_bits"], b_bits=bits["m2b_bits"]), out)
    check([w.variant_launches["fma"] for w in
           (fq_attn.fq_softmax_attn_matmul, fq_attn.fq_attn_matmul)]
          == fma_before,
          f"{spec.name} {dt}: a block's K2 or K3 call took variant 'fma'")
    return worst


def fallback_phase(torch, fq_attn, fq_gemm, device, ckpt_dir, name):
    """Drive K2 and K3 through the forward of model ``name`` at full depth
    and width, by the three configurations that reach them, in float32 and
    bfloat16, launch counts asserted:
      - post_softmax_quantizer='log2', served through load_quantized: the
        fused paths decline and matmul1 of every block takes K3;
      - a quant-mode forward with capture=True inside fq_attn.activate: both
        matmuls of every block take K3;
      - the forward's modes with every matmul1 site 'raw': K2 once a block;
    every one of these launches is variant "mma". Before that, matmul_block_check on the served model's own tensors.
    Returns ({"K2" | "K3": launches of these paths}, {"K2" | "K3": largest
    block-check max|diff|})."""
    from adalog_tpu_torch.models.zoo import model_forward_fn

    n_attn = MODELS[name]["K1"]
    spec, model, qstate, ckpt, batches = smoke_model(torch, device, ckpt_dir,
                                                     name)
    os.remove(ckpt)
    fwd = model_forward_fn(spec)
    x0 = torch.from_numpy(batches[0]).to(device)
    raw_m1 = {"*": "quant", **{f"{p}.matmul1": "raw"
                               for p, *_ in attention_blocks(spec)}}
    worst = {"K2": 0.0, "K3": 0.0}
    total = {"K2": 0, "K3": 0}
    # as make_predictor does: the verdict on the zero points and the sites'
    # flattened parameters taken once, not by every call
    exact = fq_attn.integers_exact(qstate)
    site_params = fq_attn.prepare(qstate)

    def drove(path, want):
        got = read_launches(fq_attn, fq_gemm)
        print(f"fall-back path {name} '{path}': launches {got} (want "
              f"{want})")
        check(got == {"K1": 0, "K4": 0, "K5": 0, **want},
              f"{name} '{path}' launches {got}")
        for k in total:
            by_variant = wrappers(fq_attn, fq_gemm)[k].variant_launches
            check(by_variant == {"mma": want[k], "fma": 0},
                  f"{name} '{path}': {k} launches by variant {by_variant}, "
                  "want every one 'mma'")
        for k in total:
            total[k] += got[k]

    for dt, dtype in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        m, x = model.to(dtype), x0.to(dtype)
        res = matmul_block_check(torch, fq_attn, spec, m, qstate, x, dt)
        for k, (d, share, fwd_share) in res.items():
            print(f"block check {name} {dt}: {k} on the tensors of all "
                  f"{n_attn} blocks, batch {BATCH}: vs plain max|diff|="
                  f"{d:.3e} share_past_tol={share:.3e}; vs the forward with "
                  f"kernels off share_past_tol={fwd_share:.3e} (allowed "
                  f"share {FLIP_SHARE}, max the largest value of B)")
            check(share <= FLIP_SHARE, f"{name} {dt} {k} share {share}")
            # bf16: the unfused forward rounds the probabilities to bf16
            # before the AdaLog quantizer and K2 does not, so they take
            # other codes by design; reported, not held
            check(fwd_share <= FLIP_SHARE or (k, dt) == ("K2", "bfloat16"),
                  f"{name} {dt} {k} share to the forward {fwd_share}")
            worst[k] = max(worst[k], d)

        zero_launches(fq_attn, fq_gemm)
        with torch.inference_mode(), fq_attn.activate(True, exact,
                                                      site_params):
            y, _ = fwd(spec.cfg, m, x, qstate, {"*": "quant"}, capture=True)
        torch.cuda.synchronize()
        check_logits(torch, y, spec, BATCH, f"{name} {dt} capture")
        drove(f"capture=True, {dt}", {"K2": 0, "K3": 2 * n_attn})

        zero_launches(fq_attn, fq_gemm)
        with torch.inference_mode(), fq_attn.activate(True, exact,
                                                      site_params):
            y = fwd(spec.cfg, m, x, qstate, raw_m1)
        torch.cuda.synchronize()
        check_logits(torch, y, spec, BATCH, f"{name} {dt} matmul1 raw")
        drove(f"matmul1 raw, {dt}", {"K2": n_attn, "K3": 0})
    del model, qstate, m
    torch.cuda.empty_cache()

    *_, ckpt, _ = smoke_model(torch, device, ckpt_dir, name, post="log2")
    preds = predictors(ckpt, device, batches[0], name, SETTINGS[:1],
                       post_softmax_quantizer="log2")
    os.remove(ckpt)
    zero_launches(fq_attn, fq_gemm)
    for dt in ("float32", "bfloat16"):
        y, ips = serve(torch, preds[dt, SETTINGS[0][0]], batches)
        check_logits(torch, y, spec, BATCH * N_BATCHES, f"{name} {dt} log2")
        print(f"serving {name} {dt}, log2 post-softmax quantizer, K3 on "
              f"matmul1: {ips:.1f} img/s; {card_line()}")
    drove("log2, load_quantized", {"K2": 0, "K3": n_attn * N_BATCHES * 2})
    return total, worst


# Calibration phase: the shipped configs/4bit.py numbers (quant_config's
# defaults: calib_size 32, eq_n 128, steps 6, search_round 3, FPCS,
# LayerNorm reparam, AdaLog post-softmax and post-GeLU, head-wise matmuls,
# qconv_a_bit 8, qhead_a_bit 4) on CALIB_MODEL at full depth and width
CALIB_MODEL, CALIB_SIZE = "deit_small", 32
CHECK_MODEL = "test_tiny"        # calibrated on the card and on the CPU
# card vs CPU: integer picks (zero points, AdaLog bases) exact or on the
# adjacent candidate, at most ADJACENT_SHARE of them adjacent (log2 may
# differ by an ulp between the devices); scales of the sites whose picks
# all agree within CALIB_SCALE_RTOL, at most MOVED_SHARE of them past it.
# FPCS refines each scale five times around its survivors; near the optimum
# the score is flat, and the last refine steps (1e-5 to 1e-3 apart, relative)
# differ by less than the fp32 sums resolve, so cuBLAS's order of the sums
# and the CPU's pick neighbouring candidates there (measured on the card:
# every integer pick equal, scales up to 4.1e-4 apart)
CALIB_SCALE_RTOL = 1e-3
ADJACENT_SHARE = 0.05
MOVED_SHARE = 0.02


def qstate_fields(site, prefix=""):
    """(field path, value) of every leaf of a site's quantizer state."""
    import dataclasses

    for f in dataclasses.fields(site):
        v = getattr(site, f.name)
        if dataclasses.is_dataclass(v):
            yield from qstate_fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def compare_qstates(torch, got, want):
    """Site by site: flags and kinds equal; integer picks (zero points,
    AdaLog bases) exact or adjacent; the other tensors (scales) of each
    site whose picks all agree, relative to ``want``. Returns dict(picks,
    adjacent, scales, moved: scale entries past CALIB_SCALE_RTOL,
    worst_rel)."""
    check(set(got) == set(want), "the two states hold other sites")
    n = dict(picks=0, adjacent=0, scales=0, moved=0, worst_rel=0.0)
    for name in want:
        a, b = dict(qstate_fields(got[name])), dict(qstate_fields(want[name]))
        check(a.keys() == b.keys(), f"{name}: other fields")
        agree, scales = True, []
        for k, va in a.items():
            vb = b[k]
            if not isinstance(va, torch.Tensor):
                check(va == vb, f"{name} {k}: {va} != {vb}")
                continue
            va, vb = va.cpu(), vb.cpu()
            if va.dtype == torch.bool:
                check(torch.equal(va, vb), f"{name} {k} differs")
            elif k.split(".")[-1] in ("zero_point", "log_q"):
                d = (va - vb).abs()
                check(bool((d <= 1).all()),
                      f"{name} {k}: picks past the adjacent candidate")
                n["picks"] += d.numel()
                n["adjacent"] += int((d != 0).sum())
                agree = agree and not bool((d != 0).any())
            else:
                scales.append((va.float(), vb.float()))
        if agree:
            for va, vb in scales:
                rel = (va - vb).abs() / vb.abs().clamp(min=1e-30)
                n["scales"] += rel.numel()
                n["moved"] += int((rel > CALIB_SCALE_RTOL).sum())
                n["worst_rel"] = max(n["worst_rel"], rel.max().item())
    return n


def calibrate_on(torch, spec, model, images, device, cfg=None):
    """One calibration through QuantCalibrator at ``cfg`` (quant_config()
    when None) on ``device``: (model, qstate, calibrator, wall seconds,
    synchronized, (model, qstate) before the post-GeLU fold, as a
    reconstruction starts from them)."""
    from adalog_tpu_torch.calib.calibrator import QuantCalibrator

    t0 = time.perf_counter()
    calib = QuantCalibrator(spec, model, cfg or quant_config(), device=device)
    unfolded = calib.calibrate([images])
    params, qstate = calib.finish_calibration()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return params, qstate, calib, time.perf_counter() - t0, unfolded


def check_calibrated(torch, fq_gemm, calib, qstate):
    """Every site of the layout has a state and every AdaLog base is a
    positive integer that fq_gemm.prepare takes; returns the bases."""
    check(set(qstate) == set(calib.layout),
          f"calibrated sites {len(qstate)} != layout {len(calib.layout)}")
    bases = []
    for name, site in qstate.items():
        for k, v in qstate_fields(site):
            if k.endswith("log_q") and v is not None:
                q = float(v)
                check(q >= 1 and q == int(q), f"{name} {k}: base {q}")
                bases.append(int(q))
    fq_gemm.prepare(qstate)        # raises on a base the kernel cannot take
    return bases


def calibration_images(cfg, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.img_size, cfg.img_size, cfg.in_chans)).astype(np.float32)


def calibration_phase(torch, fq_attn, fq_gemm, device, ckpt_dir):
    """Calibrate CALIB_MODEL (random weights from SEED, no smoke state) on
    the card at the shipped W4A4 numbers, twice (cold, then warm), with the
    capture and each search family timed; check the state; hold its
    held-out logit MSE to the raw model below the min/max smoke state's;
    save it, serve it through load_quantized (serve_checked: block checks,
    launches asserted, variants printed); then calibrate CHECK_MODEL on the
    card and on the CPU and compare the two states. Returns serve_checked's
    pair and the warm run's start of a reconstruction: dict(spec, model
    (the raw model), params and qstate before the post-GeLU fold, calib
    (the warm calibrator), held_out images, mse_calibrated, served: the
    folded (params, qstate) that was served)."""
    from collections import Counter

    from adalog_tpu_torch.models.load import load_state_dict
    from adalog_tpu_torch.models.zoo import (
        build_model, model_forward_fn, model_spec,
    )
    from adalog_tpu_torch.utils.checkpoint import save_checkpoint

    spec = model_spec(CALIB_MODEL)
    cfg = spec.cfg
    images = calibration_images(cfg, CALIB_SIZE, SEED + 7)
    held_out = calibration_images(cfg, CALIB_SIZE, SEED + 8)
    batches = [calibration_images(cfg, BATCH, SEED + 9 + i)
               for i in range(N_BATCHES)]
    model = load_state_dict(spec, timm_weights(cfg, SEED)).to(device)
    line = card_line()
    runs = []
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats(device)
        params, qstate, calib, wall, unfolded = calibrate_on(
            torch, spec, model, images, device)
        peak = torch.cuda.max_memory_allocated(device)
        runs.append(dict(wall_s=wall, peak_bytes=peak, seconds=calib.seconds))
        print(f"calibration {CALIB_MODEL} W4A4 ({run}): wall {wall:.2f} s "
              f"(capture {calib.seconds['capture']:.2f} s; searches "
              + ", ".join(f"{k} {v:.2f} s" for k, v in calib.seconds.items()
                          if k != "capture")
              + f"); peak device memory {peak / 2**30:.2f} GiB; {line}")
        if run == "cold":
            first = qstate
    n = compare_qstates(torch, qstate, first)
    print(f"calibration {CALIB_MODEL}: warm run vs cold run: {n}")
    bases = check_calibrated(torch, fq_gemm, calib, qstate)
    print(f"calibration {CALIB_MODEL}: {len(qstate)} sites calibrated; "
          f"AdaLog bases {sorted(Counter(bases).items())}")

    fwd = model_forward_fn(spec)
    x = torch.from_numpy(held_out).to(device)
    smoke = smoke_qstate(torch, spec, model, torch.from_numpy(images), device)
    with torch.no_grad():
        y_raw = fwd(cfg, model, x)
        mse_cal = torch.mean((fwd(cfg, params, x, qstate, {"*": "quant"})
                              - y_raw) ** 2).item()
        mse_mm = torch.mean((fwd(cfg, model, x, smoke, {"*": "quant"})
                             - y_raw) ** 2).item()
    print(f"calibration {CALIB_MODEL} quality on {CALIB_SIZE} held-out "
          f"images: logit MSE to the raw model {mse_cal:.6e} calibrated, "
          f"{mse_mm:.6e} min/max smoke state (must be lower)")
    check(np.isfinite(mse_cal) and mse_cal < mse_mm,
          f"calibrated logit MSE {mse_cal} not below min/max {mse_mm}")
    print(json.dumps({"calibration": {
        "model": CALIB_MODEL, "card": line, "runs": runs,
        "sites": len(qstate), "mse_calibrated": mse_cal,
        "mse_minmax": mse_mm}}))

    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(ckpt_dir, f"{CALIB_MODEL}_calibrated_w4a4.ckpt")
    save_checkpoint(ckpt, params, qstate, {
        "model": CALIB_MODEL, "state": "FPCS calibration, random weights"})
    start = dict(spec=spec, model=model, params=unfolded[0],
                 qstate=unfolded[1], calib=calib, held_out=held_out,
                 mse_calibrated=mse_cal)
    del smoke, first, unfolded
    torch.cuda.empty_cache()
    served = serve_checked(torch, fq_attn, fq_gemm, device, spec, params,
                           qstate, ckpt, batches,
                           tag=f"{CALIB_MODEL} calibrated", require_mma=False)
    start["served"] = (params, qstate)      # the folded state, for int8
    del params, qstate
    torch.cuda.empty_cache()

    spec_t = model_spec(CHECK_MODEL)
    _, tiny = build_model(CHECK_MODEL, seed=SEED)
    imgs = calibration_images(spec_t.cfg, CALIB_SIZE, SEED + 13)
    _, q_gpu, _, t_gpu, _ = calibrate_on(torch, spec_t, tiny, imgs, device)
    _, q_cpu, _, t_cpu, _ = calibrate_on(torch, spec_t, tiny, imgs,
                                         torch.device("cpu"))
    n = compare_qstates(torch, q_gpu, q_cpu)
    print(f"calibration {CHECK_MODEL} card vs CPU (card {t_gpu:.2f} s, CPU "
          f"{t_cpu:.2f} s): {n['picks']} integer picks, {n['adjacent']} "
          f"adjacent (share {n['adjacent'] / max(1, n['picks']):.4f}, allowed "
          f"{ADJACENT_SHARE}); {n['scales']} scales of agreeing sites, "
          f"{n['moved']} past rtol {CALIB_SCALE_RTOL} (allowed share "
          f"{MOVED_SHARE}), worst rel {n['worst_rel']:.3e}")
    check(n["adjacent"] <= ADJACENT_SHARE * n["picks"],
          f"card vs CPU: {n['adjacent']} adjacent picks")
    check(n["moved"] <= MOVED_SHARE * n["scales"],
          f"card vs CPU: {n['moved']} scales past tolerance")
    return served, start


# Bits phase: the shipped configs/3bit.py and configs/6bit.py (calib_size
# 32, eq_n 128, steps 6, search_round 3; qconv_a_bit 8, qhead_a_bit the
# width) on CALIB_MODEL at full width, cut to BITS_DEPTH blocks so that the
# whole script stays near 900 s (PERF.md section 4), with configs/4bit.py
# calibrated at the same depth as the widths' baseline; CHECK_MODEL on the
# card and on the CPU, held with compare_qstates
BITS_CONFIGS = {3: "3bit.py", 6: "6bit.py"}
BITS_BASELINE = "4bit.py"
BITS_DEPTH = 4


def cut_spec(name, depth):
    """The spec of ViT ``name`` with its first ``depth`` blocks, entered in
    the zoo as '<name>_d<depth>' (so load_quantized builds it) with its
    launch counts beside MODELS' and INT8_MODELS'; ``name``'s own spec at
    its full depth."""
    import dataclasses

    from adalog_tpu_torch.models import zoo

    spec = zoo.model_spec(name)
    if depth == spec.cfg.depth:
        return spec
    cut = dataclasses.replace(spec, name=f"{name}_d{depth}",
                              cfg=dataclasses.replace(spec.cfg, depth=depth))
    zoo.MODEL_ZOO[cut.name] = cut
    MODELS[cut.name] = {"K1": depth, "K4": 4 * depth + 1}
    INT8_MODELS[cut.name] = 3 * depth + 1
    return cut


def check_bits(qstate, bits):
    """Every site carries the configuration's widths: w and a bits, s bits
    on the attention matmuls' A operand, qhead_a_bit on the head, 8 on the
    patch embedding's input."""
    from adalog_tpu_torch.models.layers import MatMulSite

    for name, site in qstate.items():
        if isinstance(site, MatMulSite):
            got, want = (site.Aq.bits, site.Bq.bits), (bits, bits)
        else:
            got = (site.wq.bits, site.aq.bits)
            want = (bits, 8 if name.startswith("patch_embed") else bits)
        check(got == want, f"{name}: bits {got}, want {want}")


def bits_phase(torch, fq_attn, fq_gemm, device, ckpt_dir, start):
    """CALIB_MODEL (the calibration phase's raw model and images) calibrated
    on the card at each of BITS_CONFIGS, timed; the state checked (every
    layout site, the widths, every AdaLog base an integer fq_gemm.prepare
    takes), its held-out logit MSE to the raw model printed beside that of
    BITS_BASELINE calibrated at the same depth, then saved and served
    through load_quantized: block checks, fp32 and bf16 in every setting
    (serve_checked: K1 12 and K4 49 a batch, every launch variant "mma",
    the reason printed for any "fma"), the int8 block check (K5 against
    the fake-quant path at the width's codes) and eval_int8 (serve_int8:
    K5 37 a batch, all "wgmma"); then CHECK_MODEL calibrated at the same
    configuration on the card and on the CPU, held with compare_qstates.
    Returns ({kernel: launches of the served paths}, {kernel: largest
    block-check max|diff|})."""
    from collections import Counter

    from adalog_tpu_torch.models.zoo import build_model, model_forward_fn
    from adalog_tpu_torch.models.zoo import model_spec
    from adalog_tpu_torch.utils.checkpoint import save_checkpoint
    from adalog_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    full = start["spec"]
    spec = cut_spec(full.name, BITS_DEPTH)
    model = start["model"]
    if spec is not full:
        from adalog_tpu_torch.models.load import load_state_dict

        model = load_state_dict(spec, {
            k: v for k, v in timm_weights(full.cfg, SEED).items()
            if not k.startswith("blocks.") or
            int(k.split(".")[1]) < BITS_DEPTH}).to(device)
    cfg = spec.cfg
    images = calibration_images(cfg, CALIB_SIZE, SEED + 7)
    x = torch.from_numpy(start["held_out"]).to(device)
    batches = [calibration_images(cfg, BATCH, SEED + 9 + i)
               for i in range(N_BATCHES)]
    fwd = model_forward_fn(spec)
    with torch.no_grad():
        y_raw = fwd(cfg, model, x)

    def logit_mse(params, qstate):
        with torch.no_grad():
            return torch.mean((fwd(cfg, params, x, qstate, {"*": "quant"})
                               - y_raw) ** 2).item()

    line = card_line()
    launches = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}
    worst = {"K1": 0.0, "K4": 0.0, "K5": 0.0}
    base_cfg = load_config(os.path.join(root, "configs", BITS_BASELINE))
    params, qstate, _, wall, _ = calibrate_on(torch, spec, model, images,
                                              device, base_cfg)
    mse_base = logit_mse(params, qstate)
    print(f"calibration {spec.name} W{base_cfg.a_bit}A{base_cfg.a_bit} "
          f"(configs/{BITS_BASELINE}, the widths' baseline): wall "
          f"{wall:.2f} s; logit MSE to the raw model on {CALIB_SIZE} "
          f"held-out images {mse_base:.6e}; {line}")
    check(np.isfinite(mse_base), f"{spec.name} baseline: MSE {mse_base}")
    del params, qstate
    spec_t = model_spec(CHECK_MODEL)
    _, tiny = build_model(CHECK_MODEL, seed=SEED)
    imgs_t = calibration_images(spec_t.cfg, CALIB_SIZE, SEED + 13)
    for bits, path in BITS_CONFIGS.items():
        qcfg = load_config(os.path.join(root, "configs", path))
        check((qcfg.w_bit, qcfg.a_bit, qcfg.s_bit, qcfg.qhead_a_bit) ==
              (bits,) * 4, f"configs/{path}: widths")
        tag = f"{spec.name} W{bits}A{bits}"
        torch.cuda.reset_peak_memory_stats(device)
        params, qstate, calib, wall, _ = calibrate_on(
            torch, spec, model, images, device, qcfg)
        peak = torch.cuda.max_memory_allocated(device)
        print(f"calibration {tag} (configs/{path}: calib_size "
              f"{qcfg.calib_size}, eq_n {qcfg.eq_n}, steps {qcfg.steps}, "
              f"search_round {qcfg.search_round}): wall {wall:.2f} s "
              f"(capture {calib.seconds['capture']:.2f} s; searches "
              + ", ".join(f"{k} {v:.2f} s" for k, v in calib.seconds.items()
                          if k != "capture")
              + f"); peak device memory {peak / 2**30:.2f} GiB; {line}")
        bases = check_calibrated(torch, fq_gemm, calib, qstate)
        check_bits(qstate, bits)
        mse = logit_mse(params, qstate)
        check(np.isfinite(mse), f"{tag}: logit MSE {mse}")
        print(f"calibration {tag}: {len(qstate)} sites calibrated; AdaLog "
              f"bases {sorted(Counter(bases).items())}; logit MSE to the raw "
              f"model on {CALIB_SIZE} held-out images {mse:.6e} (configs/"
              f"{BITS_BASELINE} at the same depth {mse_base:.6e})")
        print(json.dumps({"calibration": {
            "model": spec.name, "config": f"configs/{path}", "card": line,
            "wall_s": wall, "seconds": calib.seconds, "peak_bytes": peak,
            "sites": len(qstate), "mse_calibrated": mse,
            "mse_baseline": mse_base}}))

        os.makedirs(ckpt_dir, exist_ok=True)
        ckpt = os.path.join(ckpt_dir, f"{spec.name}_calibrated_w{bits}a"
                            f"{bits}.ckpt")
        meta = {"model": spec.name, "state": "FPCS calibration, random "
                f"weights, configs/{path}"}
        save_checkpoint(ckpt, params, qstate, meta)
        got, errs = serve_checked(torch, fq_attn, fq_gemm, device, spec,
                                  params, qstate, ckpt, batches,
                                  tag=f"{tag} calibrated", bits=bits)
        n, d, share = int8_block_check(torch, spec, params, qstate, x,
                                       cfg=qcfg)
        print(f"block check {tag} int8 float32: K5 bit for bit as its "
              f"plain version, and vs the fake-quant path, "
              f"on the inputs of all {n} int8 sites, batch {len(x)}: "
              f"max|diff|={d:.3e} share_past_tol={share:.3e} (atol={ATOL} "
              f"rtol={INT8_BLOCK_RTOL}; allowed share {FLIP_SHARE}, max "
              f"{INT8_BLOCK_MAX})")
        check(share <= FLIP_SHARE and d <= INT8_BLOCK_MAX,
              f"{tag} int8 block check: max|diff| {d}, share {share}")
        worst["K5"] = max(worst["K5"], d)
        save_checkpoint(ckpt, params, qstate, meta)
        got5 = serve_int8(torch, fq_attn, fq_gemm, device, spec, ckpt,
                          batches, f"{tag} calibrated int8", bits)
        for k in launches:
            launches[k] += got[k] + got5[k]
        for k, d in errs.items():
            worst[k] = max(worst[k], d)
        del params, qstate, calib
        torch.cuda.empty_cache()

        _, q_gpu, _, t_gpu, _ = calibrate_on(torch, spec_t, tiny, imgs_t,
                                             device, qcfg)
        _, q_cpu, _, t_cpu, _ = calibrate_on(torch, spec_t, tiny, imgs_t,
                                             torch.device("cpu"), qcfg)
        n = compare_qstates(torch, q_gpu, q_cpu)
        print(f"calibration {CHECK_MODEL} W{bits}A{bits} card vs CPU (card "
              f"{t_gpu:.2f} s, CPU {t_cpu:.2f} s): {n['picks']} integer "
              f"picks, {n['adjacent']} adjacent (share "
              f"{n['adjacent'] / max(1, n['picks']):.4f}, allowed "
              f"{ADJACENT_SHARE}); {n['scales']} scales of agreeing sites, "
              f"{n['moved']} past rtol {CALIB_SCALE_RTOL} (allowed share "
              f"{MOVED_SHARE}), worst rel {n['worst_rel']:.3e}")
        check(n["adjacent"] <= ADJACENT_SHARE * n["picks"],
              f"W{bits}A{bits} card vs CPU: {n['adjacent']} adjacent picks")
        check(n["moved"] <= MOVED_SHARE * n["scales"],
              f"W{bits}A{bits} card vs CPU: {n['moved']} scales past "
              "tolerance")
    return launches, worst


# int8 phase: K5 at its shapes, then the calibrated deit_small and the smoke
# swin_tiny served with eval_int8, each int8 site held to the fake-quant
# path, one per-site error report and one export round trip. The int8 sites'
# block check in fp32: the integer sum is exact where the fake-quant GEMM
# rounds its fp32 products and sums, so the two differ by that rounding
# (ATOL + INT8_BLOCK_RTOL * |ref|, at most FLIP_SHARE of the outputs past
# it and none by more than INT8_BLOCK_MAX); the exported program against
# the plain predictor on the card within EXPORT_ATOL (the same ops; a last
# bit apart anywhere would move W4A4 codes and whole logits)
INT8_BLOCK_RTOL = 2e-5
INT8_BLOCK_MAX = 1e-3
EXPORT_ATOL = 1e-5
DIAG_TOP = 5


def int8_block_check(torch, spec, model, qstate, x, n_sites=None, skip=(),
                     cfg=None):
    """Each int8 site of ``model`` (fp32) through K5, as the served path
    calls it (the table entry), against the fake-quant qlinear on the same
    inputs: every Linear site's input captured from the raw model on images
    x, each site's codes at its own width (``cfg``, quant_config() when
    None, gives the layout); K5 must also equal its plain version on those
    inputs bit for bit. On a tp rank's slices the caller enters the
    row-parallel context and names the row-parallel sites (``skip``) and
    the count of int8 sites left (``n_sites``). Returns (sites, largest
    max|diff|, largest share past tolerance)."""
    from adalog_tpu_torch.calib.layout import quant_layout, tree_get
    from adalog_tpu_torch.models.layers import qlinear
    from adalog_tpu_torch.models.zoo import model_forward_fn
    from adalog_tpu_torch.ops import int8_linear

    cfg = cfg or quant_config()
    layout = quant_layout(spec, cfg)
    table = int8_linear.prepare(spec, model, qstate, cfg, skip=skip)
    if n_sites is None:
        n_sites = INT8_MODELS[spec.name]
    check(len(table) == n_sites,
          f"{spec.name}: {len(table)} int8 sites, want {n_sites}")
    with torch.no_grad():
        _, taps = model_forward_fn(spec)(spec.cfg, model, x, capture=True)
    worst = share_max = 0.0
    with torch.no_grad():
        for nm, hit in table.items():
            xin = taps.pop(nm)[0]
            p = tree_get(model, layout[nm].param_path)
            xin2 = xin.reshape(-1, xin.shape[-1])
            args = (xin2, hit.w_int, hit.a_params, hit.scale_row, p.bias)
            bits = qstate[nm].aq.bits
            got = int8_linear.int8_gemm(*args, bits=bits)
            n_plain = int((got != int8_linear.int8_gemm_plain(
                *args, bits=bits)).sum())
            check(n_plain == 0, f"{spec.name} {nm}: K5 differs from its "
                  f"plain version in {n_plain} outputs at {bits} bits")
            want = qlinear(p, qstate[nm], xin2, mode="quant")
            d, share = compare(got, want, INT8_BLOCK_RTOL)
            worst, share_max = max(worst, d), max(share_max, share)
    return len(table), worst, share_max


def serve_int8(torch, fq_attn, fq_gemm, device, spec, ckpt, batches, tag,
               bits=4):
    """The state in ``ckpt`` served through load_quantized with eval_int8
    in INT8_SETTINGS, fp32 and bf16, launch counts asserted (K1 and K5 every
    batch, K4 on the AdaLog fc2 sites with the GEMM switch); logits checked,
    img/s printed. Deletes ``ckpt``. Returns the launches of the last
    setting, the main path."""
    name = spec.name
    preds = predictors(ckpt, device, batches[0], name, INT8_SETTINGS,
                       bits=bits, eval_int8=True)
    os.remove(ckpt)
    torch.cuda.synchronize()
    n_attn, n_int8 = MODELS[name]["K1"], INT8_MODELS[name]
    n_fc2 = MODELS[name]["K4"] - n_int8
    launches = None
    for setting, _, gemm in INT8_SETTINGS:
        zero_launches(fq_attn, fq_gemm)
        served = {dt: serve(torch, preds[dt, setting], batches)
                  for dt in ("float32", "bfloat16")}
        got = read_launches(fq_attn, fq_gemm)
        runs = N_BATCHES * 2
        want = {"K1": n_attn * runs, "K2": 0, "K3": 0,
                "K4": n_fc2 * runs if gemm else 0, "K5": n_int8 * runs}
        print(f"serving path {tag} '{setting}': launches {got} for 2 x "
              f"{N_BATCHES} batches of {BATCH} (want K1 {n_attn}, K4 "
              f"{n_fc2 if gemm else 0}, K5 {n_int8} per batch: {want})")
        check(got == want, f"{tag} '{setting}' launches {got} != {want}")
        print(f"serving path {tag} '{setting}': K5 by variant "
              f"{k5_variants()}")
        check_k5_variants(want["K5"], f"{tag} '{setting}'")
        for dt, (y, ips) in served.items():
            check_logits(torch, y, spec, BATCH * N_BATCHES,
                         f"{tag} {dt} {setting}")
            print(f"serving {tag} {dt}, {setting}: {ips:.1f} img/s; "
                  f"{card_line()}")
        launches = got
    return launches


def int8_phase(torch, fq_attn, fq_gemm, device, ckpt_dir, start):
    """K5 against its plain version at INT8_SHAPES; the calibrated
    deit_small (the calibration phase's folded state) and the smoke
    swin_tiny: int8 block checks, then served with eval_int8 (serve_int8);
    then site_error_report on the calibrated deit_small and its export
    round trip on the card. Returns (the K5 kernel numbers, {kernel:
    launches of the served paths}, {kernel: worst max|diff|})."""
    from adalog_tpu_torch.serve import make_predictor
    from adalog_tpu_torch.utils.checkpoint import save_checkpoint
    from adalog_tpu_torch.utils.diagnostics import site_error_report
    from adalog_tpu_torch.utils.export import export_quantized, load_exported

    line = card_line()
    numbers, worst = int8_kernel_phase(torch, device)
    spec, (params, qstate) = start["spec"], start.pop("served")
    cfg = spec.cfg
    x = torch.from_numpy(start["held_out"]).to(device)
    launches = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}
    block_worst = 0.0
    for name in ("deit_small", "swin_tiny"):
        if name == CALIB_MODEL:
            spec_m, model, qs = spec, params, qstate
            batches = [calibration_images(cfg, BATCH, SEED + 9 + i)
                       for i in range(N_BATCHES)]
            ckpt = os.path.join(ckpt_dir, f"{name}_calibrated_int8.ckpt")
            save_checkpoint(ckpt, model, qs, {"model": name})
            xb = x
        else:
            spec_m, model, qs, ckpt, batches = smoke_model(torch, device,
                                                           ckpt_dir, name)
            xb = torch.from_numpy(batches[0]).to(device)
        n, d, share = int8_block_check(torch, spec_m, model, qs, xb)
        print(f"block check {name} int8 float32: K5 bit for bit as its "
              f"plain version, and vs the fake-quant path, "
              f"on the inputs of all {n} int8 sites, batch {BATCH}: "
              f"max|diff|={d:.3e} share_past_tol={share:.3e} (atol={ATOL} "
              f"rtol={INT8_BLOCK_RTOL}; allowed share {FLIP_SHARE}, max "
              f"{INT8_BLOCK_MAX})")
        check(share <= FLIP_SHARE and d <= INT8_BLOCK_MAX,
              f"{name} int8 block check: max|diff| {d}, share {share}")
        block_worst = max(block_worst, d)
        got = serve_int8(torch, fq_attn, fq_gemm, device, spec_m, ckpt,
                         batches, f"{name} int8")
        for k, v in got.items():
            launches[k] += v
        if name != CALIB_MODEL:
            del model, qs
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rows = site_error_report(spec, params, qstate, start["calib"].layout,
                             [start["held_out"]])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(len(rows) == len(qstate) and all(
        np.isfinite(r["quant"]) for r in rows), "site_error_report rows")
    print(f"diagnostics {CALIB_MODEL} calibrated: site_error_report on "
          f"{len(start['held_out'])} images, {len(rows)} sites in "
          f"{secs:.2f} s; top {DIAG_TOP} by full-quantization error:")
    for r in sorted(rows, key=lambda r: -r["quant"])[:DIAG_TOP]:
        print("diagnostics   %-28s %-14s w_only %s a_only %s quant %.4f" % (
            r["site"], r["kind"],
            *("-" if r[k] is None else f"{r[k]:.4f}"
              for k in ("w_only", "a_only")), r["quant"]))

    t0 = time.perf_counter()
    blob = export_quantized(spec, params, qstate, BATCH, device=device)
    t_export = time.perf_counter() - t0
    y = load_exported(blob)(start["held_out"])
    want = make_predictor(spec, params, qstate, cfg=quant_config(),
                          use_kernels=False, device=device)(x)
    torch.cuda.synchronize()
    diff = (y - want).abs().max().item()
    print(f"export {CALIB_MODEL} calibrated, batch {BATCH}: {len(blob)} "
          f"bytes in {t_export:.2f} s; loaded on the card, logits vs the "
          f"plain predictor max|diff| {diff:.3e} (allowed {EXPORT_ATOL}); "
          f"{line}")
    check(tuple(y.shape) == (BATCH, cfg.num_classes)
          and y.device == want.device,
          f"exported logits {tuple(y.shape)} on {y.device}")
    check(diff <= EXPORT_ATOL, f"exported logits apart by {diff}")
    del params, qstate, blob
    torch.cuda.empty_cache()
    return numbers, launches, {"K5": max(worst, block_worst)}


# Mesh phase: ranks spawned with torch.multiprocessing (start method spawn)
# after the parent has built the kernels, all on cuda:0 through gloo: the
# machine shows one card and NCCL refuses two ranks on one device. Every case
# at full width with the attention and GEMM kernels on: (model, dp, tp,
# dtype, eval_int8)
MESH_CASES = (("deit_small", 1, 2, "float32", False),
              ("deit_small", 1, 2, "bfloat16", False),
              ("deit_small", 1, 2, "float32", True),
              ("deit_small", 2, 1, "float32", False),
              ("swin_tiny", 1, 2, "float32", False))
# and test_tiny at dp=2 x tp=2, four ranks, its logits held to the
# single-device predictor's at the JAX package's own tolerance
# (tests/test_sharding.py: rtol = atol = 2e-4)
MESH_TINY = ("test_tiny", 2, 2, "float32", False)
MESH_TINY_TOL = 2e-4
MESH_RUNS = ((2, MESH_CASES), (4, (MESH_TINY,)))     # (ranks, cases)
# launches a batch on each rank, by (model, dp, tp, eval_int8): K1 on every
# block's local heads; K4 at the column-parallel and replicated sites, never
# at the row-parallel proj / fc2 (deit_small tp=2: qkv and fc1 of 12 blocks
# and the head; swin_tiny tp=2: stage 0's 3 heads keep its two attentions
# whole, so qkv, proj and fc1 there, qkv and fc1 in the 10 blocks of stages
# 1-3, its 3 reductions and the head; test_tiny: qkv and fc1 of 2 blocks
# and the head); with eval_int8 K5 at those sites instead (all uniform)
MESH_LAUNCHES = {("deit_small", 1, 2, False): {"K1": 12, "K4": 25, "K5": 0},
                 ("deit_small", 1, 2, True): {"K1": 12, "K4": 0, "K5": 25},
                 ("deit_small", 2, 1, False): {"K1": 12, "K4": 49, "K5": 0},
                 ("swin_tiny", 1, 2, False): {"K1": 12, "K4": 30, "K5": 0},
                 ("test_tiny", 1, 2, False): {"K1": 2, "K4": 5, "K5": 0},
                 ("test_tiny", 2, 2, False): {"K1": 2, "K4": 5, "K5": 0}}
MESH_TIMEOUT = 600


def mesh_key(model, dp, tp, dtype, int8):
    return f"{model} dp={dp} tp={tp} {dtype}" + (" int8" if int8 else "")


def mesh_block_check(torch, fq_attn, fq_gemm, case, spec, model, qstate,
                     batch, want):
    """K1 and K4 (K5 with eval_int8) against their plain versions on this
    rank's own inputs: its dp slice of ``batch`` and, under tp, its slices
    of the model and state, the forward in the row-parallel context.
    Returns {kernel: (largest max|diff|, largest share past tolerance)}."""
    from contextlib import nullcontext

    from adalog_tpu_torch.models.layers import tp_row_context
    from adalog_tpu_torch.parallel.mesh import make_mesh_2d, shard_batch
    from adalog_tpu_torch.parallel.tp import make_tp_plan
    from adalog_tpu_torch.quantizers.state import map_tensors

    device = torch.device(case["device"])
    mesh = make_mesh_2d(case["dp"], case["tp"], device=device,
                        backend="gloo")
    dtype = getattr(torch, case["dtype"])
    x = shard_batch(torch.from_numpy(batch), mesh).to(device=device,
                                                      dtype=dtype)
    skip, ctx = frozenset(), nullcontext()
    if mesh.tp > 1:
        plan = make_tp_plan(spec, qstate, mesh.tp)
        model = plan.shard_module(model, mesh.tp_index)
        qstate = plan.shard_qstate(qstate, mesh.tp_index)
        skip = plan.row_sites
        ctx = tp_row_context(mesh.tp_group, skip)
    model = model.to(device=device, dtype=dtype)      # the rank's own copy
    qstate = map_tensors(lambda t: t.to(device), qstate)
    with ctx:
        if case["int8"]:
            _, d, share = int8_block_check(torch, spec, model, qstate, x,
                                           n_sites=want["K5"], skip=skip)
            return {"K5": (d, share)}
        return block_check(torch, fq_attn, fq_gemm, spec, model, qstate, x,
                           case["dtype"], n_linear=want["K4"], skip=skip)


def mesh_rank(work, cases):
    """One rank of the mesh phase (run by parallel.mesh.spawn): each case
    served through load_quantized over its mesh on the case's device (every
    rank on the parent's card) with gloo, a
    warm-up batch, then N_BATCHES batches with the launch counts set to 0
    just before and read just after; then the block checks on the rank's
    own inputs. Rank 0 saves each case's logits. Writes this rank's
    launches, variants, seconds and block-check results as JSON."""
    import torch
    import torch.distributed as dist

    from adalog_tpu_torch.ops import fq_attn, fq_gemm
    from adalog_tpu_torch.serve import load_quantized, pin_fp32_matmul

    pin_fp32_matmul()
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for case in cases:
        key = case["key"]
        predict, spec, model, qstate = load_quantized(
            case["model"], case["ckpt"], device=case["device"],
            backend="gloo",
            eval_dtype=case["dtype"], mesh_devices=case["dp"] * case["tp"],
            mesh_tp=case["tp"], config=quant_config(
                use_pallas_gemm=True, eval_int8=case["int8"]))
        batches = np.load(case["batches"])
        predict(batches[0])                           # warm-up
        torch.cuda.synchronize()
        zero_launches(fq_attn, fq_gemm)
        t0 = time.perf_counter()
        ys = [predict(x) for x in batches]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = read_launches(fq_attn, fq_gemm)
        variants = {"K1": dict(fq_attn.fq_flash_attn.variant_launches),
                    "K4": dict(fq_gemm.fq_gemm.variant_launches),
                    "K5": k5_variants()}
        if rank == 0:
            np.save(os.path.join(work, f"{key}.npy"),
                    torch.cat(ys).float().cpu().numpy())
        want = MESH_LAUNCHES[case["model"], case["dp"], case["tp"],
                             case["int8"]]
        block = mesh_block_check(torch, fq_attn, fq_gemm, case, spec, model,
                                 qstate, batches[0], want)
        out[key] = dict(launches=got, variants=variants, seconds=secs,
                        block=block)
        del predict, model, qstate
        torch.cuda.empty_cache()
    with open(os.path.join(work, f"world{world}_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mesh_phase(torch, fq_attn, fq_gemm, device, ckpt_dir, runs=MESH_RUNS):
    """Serving over a mesh of ranks on the one card (gloo): each of ``runs``
    (default MESH_CASES in 2 ranks, MESH_TINY in 4) spawns its ranks
    (mesh_rank). Per rank and case: the launches a
    batch asserted (MESH_LAUNCHES; K2 and K3 none), every K1 and K4 launch
    "mma", the block checks on the rank's own inputs held as phase 6 holds
    them; rank 0's logits against the single-device predictor's on the same
    card (reported; test_tiny's within MESH_TINY_TOL); img/s of rank 0.
    Returns ({kernel: launches summed over every rank and case},
    {kernel: largest block-check max|diff|})."""
    import shutil

    from adalog_tpu_torch.parallel.mesh import spawn
    from adalog_tpu_torch.serve import load_quantized

    line = card_line()
    work = os.path.join(ckpt_dir, "mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    print("mesh: every rank on cuda:0 with backend gloo: this machine shows "
          "one card and NCCL refuses two ranks on one device; the nccl path "
          "(a card a rank) is not run here")
    inputs = {}
    for name in dict.fromkeys(c[0] for _, cs in runs for c in cs):
        *_, ckpt, batches = smoke_model(torch, device, work, name)
        path = os.path.join(work, f"{name}_batches.npy")
        np.save(path, np.stack(batches))
        inputs[name] = (ckpt, path)
    torch.cuda.empty_cache()

    def cases(specs):
        return [dict(key=mesh_key(*c), model=c[0], dp=c[1], tp=c[2],
                     dtype=c[3], int8=c[4], ckpt=inputs[c[0]][0],
                     batches=inputs[c[0]][1], device=str(device))
                for c in specs]

    runs = [(world, cases(cs)) for world, cs in runs]
    for world, cs in runs:
        t0 = time.perf_counter()
        spawn(mesh_rank, world, (work, cs), backend="gloo",
              init_file=os.path.join(work, f"rendezvous{world}"),
              timeout=MESH_TIMEOUT)
        print(f"mesh: {world} ranks ran {len(cs)} case(s) in "
              f"{time.perf_counter() - t0:.1f} s (spawn, CUDA start, serving "
              "and block checks)")

    launches = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}
    worst = {"K1": 0.0, "K4": 0.0, "K5": 0.0}
    for world, cs in runs:
        ranks = []
        for rank in range(world):
            with open(os.path.join(work, f"world{world}_rank{rank}.json")) \
                    as f:
                ranks.append(json.load(f))
        for case in cs:
            key = case["key"]
            per_batch = MESH_LAUNCHES[case["model"], case["dp"], case["tp"],
                                      case["int8"]]
            want = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
            want.update({k: n * N_BATCHES for k, n in per_batch.items()})
            for rank, res in enumerate(ranks):
                r = res[key]
                print(f"mesh {key} rank {rank}: launches {r['launches']} for "
                      f"{N_BATCHES} batches of {BATCH} (want {want}); by "
                      f"variant K1 {r['variants']['K1']}, K4 "
                      f"{r['variants']['K4']}, K5 {r['variants']['K5']}")
                check(r["launches"] == want,
                      f"mesh {key} rank {rank}: launches {r['launches']} != "
                      f"{want}")
                check(r["variants"]["K5"] == {"wgmma": want["K5"], "mma": 0},
                      f"mesh {key} rank {rank}: K5 by variant "
                      f"{r['variants']['K5']}, want all 'wgmma'")
                for k in ("K1", "K4"):
                    check(r["variants"][k]["fma"] == 0,
                          f"mesh {key} rank {rank}: {k} took variant 'fma'")
                for k, (d, share) in r["block"].items():
                    print(f"block check mesh {key} rank {rank}: {k} vs plain "
                          f"on the rank's own inputs: max|diff|={d:.3e} "
                          f"share_past_tol={share:.3e} (allowed share "
                          f"{FLIP_SHARE})")
                    check(share <= FLIP_SHARE,
                          f"mesh {key} rank {rank} {k} block check share "
                          f"{share}")
                    check(k != "K4" or d <= FLIP_MAX,
                          f"mesh {key} rank {rank} K4 max|diff| {d}")
                    check(k != "K5" or d <= INT8_BLOCK_MAX,
                          f"mesh {key} rank {rank} K5 max|diff| {d}")
                    worst[k] = max(worst[k], d)
                for k, n in r["launches"].items():
                    launches[k] += n
            y = torch.from_numpy(np.load(os.path.join(work, f"{key}.npy")))
            predict, spec, *_ = load_quantized(
                case["model"], case["ckpt"], device=device,
                eval_dtype=case["dtype"], config=quant_config(
                    use_pallas_gemm=True, eval_int8=case["int8"]))
            batches = np.load(case["batches"])
            single = torch.cat([predict(x) for x in batches]).float().cpu()
            check_logits(torch, y, spec, BATCH * N_BATCHES, f"mesh {key}")
            diff = (y - single).abs().max().item()
            agree = (y.argmax(-1) == single.argmax(-1)).float().mean().item()
            ips = BATCH * N_BATCHES / ranks[0][key]["seconds"]
            print(f"mesh {key}: logits gathered on rank 0 vs the single-device "
                  f"predictor on the same card: max|diff| {diff:.4e}, top-1 "
                  f"agreement {agree:.4f} (max|logit| "
                  f"{single.abs().max().item():.4e}); {ips:.1f} img/s on rank "
                  f"0 ({world} ranks sharing one card through gloo, not a "
                  f"scaling number); {line}")
            if case["model"] == MESH_TINY[0]:
                check(torch.allclose(y, single, rtol=MESH_TINY_TOL,
                                     atol=MESH_TINY_TOL),
                      f"mesh {key}: logits apart by {diff} (allowed "
                      f"{MESH_TINY_TOL})")
            del predict
            torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return launches, worst


# Reconstruction phase: BRECQ on the calibration phase's warm deit_small
# state, every unit at full depth and width, exact fp32, train_act, with
# RECON_ITERS steps (the shipped 20000 extrapolated from the measured ms a
# step) on RECON_OPTIM_SIZE images of standard-normal pixels
RECON_ITERS, RECON_OPTIM_SIZE = 200, 256
SHIPPED_ITERS, SHIPPED_OPTIM_SIZE = 20000, 1024
# card vs CPU on CHECK_MODEL from one CPU calibration, RECON_CHECK_ITERS
# steps on RECON_CHECK_N images (fewer than a batch, so every step sees the
# whole set on both devices): hard decisions flipped in at most
# RECON_FLIP_SHARE of the weights; activation scales within
# RECON_SCALE_SHARE of the most RECON_CHECK_ITERS Adam steps can move them
# (about A_LR each); recs within RECON_REC_RTOL, the head's KL (a
# difference of two sums of about log(classes) each) within RECON_KL_ATOL
RECON_CHECK_ITERS, RECON_CHECK_N = 20, 8
RECON_FLIP_SHARE = 1e-3
RECON_SCALE_SHARE = 0.1
RECON_REC_RTOL = 1e-3
RECON_KL_ATOL = 1e-5


def recon_config(**kw):
    return quant_config(optim_batch_size=BATCH, train_act=True, **kw)


def frozen_off_grid(torch, model, qstate, layout):
    """Sites whose weight / scale lies more than 1e-3 from an integer: a
    frozen AdaRound weight must lie on its quantizer's grid."""
    from adalog_tpu_torch.calib.layout import tree_get
    from adalog_tpu_torch.recon.brecq import _viewed_weight

    bad = []
    for name, site in qstate.items():
        if getattr(site, "wq", None) is None:
            continue
        w = _viewed_weight(tree_get(model, layout[name].param_path), site)
        ratio = (w / site.wq.scale).double()
        if (ratio - ratio.round()).abs().max().item() > 1e-3:
            bad.append(name)
    return bad


def probability_scales(qstate):
    """{site: A scale} of every post-softmax AdaLog quantizer."""
    return {name: site.Aq.scale for name, site in qstate.items()
            if getattr(site, "Aq", None) is not None
            and site.Aq.kind == "adalog" and not site.Aq.shifted}


def reconstruct_on(torch, spec, params, model, qstate, layout, batches,
                   device, iters):
    """BlockReconstructor.reconstruct at recon_config on ``device``:
    (model, qstate, reconstructor, wall seconds, synchronized)."""
    from adalog_tpu_torch.recon.brecq import BlockReconstructor

    t0 = time.perf_counter()
    cfg = recon_config(recon_iters=iters,
                       optim_size=sum(len(b) for b in batches))
    recon = BlockReconstructor(spec, params, model, qstate, layout, cfg,
                               device=device)
    p, q = recon.reconstruct(batches, quant_act=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return p, q, recon, time.perf_counter() - t0


def compare_recons(torch, got, want, layout):
    """One reconstruction (model, qstate, reconstructor) against another:
    (hard decisions flipped, weights, worst activation-scale gap over
    RECON_CHECK_ITERS * A_LR, worst rec gap relative, but the head's, worst
    head KL gap)."""
    from adalog_tpu_torch.calib.layout import tree_get
    from adalog_tpu_torch.recon.brecq import A_LR, _viewed_weight

    (pg, qg, rg), (pc, qc, rc) = got, want
    flips = total = 0
    move = 0.0
    for name, site in qc.items():
        for k in ("aq", "Aq", "Bq"):
            b = getattr(site, k, None)
            if b is not None:
                a = getattr(qg[name], k).scale.cpu()
                move = max(move, (a - b.scale).abs().max().item()
                           / (RECON_CHECK_ITERS * A_LR))
        if getattr(site, "wq", None) is None:
            continue
        wc = _viewed_weight(tree_get(pc, layout[name].param_path), site)
        wg = _viewed_weight(tree_get(pg, layout[name].param_path), site)
        d = (wg.cpu() - wc).abs() > 1e-3 * site.wq.scale
        flips += int(d.sum())
        total += d.numel()
    rec_rel = kl = 0.0
    for name, st in rc.unit_stats.items():
        sg = rg.unit_stats[name]
        for k in ("rec_first", "rec_last"):
            if name == "head":
                kl = max(kl, abs(sg[k] - st[k]))
            else:
                rec_rel = max(rec_rel, abs(sg[k] - st[k]) / abs(st[k]))
    return flips, total, move, rec_rel, kl


def reconstruction_phase(torch, fq_attn, fq_gemm, device, ckpt_dir, start):
    """Reconstruct every unit of the calibration phase's warm deit_small
    state on the card through BlockReconstructor.reconstruct, the kernel
    launch counts set to 0 before and asserted 0 after (training launches
    no kernel); print per unit rec first / last, seconds, ms a step and
    peak device memory, the total, and the shipped run extrapolated; check
    the losses finite, the geometric mean of rec last / first below 1, the
    frozen weights on their grid and every post-softmax AdaLog scale
    exactly 1; fold the post-GeLU shift (finish_calibration), print the
    held-out logit MSE to the raw model of the reconstructed and of the
    calibrated state, save, load and serve (serve_checked: K1 12 and K4 49
    launches a batch, every launch "mma"); then reconstruct CHECK_MODEL on
    the card and on the CPU and compare. Returns serve_checked's pair."""
    from adalog_tpu_torch.calib.calibrator import QuantCalibrator
    from adalog_tpu_torch.calib.layout import quant_layout
    from adalog_tpu_torch.models.zoo import (
        build_model, model_forward_fn, model_spec,
    )
    from adalog_tpu_torch.recon.blocks import block_units
    from adalog_tpu_torch.utils.checkpoint import save_checkpoint

    spec, calib = start["spec"], start["calib"]
    cfg = spec.cfg
    line = card_line()
    images = calibration_images(cfg, RECON_OPTIM_SIZE, SEED + 21)
    batches = [images[i:i + BATCH] for i in range(0, RECON_OPTIM_SIZE, BATCH)]
    print(f"reconstruction {CALIB_MODEL} W4A4: recon_iters={RECON_ITERS}, "
          f"optim_size={RECON_OPTIM_SIZE}, optim_batch_size={BATCH}, "
          f"train_act=True, exact fp32, from the warm calibration's state "
          f"before the post-GeLU fold; {line}")
    zero_launches(fq_attn, fq_gemm)
    t0 = time.perf_counter()
    params, qstate, recon, wall = reconstruct_on(
        torch, spec, start["params"], start["model"], start["qstate"],
        calib.layout, batches, device, RECON_ITERS)
    got = read_launches(fq_attn, fq_gemm)
    print(f"reconstruction {CALIB_MODEL}: kernel launches during training "
          f"{got} (want every one 0)")
    check(not any(got.values()), f"kernels launched in training: {got}")

    stats = recon.unit_stats
    units = [u.name for u in block_units(spec)]
    check(set(stats) == set(units),
          f"reconstructed units {sorted(stats)} != {units}")
    ratios, step_ms = [], {}
    for name in units:
        st = stats[name]
        step_ms[name] = 1e3 * st["seconds"] / st["iters"]
        print(f"reconstruction unit {name}: rec {st['rec_first']:.6e} -> "
              f"{st['rec_last']:.6e}, {st['seconds']:.2f} s, "
              f"{step_ms[name]:.3f} ms a step, peak device memory "
              f"{st['peak_bytes'] / 2**30:.2f} GiB")
        check(np.isfinite(st["rec_first"]) and np.isfinite(st["rec_last"]),
              f"{name}: loss not finite")
        ratios.append(st["rec_last"] / st["rec_first"])
    gmean = float(np.exp(np.mean(np.log(ratios))))
    # the reconstructor resets the device's peak counter before each unit;
    # the first unit trained (blocks.0) holds every unit's I/O, more than
    # the capture before it
    peak_all = max(stats[n]["peak_bytes"] for n in units)
    trained_s = sum(stats[n]["seconds"] for n in units)
    shipped_s = SHIPPED_ITERS * sum(step_ms.values()) / 1e3 + (
        wall - trained_s) * SHIPPED_OPTIM_SIZE / RECON_OPTIM_SIZE
    print(f"reconstruction {CALIB_MODEL}: {len(units)} units in {wall:.2f} s "
          f"wall ({trained_s:.2f} s training, {wall - trained_s:.2f} s "
          f"capture, copies and freezing); peak device memory "
          f"{peak_all / 2**30:.2f} GiB (the largest unit's); geometric mean of rec last / first "
          f"{gmean:.4f} (must be below 1); {line}")
    print(f"reconstruction {CALIB_MODEL}: the shipped run ({SHIPPED_ITERS} "
          f"steps a unit, optim_size {SHIPPED_OPTIM_SIZE}) extrapolated from "
          f"the measured ms a step, the rest scaled by the images: "
          f"{shipped_s:.0f} s ({shipped_s / 60:.1f} min), not measured")
    check(gmean < 1.0, f"geometric mean of rec last / first {gmean}")
    bad = frozen_off_grid(torch, params, qstate, calib.layout)
    check(not bad, f"frozen weights off their grid at {bad}")
    probs = probability_scales(qstate)
    check(probs and all(bool((s == 1.0).all()) for s in probs.values()),
          "a post-softmax AdaLog scale moved from 1.0")
    print(f"reconstruction {CALIB_MODEL}: frozen weights on their grid at "
          f"every weight site; {len(probs)} post-softmax AdaLog scales, "
          "every one exactly 1.0")

    calib.params, calib.qstate = params, dict(qstate)
    params, qstate = calib.finish_calibration()
    fwd = model_forward_fn(spec)
    x = torch.from_numpy(start["held_out"]).to(device)
    with torch.no_grad():
        y_raw = fwd(cfg, start["model"], x)
        mse_rec = torch.mean((fwd(cfg, params, x, qstate, {"*": "quant"})
                              - y_raw) ** 2).item()
    print(f"reconstruction {CALIB_MODEL} quality on {CALIB_SIZE} held-out "
          f"images: logit MSE to the raw model {mse_rec:.6e} reconstructed, "
          f"{start['mse_calibrated']:.6e} calibrated (reported, no gate)")
    check(np.isfinite(mse_rec), f"reconstructed logit MSE {mse_rec}")
    print(json.dumps({"reconstruction": {
        "model": CALIB_MODEL, "card": line, "recon_iters": RECON_ITERS,
        "optim_size": RECON_OPTIM_SIZE, "wall_s": wall,
        "peak_bytes": peak_all,
        "units": {n: dict(stats[n], ms_per_step=step_ms[n]) for n in units},
        "gmean_rec_ratio": gmean, "shipped_extrapolated_s": shipped_s,
        "mse_reconstructed": mse_rec,
        "mse_calibrated": start["mse_calibrated"],
        "phase_s": time.perf_counter() - t0}}))

    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(ckpt_dir, f"{CALIB_MODEL}_reconstructed_w4a4.ckpt")
    save_checkpoint(ckpt, params, qstate, {
        "model": CALIB_MODEL,
        "state": "FPCS calibration + BRECQ, random weights"})
    serve_batches = [calibration_images(cfg, BATCH, SEED + 9 + i)
                     for i in range(N_BATCHES)]
    del recon, calib, start, y_raw, x
    torch.cuda.empty_cache()
    served = serve_checked(torch, fq_attn, fq_gemm, device, spec, params,
                           qstate, ckpt, serve_batches,
                           tag=f"{CALIB_MODEL} reconstructed")
    del params, qstate
    torch.cuda.empty_cache()

    spec_t = model_spec(CHECK_MODEL)
    _, tiny = build_model(CHECK_MODEL, seed=SEED)
    imgs = calibration_images(spec_t.cfg, RECON_CHECK_N, SEED + 23)
    cpu = torch.device("cpu")
    p0, q0 = QuantCalibrator(spec_t, tiny, quant_config(),
                             device=cpu).calibrate([imgs])
    layout = quant_layout(spec_t, quant_config())
    runs = [reconstruct_on(torch, spec_t, p0, tiny, q0, layout, [imgs], dev,
                           RECON_CHECK_ITERS) for dev in (device, cpu)]
    flips, total, move, rec_rel, kl = compare_recons(
        torch, runs[0][:3], runs[1][:3], layout)
    print(f"reconstruction {CHECK_MODEL} card vs CPU ({RECON_CHECK_ITERS} "
          f"steps on {RECON_CHECK_N} images, every step the whole set; card "
          f"{runs[0][3]:.2f} s, CPU {runs[1][3]:.2f} s): {flips} of {total} "
          f"hard decisions flipped (allowed share {RECON_FLIP_SHARE}); "
          f"activation scales apart by {move:.3e} of {RECON_CHECK_ITERS} * "
          f"A_LR (allowed {RECON_SCALE_SHARE}); recs worst rel "
          f"{rec_rel:.3e} (allowed {RECON_REC_RTOL}), head KL worst abs "
          f"{kl:.3e} (allowed {RECON_KL_ATOL})")
    check(flips <= RECON_FLIP_SHARE * total, f"card vs CPU: {flips} flips")
    check(move <= RECON_SCALE_SHARE, f"card vs CPU: scales apart {move}")
    check(rec_rel <= RECON_REC_RTOL and kl <= RECON_KL_ATOL,
          f"card vs CPU: recs apart {rec_rel}, {kl}")
    return served


# Mesh calibration phase: the calibration and reconstruction halves of the
# main path over dp=2 ranks on the one card (gloo: NCCL refuses two ranks on
# one device; the nccl path, a card a rank, is not run), CALIB_MODEL at full
# depth and width with the calibration phase's weights and images at the
# shipped configs/4bit.py numbers, held to the calibration phase's
# single-device state with compare_qstates' gates; BRECQ over the same ranks
# at the CLI phase's cut (CLI_RECON_ITERS steps a unit on CLI_OPTIM_SIZE
# images) from the single-device state before the fold, held to a
# single-device reconstruction with the same draws (compare_recons); then the
# mesh-calibrated state served on the dp=2 predictor (MESH_LAUNCHES' dp=2
# counts, every launch "mma", block checks on each rank's slice)
MESH_CALIB_TIMEOUT = 900


class _AllReduceLog:
    """Counts this process's torch.distributed.all_reduce calls: number,
    bytes and seconds inside them (a call returns with its result)."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.real = dist, dist.all_reduce
        self.n = self.bytes = 0
        self.seconds = 0.0

        def counted(t, *a, **k):
            t0 = time.perf_counter()
            out = self.real(t, *a, **k)
            self.seconds += time.perf_counter() - t0
            self.n += 1
            self.bytes += t.numel() * t.element_size()
            return out

        dist.all_reduce = counted

    def read(self):
        return dict(count=self.n, bytes=self.bytes, seconds=self.seconds)

    def close(self):
        self.dist.all_reduce = self.real


def mesh_calib_rank(work, case):
    """One rank of the mesh calibration phase (run by parallel.mesh.spawn):
    calibrate over dp=2 (QuantCalibrator(mesh=)), save the rank's folded
    state, reconstruct over dp=2 from the single-device state before the
    fold (BlockReconstructor(mesh=)), then serve the mesh-calibrated state
    saved by rank 0 through load_quantized over dp=2 with the counts set to
    0 just before and read just after, and hold the kernels to their plain
    versions on the rank's own slice. Writes the rank's seconds, peak
    device memory, all_reduces, launches and block checks as JSON."""
    import torch
    import torch.distributed as dist

    from adalog_tpu_torch.calib.calibrator import QuantCalibrator
    from adalog_tpu_torch.calib.layout import quant_layout
    from adalog_tpu_torch.models.zoo import build_model, model_spec
    from adalog_tpu_torch.ops import fq_attn, fq_gemm
    from adalog_tpu_torch.parallel.mesh import make_mesh
    from adalog_tpu_torch.quantizers.state import tensor_leaves
    from adalog_tpu_torch.recon.brecq import BlockReconstructor
    from adalog_tpu_torch.serve import load_quantized, pin_fp32_matmul
    from adalog_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    pin_fp32_matmul()
    device = torch.device(case["device"])
    mesh = make_mesh(2, device=device, backend="gloo")
    rank = mesh.rank
    spec = model_spec(case["model"])
    _, model = build_model(case["model"], seed=SEED)
    model.load_state_dict(torch.load(os.path.join(work, "model.pt")))
    model = model.to(device)
    images = np.load(os.path.join(work, "images.npy"))
    out = dict(rank=rank)

    cfg = quant_config()
    log = _AllReduceLog()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    calib = QuantCalibrator(spec, model, cfg, mesh=mesh, device=device)
    calib.calibrate([images])
    params, qstate = calib.finish_calibration()
    torch.cuda.synchronize(device)
    out["calibration"] = dict(
        wall_s=time.perf_counter() - t0, seconds=calib.seconds,
        peak_bytes=torch.cuda.max_memory_allocated(device),
        all_reduce=log.read())
    log.close()
    # the rank's folded state, leaf by leaf in a fixed order, for the
    # parent's bit-for-bit comparison of the two ranks
    leaves = tensor_leaves([qstate[nm] for nm in sorted(qstate)])
    torch.save([t.cpu() for t in leaves],
               os.path.join(work, f"qstate_r{rank}.pt"))
    if rank == 0:
        save_checkpoint(os.path.join(work, "mesh_calibrated.ckpt"), params,
                        qstate, {"model": case["model"],
                                 "state": "FPCS calibration over dp=2"})
    del calib, params, qstate
    torch.cuda.empty_cache()

    p0, q0, _ = load_checkpoint(os.path.join(work, "unfolded.ckpt"),
                                spec.cfg)
    rcfg = recon_config(recon_iters=CLI_RECON_ITERS,
                        optim_size=CLI_OPTIM_SIZE)
    batches = list(np.load(os.path.join(work, "recon_images.npy")))
    log = _AllReduceLog()
    t0 = time.perf_counter()
    recon = BlockReconstructor(spec, p0, model, q0, quant_layout(spec, rcfg),
                               rcfg, mesh=mesh, device=device)
    p1, q1 = recon.reconstruct(batches, quant_act=True)
    torch.cuda.synchronize(device)
    steps = sum(st["iters"] for st in recon.unit_stats.values())
    trained = sum(st["seconds"] for st in recon.unit_stats.values())
    # the reconstructor resets the peak counter before each unit
    out["reconstruction"] = dict(
        wall_s=time.perf_counter() - t0, ms_per_step=1e3 * trained / steps,
        peak_bytes=max(st["peak_bytes"] or 0
                       for st in recon.unit_stats.values()),
        units=recon.unit_stats, all_reduce=log.read())
    log.close()
    if rank == 0:
        save_checkpoint(os.path.join(work, "mesh_reconstructed.ckpt"), p1,
                        q1)
    del recon, p0, q0, p1, q1, model
    torch.cuda.empty_cache()

    dist.barrier()                # rank 0 has written the calibrated state
    ckpt = os.path.join(work, "mesh_calibrated.ckpt")
    predict, spec, model, qstate = load_quantized(
        case["model"], ckpt, device=device, backend="gloo", mesh_devices=2,
        mesh_tp=1, config=quant_config(use_pallas_gemm=True))
    serve_batches = np.load(os.path.join(work, "serve_batches.npy"))
    predict(serve_batches[0])                         # warm-up
    torch.cuda.synchronize(device)
    zero_launches(fq_attn, fq_gemm)
    t0 = time.perf_counter()
    ys = [predict(x) for x in serve_batches]
    torch.cuda.synchronize(device)
    out["serve"] = dict(
        seconds=time.perf_counter() - t0,
        launches=read_launches(fq_attn, fq_gemm),
        variants={"K1": dict(fq_attn.fq_flash_attn.variant_launches),
                  "K4": dict(fq_gemm.fq_gemm.variant_launches)})
    if rank == 0:
        np.save(os.path.join(work, "mesh_logits.npy"),
                torch.cat(ys).float().cpu().numpy())
    want = MESH_LAUNCHES[case["model"], 2, 1, False]
    bcase = dict(device=case["device"], dp=2, tp=1, dtype="float32",
                 int8=False)
    out["serve"]["block"] = mesh_block_check(
        torch, fq_attn, fq_gemm, bcase, spec, model, qstate,
        serve_batches[0], want)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mesh_calibration_phase(torch, fq_attn, fq_gemm, device, ckpt_dir, start):
    """Calibration and BRECQ over dp=2 ranks on the one card (mesh_calib_
    rank), held to the calibration phase's single-device state (``start``)
    and to a single-device reconstruction with the same draws; the ranks'
    states bit-equal; the served mesh state's launches on each rank
    (MESH_LAUNCHES' dp=2 counts, every launch "mma") and block checks.
    Prints per rank the capture and per-family seconds, wall-clock, peak
    device memory, the dp all_reduces with their bytes and seconds, and
    BRECQ's ms a step, beside the card's name and power limit. Returns
    ({kernel: launches summed over both ranks}, {kernel: largest block
    max|diff|})."""
    import shutil
    import types

    from adalog_tpu_torch.parallel.mesh import spawn
    from adalog_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    spec = start["spec"]
    cfg = spec.cfg
    line = card_line()
    work = os.path.join(ckpt_dir, "mesh_calibration")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.save(start["model"].state_dict(), os.path.join(work, "model.pt"))
    np.save(os.path.join(work, "images.npy"),
            calibration_images(cfg, CALIB_SIZE, SEED + 7))
    save_checkpoint(os.path.join(work, "unfolded.ckpt"), start["params"],
                    start["qstate"])
    recon_images = calibration_images(cfg, CLI_OPTIM_SIZE, SEED + 31)
    recon_batches = [recon_images[i:i + BATCH]
                     for i in range(0, CLI_OPTIM_SIZE, BATCH)]
    np.save(os.path.join(work, "recon_images.npy"), np.stack(recon_batches))
    serve_batches = [calibration_images(cfg, BATCH, SEED + 9 + i)
                     for i in range(N_BATCHES)]
    np.save(os.path.join(work, "serve_batches.npy"), np.stack(serve_batches))
    print(f"mesh calibration: {CALIB_MODEL} over dp=2 ranks on cuda:0 "
          f"through gloo (NCCL refuses two ranks on one card; the nccl "
          f"path, a card a rank, is not run), {CALIB_SIZE} images at "
          f"configs/4bit.py's numbers; BRECQ at {CLI_RECON_ITERS} steps a unit "
          f"on {CLI_OPTIM_SIZE} images; {line}")
    case = dict(model=CALIB_MODEL, device=str(device))
    t0 = time.perf_counter()
    spawn(mesh_calib_rank, 2, (work, case), backend="gloo",
          init_file=os.path.join(work, "rendezvous"),
          timeout=MESH_CALIB_TIMEOUT)
    print(f"mesh calibration: 2 ranks ran in {time.perf_counter() - t0:.1f} "
          "s (spawn, CUDA start, calibration, reconstruction, serving and "
          "block checks)")
    ranks = []
    for rank in range(2):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))

    q0, q1 = (torch.load(os.path.join(work, f"qstate_r{r}.pt"))
              for r in range(2))
    check(len(q0) == len(q1) and all(torch.equal(a, b)
                                     for a, b in zip(q0, q1)),
          "mesh calibration: the two ranks' states differ")
    print(f"mesh calibration: the two ranks' states bit-equal ({len(q0)} "
          "tensors)")
    _, q_mesh, _ = load_checkpoint(
        os.path.join(work, "mesh_calibrated.ckpt"), cfg)
    n = compare_qstates(torch, q_mesh, start["served"][1])
    print(f"mesh calibration vs the single-device calibration on the same "
          f"card: {n['picks']} integer picks, {n['adjacent']} differ "
          f"(adjacent; share {n['adjacent'] / max(1, n['picks']):.4f}, "
          f"allowed {ADJACENT_SHARE}); {n['scales']} scales of agreeing "
          f"sites, {n['moved']} past rtol {CALIB_SCALE_RTOL} (allowed share "
          f"{MOVED_SHARE}), worst rel {n['worst_rel']:.3e}")
    check(n["adjacent"] <= ADJACENT_SHARE * n["picks"],
          f"mesh vs single: {n['adjacent']} adjacent picks")
    check(n["moved"] <= MOVED_SHARE * n["scales"],
          f"mesh vs single: {n['moved']} scales past tolerance")

    p_mesh, q_mesh_r, _ = load_checkpoint(
        os.path.join(work, "mesh_reconstructed.ckpt"), cfg)
    t1 = time.perf_counter()
    single = reconstruct_on(torch, spec, start["params"], start["model"],
                            start["qstate"], start["calib"].layout,
                            recon_batches, device, CLI_RECON_ITERS)
    t_single = time.perf_counter() - t1
    mesh_stats = types.SimpleNamespace(
        unit_stats=ranks[0]["reconstruction"]["units"])
    # the card's run first: compare_recons moves the first to the host
    flips, total, move, rec_rel, kl = compare_recons(
        torch, single[:3], (p_mesh, q_mesh_r, mesh_stats),
        start["calib"].layout)
    single_ms = 1e3 * sum(st["seconds"] for st in single[2].unit_stats.values()
                          ) / sum(st["iters"]
                                  for st in single[2].unit_stats.values())
    print(f"mesh reconstruction vs a single-device reconstruction with the "
          f"same draws ({single[3]:.2f} s, {single_ms:.3f} ms a step): "
          f"{flips} of {total} hard decisions flipped (allowed share "
          f"{RECON_FLIP_SHARE}); activation scales apart by {move:.3e} of "
          f"{RECON_CHECK_ITERS} * A_LR (allowed {RECON_SCALE_SHARE}); recs "
          f"worst rel {rec_rel:.3e} (allowed {RECON_REC_RTOL}), head KL worst "
          f"abs {kl:.3e} (allowed {RECON_KL_ATOL})")
    check(flips <= RECON_FLIP_SHARE * total, f"mesh recon: {flips} flips")
    check(move <= RECON_SCALE_SHARE, f"mesh recon: scales apart {move}")
    check(rec_rel <= RECON_REC_RTOL and kl <= RECON_KL_ATOL,
          f"mesh recon: recs apart {rec_rel}, {kl}")
    del single, p_mesh, q_mesh_r
    torch.cuda.empty_cache()

    per_batch = MESH_LAUNCHES[CALIB_MODEL, 2, 1, False]
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    want.update({k: n * N_BATCHES for k, n in per_batch.items()})
    launches = {k: 0 for k in want}
    worst = {"K1": 0.0, "K4": 0.0}
    for rank, r in enumerate(ranks):
        c, rc, s = r["calibration"], r["reconstruction"], r["serve"]
        ar, rar = c["all_reduce"], rc["all_reduce"]
        print(f"mesh calibration rank {rank}: wall {c['wall_s']:.2f} s "
              f"(capture {c['seconds']['capture']:.2f} s; searches "
              + ", ".join(f"{k} {v:.2f} s" for k, v in c["seconds"].items()
                          if k != "capture")
              + f"); peak device memory {c['peak_bytes'] / 2**30:.2f} GiB; "
              f"{ar['count']} dp all_reduces, {ar['bytes'] / 2**20:.2f} MiB, "
              f"{ar['seconds']:.2f} s inside them; reconstruction wall "
              f"{rc['wall_s']:.2f} s, {rc['ms_per_step']:.3f} ms a step, "
              f"peak {rc['peak_bytes'] / 2**30:.2f} GiB (the largest "
              f"unit's), {rar['count']} all_reduces, "
              f"{rar['bytes'] / 2**20:.2f} MiB, {rar['seconds']:.2f} s inside "
              "them (a call waits for the device's queued work and for the "
              "other rank; 2 ranks sharing one card through host-memory "
              f"collectives, not a scaling number); {line}")
        print(f"mesh calibration rank {rank} served: launches "
              f"{s['launches']} for {N_BATCHES} batches of {BATCH} (want "
              f"{want}); by variant K1 {s['variants']['K1']}, K4 "
              f"{s['variants']['K4']}; {BATCH * N_BATCHES / s['seconds']:.1f} "
              "img/s")
        check(s["launches"] == want,
              f"mesh calibration rank {rank}: launches {s['launches']}")
        for k in ("K1", "K4"):
            check(s["variants"][k]["fma"] == 0,
                  f"mesh calibration rank {rank}: {k} took variant 'fma'")
        for k, (d, share) in s["block"].items():
            print(f"block check mesh calibration rank {rank}: {k} vs plain "
                  f"on the rank's own inputs: max|diff|={d:.3e} "
                  f"share_past_tol={share:.3e} (allowed share {FLIP_SHARE})")
            check(share <= FLIP_SHARE, f"mesh calibration rank {rank} {k} "
                  f"block check share {share}")
            check(k != "K4" or d <= FLIP_MAX,
                  f"mesh calibration rank {rank} K4 max|diff| {d}")
            worst[k] = max(worst[k], d)
        for k, n in s["launches"].items():
            launches[k] += n
    y = torch.from_numpy(np.load(os.path.join(work, "mesh_logits.npy")))
    check_logits(torch, y, spec, BATCH * N_BATCHES, "mesh calibration")
    print(json.dumps({"mesh_calibration": {
        "model": CALIB_MODEL, "card": line, "dp": 2,
        "ranks": ranks,
        "single_recon_s": t_single, "single_recon_ms_per_step": single_ms}}))
    shutil.rmtree(work, ignore_errors=True)
    return launches, worst


# CLI phase: the reference-compatible CLI (adalog_tpu_torch/cli.py, what
# `python -m adalog_tpu_torch.cli` runs) driven on an on-disk ImageFolder of
# CLI_CLASSES classes x CLI_PER_CLASS JPEGs a split, at odd sizes, written
# from seeded numpy noise; CLI_MODEL at full depth and width with the CLI's
# own random weights from CLI_SEED; validation batches of BATCH images
CLI_MODEL, CLI_SEED = "deit_small", 5
CLI_CLASSES, CLI_PER_CLASS = 4, 16
CLI_SIZES = ((500, 375), (375, 500), (333, 501), (640, 427))
# the --optimize branch at full width, cut from the shipped 20000 steps and
# 1024 images (the reconstruction phase measures BRECQ at depth)
CLI_RECON_ITERS, CLI_OPTIM_SIZE = 20, 64
# logits of a reference-format (.pth) round trip against the .ckpt's
CLI_PTH_ATOL = 1e-5


def write_image_folder(root, seed):
    """train/ and val/ ImageFolders of smooth noise JPEGs (PIL)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        for c in range(CLI_CLASSES):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d)
            for i in range(CLI_PER_CLASS):
                w, h = CLI_SIZES[(c + i) % len(CLI_SIZES)]
                px = np.cumsum(rng.standard_normal((h, w, 3)), axis=0) * 8
                Image.fromarray(np.clip(px + 128, 0, 255).astype(np.uint8)
                                ).save(os.path.join(d, f"{i:03d}.jpg"),
                                       quality=90)


def write_config(path, **fields):
    """A config file: configs/4bit.py's Config with ``fields`` set."""
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "4bit.py")
    lines = ["import importlib.util",
             f"_spec = importlib.util.spec_from_file_location('_base', "
             f"{base!r})",
             "_base = importlib.util.module_from_spec(_spec)",
             "_spec.loader.exec_module(_base)", "",
             "class Config(_base.Config):",
             "    def __init__(self):",
             "        super().__init__()"]
    lines += [f"        self.{k} = {v!r}" for k, v in fields.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


class CliRecords:
    """Collects the CLI's log records of one run: each validation's
    (top1, top5, loss, wall) and (images, wall, img/s, waited, share), and
    the calibration and reconstruction seconds."""

    def __init__(self):
        import logging

        self.records = []
        self.handler = logging.Handler()
        self.handler.emit = self.records.append
        self.logger = logging.getLogger("adalog_tpu_torch")

    def __enter__(self):
        self.records.clear()
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)

    def _args(self, prefix):
        return [r.args for r in self.records if r.msg.startswith(prefix)]

    def validations(self):
        return [dict(top1=a[0], top5=a[1], loss=a[2], images=b[0],
                     wall_s=b[1], img_per_s=b[2], loader_wait_s=b[3],
                     loader_share=b[4] / 100.0)
                for a, b in zip(self._args(" * Prec@1"),
                                self._args(" * %d images in"))]

    def seconds(self, stage):
        return [a[1] for a in self._args(f"%s - {stage} finished in")]


def run_cli(torch, fq_attn, fq_gemm, flags, tag):
    """``cli.main`` on ``flags`` with the launch counts set to 0 just before
    and read just after; prints the stage's seconds and each validation.
    Returns (params, qstate, launches, validations, wall seconds)."""
    import argparse

    from adalog_tpu_torch import cli

    args = argparse.ArgumentParser(parents=[cli.get_args_parser()]
                                   ).parse_args(flags)
    with CliRecords() as rec:
        zero_launches(fq_attn, fq_gemm)
        t0 = time.perf_counter()
        params, qstate = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches(fq_attn, fq_gemm)
        vals = rec.validations()
        inner = {s: rec.seconds(s) for s in ("calibration",
                                             "block reconstruction")}
    print(f"cli {tag}: {wall:.2f} s wall"
          + "".join(f", {s} {v[0]:.1f} s" for s, v in inner.items() if v)
          + f"; launches {got}")
    for v in vals:
        print(f"cli {tag}: validate {v['images']} images, Prec@1 "
              f"{v['top1']:.3f} Prec@5 {v['top5']:.3f} loss {v['loss']:.4f}, "
              f"{v['img_per_s']:.1f} img/s, data loader {v['loader_wait_s']:.3f}"
              f" s of {v['wall_s']:.3f} s ({100 * v['loader_share']:.1f}%)")
    return params, qstate, got, vals, wall


def only_file(pattern):
    import glob

    found = glob.glob(pattern)
    check(len(found) == 1, f"{pattern}: {found}")
    return found[0]


def direct_counts(torch, predict, loader):
    """(images, top-1 hits, top-5 hits) of ``predict`` over the loader's
    val split, by torch.topk."""
    n = c1 = c5 = 0
    for x, y in loader.val_loader():
        top = torch.topk(predict(x), 5, dim=-1).indices.cpu()
        y = torch.as_tensor(y, dtype=torch.long)[:, None]
        c1 += int((top[:, :1] == y).sum())
        c5 += int((top == y).any(-1).sum())
        n += len(y)
    return n, c1, c5


def hits(v):
    """Top-1 and top-5 hits of a logged validation."""
    return (round(v["top1"] * v["images"] / 100.0),
            round(v["top5"] * v["images"] / 100.0))


def cli_phase(torch, fq_attn, fq_gemm, device, ckpt_dir):
    """Drive the CLI on CLI_MODEL: (b) --calibrate at configs/4bit.py from
    an ImageFolder on disk, its checkpoint held to a direct QuantCalibrator
    run on the same calib_batches and its logged Prec@1 / Prec@5 to
    make_predictor's own; (c) that checkpoint loaded and validated with the
    GEMM kernel on, then exported to a reference .pth and loaded the same
    way; (e) the checkpoint loaded and validated with eval_int8; (d)
    --load-calibrate-checkpoint --optimize. Launches asserted per
    validation batch: K1 12 each run, K4 0 (b, d, e) or 49 (c), K5 37 (e)
    else 0. Returns ({kernel: launches of the runs}, {kernel: 0.0})."""
    import logging
    import shutil

    from adalog_tpu_torch.calib.calibrator import QuantCalibrator
    from adalog_tpu_torch.data import native_loader
    from adalog_tpu_torch.data.imagenet import ImageNetLoader
    from adalog_tpu_torch.models.zoo import build_model, model_spec
    from adalog_tpu_torch.serve import make_predictor
    from adalog_tpu_torch.utils.checkpoint import load_checkpoint
    from adalog_tpu_torch.utils.config import load_config
    from adalog_tpu_torch.utils.ref_checkpoint import \
        export_reference_state_dict

    line = card_line()
    root = os.path.join(ckpt_dir, "cli")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "imagenet")
    t0 = time.perf_counter()
    write_image_folder(data, SEED + 31)
    print(f"cli: ImageFolder of {CLI_CLASSES} classes x {CLI_PER_CLASS} "
          f"JPEGs a split at sizes {CLI_SIZES} written in "
          f"{time.perf_counter() - t0:.2f} s")
    cfg4 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "4bit.py")
    cfg_gemm = write_config(os.path.join(root, "gemm_cfg.py"),
                            use_pallas_gemm=True)
    cfg_opt = write_config(os.path.join(root, "opt_cfg.py"),
                           recon_iters=CLI_RECON_ITERS,
                           optim_size=CLI_OPTIM_SIZE)
    common = ["--model", CLI_MODEL, "--dataset", data, "--seed",
              str(CLI_SEED), "--val-batch-size", str(BATCH)]
    val_batches = -(-CLI_CLASSES * CLI_PER_CLASS // BATCH)
    n_attn, n_linear = MODELS[CLI_MODEL]["K1"], MODELS[CLI_MODEL]["K4"]
    n_int8 = INT8_MODELS[CLI_MODEL]
    stages, launches = {}, {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}

    def expect(got, batches, gemm, tag, int8=False):
        want = {"K1": n_attn * batches, "K2": 0, "K3": 0,
                "K4": n_linear * batches if gemm else 0,
                "K5": n_int8 * batches if int8 else 0}
        check(got == want, f"cli {tag}: launches {got} != {want}")
        check_k5_variants(want["K5"], f"cli {tag}")
        for k, n in got.items():
            launches[k] += n

    # (b) calibrate at the shipped numbers
    out_b = os.path.join(root, "calibrate")
    params, qstate, got, vals, stages["calibrate"] = run_cli(
        torch, fq_attn, fq_gemm, common + [
            "--config", cfg4, "--calibrate", "--output-dir", out_b],
        "--calibrate")
    expect(got, val_batches, False, "--calibrate")
    why = native_loader.unavailable_reason()
    print(f"cli: the loader decoded with "
          f"{'the native library' if native_loader.available() else 'PIL'}"
          + ("" if why is None else f"; the native build failed:\n{why}"))
    ckpt = only_file(os.path.join(out_b, "*", f"{CLI_MODEL}_w4_a4_s4_"
                                  f"calibsize_32.ckpt"))
    spec = model_spec(CLI_MODEL)
    loader = ImageNetLoader(data, spec, BATCH, 8)
    batches = loader.calib_batches(32, 32, CLI_SEED, augment=True)
    _, model = build_model(CLI_MODEL, seed=CLI_SEED, device=device)
    calib = QuantCalibrator(spec, model, load_config(cfg4), device=device)
    calib.calibrate(batches)
    p_direct, q_direct = calib.finish_calibration()
    p_ckpt, q_ckpt, _ = load_checkpoint(ckpt, spec.cfg)
    n = compare_qstates(torch, q_ckpt, q_direct)
    print(f"cli --calibrate checkpoint vs a direct QuantCalibrator run on "
          f"the same calib_batches: {n['picks']} integer picks, "
          f"{n['adjacent']} apart (want 0); {n['scales']} scales, "
          f"{n['moved']} past rtol {CALIB_SCALE_RTOL} (allowed share "
          f"{MOVED_SHARE}), worst rel {n['worst_rel']:.3e}")
    check(n["adjacent"] == 0, "cli checkpoint picks differ from the direct")
    check(n["moved"] <= MOVED_SHARE * n["scales"],
          f"cli checkpoint: {n['moved']} scales past tolerance")
    del calib, p_direct, q_direct, model
    predict = make_predictor(spec, p_ckpt, q_ckpt, cfg=load_config(cfg4),
                             device=device)
    n_img, c1, c5 = direct_counts(torch, predict, loader)
    v = vals[0]
    print(f"cli --calibrate logged hits (top-1, top-5) {hits(v)} of "
          f"{v['images']}; make_predictor's own {(c1, c5)} of {n_img}")
    check(v["images"] == n_img and hits(v) == (c1, c5),
          "cli --calibrate Prec@1/Prec@5 differ from make_predictor's")
    del predict, p_ckpt, q_ckpt, params, qstate
    torch.cuda.empty_cache()

    # (c) the load paths with the GEMM kernel on: the .ckpt, then .pth
    pth = os.path.join(root, "ref.pth")
    runs = {}
    for fmt, path in (("ckpt", ckpt), ("pth", pth)):
        p, q, got, vals, stages[f"load .{fmt}"] = run_cli(
            torch, fq_attn, fq_gemm, common + [
                "--load-calibrate-checkpoint", path,
                "--test-calibrate-checkpoint", "--config", cfg_gemm,
                "--output-dir", os.path.join(root, f"load_{fmt}")],
            f"--load-calibrate-checkpoint .{fmt}")
        expect(got, val_batches, True, f"load .{fmt}")
        runs[fmt] = (p, q, vals[0])
        if fmt == "ckpt":        # the loaded state, exported for the next
            sd = export_reference_state_dict(spec, load_config(cfg_gemm), p,
                                             q)
            torch.save({k: torch.from_numpy(np.asarray(a))
                        for k, a in sd.items()}, pth)
    x = next(iter(loader.val_loader()))[0]
    y = {fmt: make_predictor(spec, p, q, cfg=load_config(cfg_gemm),
                             use_gemm_kernels=True, device=device)(x)
         for fmt, (p, q, _) in runs.items()}
    diff = (y["pth"] - y["ckpt"]).abs().max().item()
    print(f"cli .pth vs .ckpt: hits {hits(runs['pth'][2])} vs "
          f"{hits(runs['ckpt'][2])}; logits max|diff| {diff:.3e} (allowed "
          f"{CLI_PTH_ATOL})")
    check(hits(runs["pth"][2]) == hits(runs["ckpt"][2]),
          "cli .pth Prec@1/Prec@5 differ from the .ckpt's")
    check(diff <= CLI_PTH_ATOL, f"cli .pth logits apart by {diff}")
    del runs, y
    torch.cuda.empty_cache()

    # (e) the same checkpoint loaded with eval_int8: every validation batch
    # through K5 at the uniform sites
    cfg_int8 = write_config(os.path.join(root, "int8_cfg.py"),
                            eval_int8=True)
    _, _, got, vals, stages["load .ckpt, eval_int8"] = run_cli(
        torch, fq_attn, fq_gemm, common + [
            "--load-calibrate-checkpoint", ckpt,
            "--test-calibrate-checkpoint", "--config", cfg_int8,
            "--output-dir", os.path.join(root, "load_int8")],
        "--load-calibrate-checkpoint .ckpt, eval_int8")
    expect(got, val_batches, False, "load .ckpt, eval_int8", int8=True)
    check(len(vals) == 1, f"cli eval_int8 validations {vals}")

    # (d) reconstruct the loaded checkpoint (--optimize), cut in depth
    out_d = os.path.join(root, "optimize")
    _, _, got, vals, stages["optimize"] = run_cli(
        torch, fq_attn, fq_gemm, common + [
            "--config", cfg_opt, "--load-calibrate-checkpoint", ckpt,
            "--optimize", "--output-dir", out_d], "--optimize")
    expect(got, -(-CLI_OPTIM_SIZE // BATCH) + val_batches, False,
           "--optimize")
    only_file(os.path.join(out_d, "*", f"{CLI_MODEL}_w4_a4_s4_optimsize_"
                           f"{CLI_OPTIM_SIZE}.ckpt"))
    check(len(vals) == 2 and vals[0]["images"] == CLI_OPTIM_SIZE,
          f"cli --optimize validations {vals}")
    for h in logging.root.handlers[:]:     # the CLI's output.log
        logging.root.removeHandler(h)
        h.close()
    shutil.rmtree(root)
    print(json.dumps({"cli": {"model": CLI_MODEL, "card": line,
                              "stages_s": stages,
                              "decoder": "native" if native_loader.available()
                              else "PIL", "decoder_error": why}}))
    return launches, {"K1": 0.0, "K4": 0.0}


def calibration_profile(torch, device):
    """Where the device time of a calibration of CALIB_MODEL goes: one cold
    run untraced, then one traced by torch.profiler: the share of the
    traced span in cuBLAS GEMMs (the scoring products), in elementwise and
    reduction kernels (the quantize / compare work), in sorts, the rest,
    and idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from adalog_tpu_torch.models.load import load_state_dict
    from adalog_tpu_torch.models.zoo import model_spec

    spec = model_spec(CALIB_MODEL)
    images = calibration_images(spec.cfg, CALIB_SIZE, SEED + 7)
    model = load_state_dict(spec, timm_weights(spec.cfg, SEED)).to(device)
    calibrate_on(torch, spec, model, images, device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, calib, wall, _ = calibrate_on(torch, spec, model, images,
                                            device)
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(evs, "the profiler saw no device event in the calibration")
    spans = [(e.time_range.start, e.time_range.end) for e in evs]
    busy = busy_us(spans)
    span = max(b for _, b in spans) - min(a for a, _ in spans)

    def kind(name):
        n = name.lower()
        if kernel_class(name) == "GEMM":
            return "GEMM"
        if "sort" in n or "radix" in n:
            return "sort"
        if "elementwise" in n or "reduce" in n or "index" in n:
            return "elementwise"
        return "other"

    us, top = {}, {}
    for e in evs:
        t = e.time_range.end - e.time_range.start
        k = kind(e.name)
        us[k] = us.get(k, 0.0) + t
        top[k, e.name] = top.get((k, e.name), 0.0) + t
    print(f"profile calibration {CALIB_MODEL}: wall {wall:.2f} s traced, "
          f"{len(evs)} device events, device busy {busy / 1e6:.2f} s of a "
          f"{span / 1e6:.2f} s span (idle {100 * (1 - busy / span):.1f}%); "
          + ", ".join(f"{k} {100 * v / span:.1f}%" for k, v in
                      sorted(us.items(), key=lambda kv: -kv[1]))
          + " of the span; searches " + ", ".join(
              f"{k} {v:.2f} s" for k, v in calib.seconds.items()))
    for (k, name), t in sorted(top.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    top {k}: {t / 1e6:.3f} s  {name[:110]}")


RECON_PROFILE_ITERS = 10


def reconstruction_profile(torch, device, ckpt_dir):
    """Where the time of a reconstruction step goes: deit_small with its
    smoke state (a step's work does not depend on the state's values), all
    units at RECON_PROFILE_ITERS steps on two batches, once untraced (ms a
    step), then traced by torch.profiler: device busy share of the traced
    span, device time in GEMMs (cuBLAS / cuDNN) and in the rest, device
    events a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from adalog_tpu_torch.calib.layout import quant_layout

    spec, model, qstate, ckpt, batches = smoke_model(torch, device, ckpt_dir)
    os.remove(ckpt)
    layout = quant_layout(spec, quant_config())

    def run():
        return reconstruct_on(torch, spec, model, model, qstate, layout,
                              batches[:2], device, RECON_PROFILE_ITERS)

    *_, recon, wall = run()
    stats = recon.unit_stats
    steps = sum(st["iters"] for st in stats.values())
    step_ms = {n: 1e3 * st["seconds"] / st["iters"] for n, st in stats.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        *_, wall_traced = run()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(evs, "the profiler saw no device event in the reconstruction")
    spans = [(e.time_range.start, e.time_range.end) for e in evs]
    busy = busy_us(spans)
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    us, top = {}, {}
    for e in evs:
        t = e.time_range.end - e.time_range.start
        k = "GEMM" if kernel_class(e.name) == "GEMM" else "other"
        us[k] = us.get(k, 0.0) + t
        top[k, e.name] = top.get((k, e.name), 0.0) + t
    print(f"profile reconstruction {CALIB_MODEL} ({RECON_PROFILE_ITERS} "
          f"steps a unit, smoke state): untraced {wall:.2f} s, ms a step "
          f"blocks.0 {step_ms['blocks.0']:.2f}, patch_embed "
          f"{step_ms['patch_embed']:.2f}, head {step_ms['head']:.2f}; traced "
          f"{wall_traced:.2f} s, {len(evs) / steps:.0f} device events a step, "
          f"device busy {busy / 1e6:.3f} s of a {span / 1e6:.3f} s span "
          f"(idle {100 * (1 - busy / span):.1f}%); "
          + ", ".join(f"{k} {100 * v / span:.1f}%" for k, v in
                      sorted(us.items(), key=lambda kv: -kv[1]))
          + " of the span")
    for (k, name), t in sorted(top.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    top {k}: {t / 1e3 / steps:.3f} ms a step  {name[:110]}")


def flash_phase_profile(torch, fq_attn, device):
    """Where the cycles of K1 "mma" go, by phase of the kernel, at the
    attention shapes of batch 32 and at KERNEL_SHAPE, fp32 and bf16: one
    launch each of the instrumented build (fq_attn.flash_phase_cycles)."""
    shapes = (("deit_small batch 64", KERNEL_SHAPE["G"], KERNEL_SHAPE["S"],
               KERNEL_SHAPE["D"], 0),) + tuple(
        (m, G, S, D, 0 if S == 197 else G // BATCH)
        for m, G, S, D in MATMUL_SHAPES)
    for model, G, S, D, P in shapes:
        *args, bias = attention_inputs(torch, G, S, D, max(P, 1), SEED + 3,
                                       device)
        kw = dict(m1a_bits=4, m1b_bits=4, m2a_bits=4, m2b_bits=4,
                  logit_scale=1.0 if P else D ** -0.5)
        for dtype in (torch.float32, torch.bfloat16):
            a = [t.to(dtype) for t in args[:3]] + args[3:]
            cycles = fq_attn.flash_phase_cycles(*a, bias if P else None, **kw)
            total = sum(cycles.values())
            print(f"K1 'mma' phases {model} G={G} S={S} D={D} "
                  f"{str(dtype).split('.')[-1]}: "
                  + ", ".join(f"{k} {100 * c / total:.1f}%"
                              for k, c in cycles.items())
                  + f" of {total / 1e6:.1f} M warp cycles")


def matmul_phase_profile(torch, fq_attn, device):
    """Where the cycles of K2 "mma" and of K3 "mma" go, by phase of the
    kernels, at MATMUL_SHAPES, fp32 and bf16: one launch each of the
    instrumented build (fq_attn.matmul_phase_cycles)."""
    modes = {"K3 uniform A (q @ kT)": "uniform",
             "K3 AdaLog A (probs @ v)": "adalog",
             "K2 (softmax, AdaLog, @ v)": "softmax"}
    for i, (model, G, S, D) in enumerate(MATMUL_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            cases, _ = matmul_cases(torch, fq_attn, G, S, D, SEED + 20 + i,
                                    device, dtype)
            for name, (_, _, args, kw) in cases.items():
                cycles = fq_attn.matmul_phase_cycles(
                    modes[name], *args, a_bits=kw["a_bits"],
                    b_bits=kw["b_bits"])
                total = sum(cycles.values())
                print(f"{name} 'mma' phases {model} G={G} S={S} D={D} "
                      f"{str(dtype).split('.')[-1]}: "
                      + ", ".join(f"{k} {100 * c / total:.1f}%"
                                  for k, c in cycles.items() if c)
                      + f" of {total / 1e6:.1f} M warp cycles")


def gemm_phase_profile(torch, fq_gemm, device):
    """Where the cycles of K4 "mma" go, by phase of the kernel, at
    GEMM_SHAPES and GEMM_SWIN_SHAPES, fp32 and bf16: one launch each of the
    instrumented build (fq_gemm.gemm_phase_cycles)."""
    for i, (site, T, K, O, kind) in enumerate(GEMM_SHAPES + GEMM_SWIN_SHAPES):
        x, w, prm, b = gemm_inputs(torch, T, K, O, kind, SEED + 10 + i, device)
        w, codes = weight_with_codes(torch, fq_gemm, w)
        for dtype in (torch.float32, torch.bfloat16):
            cycles = fq_gemm.gemm_phase_cycles(
                x.to(dtype), w.to(dtype), prm, b.to(dtype), kind=kind, bits=4,
                codes=codes)
            total = sum(cycles.values())
            print(f"K4 'mma' phases {site} {kind} T={T} K={K} O={O} "
                  f"{str(dtype).split('.')[-1]}: "
                  + ", ".join(f"{k} {100 * c / total:.1f}%"
                              for k, c in cycles.items())
                  + f" of {total / 1e6:.1f} M warp cycles")


def int8_phase_profile(torch, device):
    """Where the cycles of K5's two variants go, by phase of the kernel, at
    deit_small's qkv and fc1 at batch 32, fp32 and bf16: one launch each of
    the instrumented build (int8_linear.int8_phase_cycles)."""
    from adalog_tpu_torch.ops import int8_linear

    for i, (site, T, K, O) in enumerate(INT8_SHAPES):
        if site not in ("deit_small qkv", "deit_small fc1"):
            continue
        x, w_int, prm, srow, b = int8_inputs(torch, T, K, O, SEED + 40 + i,
                                             device)
        for dtype in (torch.float32, torch.bfloat16):
            for variant in ("wgmma", "mma"):
                cycles = int8_linear.int8_phase_cycles(
                    x.to(dtype), w_int, prm, srow, b.to(dtype), bits=4,
                    variant=variant)
                total = sum(cycles.values())
                print(f"K5 '{variant}' phases {site} T={T} K={K} O={O} "
                      f"{str(dtype).split('.')[-1]}: "
                      + ", ".join(f"{k} {100 * c / total:.1f}%"
                                  for k, c in cycles.items() if c)
                      + f" of {total / 1e6:.1f} M warp cycles")


PROFILE_WARMUP, PROFILE_BATCHES = 3, 5


def kernel_class(name):
    """K1, K4, GEMM (cuBLAS/cuDNN products and convolutions) or other."""
    n = name.lower()
    if "fq_flash_attn" in n:
        return "K1"
    if "fq_gemm" in n:
        return "K4"
    if any(k in n for k in ("gemm", "conv", "xmma", "cutlass", "fprop",
                            "nvjet")):
        return "GEMM"
    return "other"


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_phase(torch, device, ckpt_dir, name="deit_small", activity=None):
    """Where the device time of a served batch goes, per dtype and serving
    setting: PROFILE_BATCHES batches of BATCH images already on the device,
    after PROFILE_WARMUP, first timed untraced (wall ms a batch), then
    traced by torch.profiler, which counts every device event (kernels,
    copies, fills). Prints and returns one row per (dtype, setting)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec, model, qstate, ckpt, batches = smoke_model(torch, device, ckpt_dir,
                                                     name)
    del model, qstate
    x = torch.from_numpy(batches[0]).to(device)
    preds = predictors(ckpt, device, x, name)
    os.remove(ckpt)
    activity = ProfilerActivity.CUDA if activity is None else activity
    dev_type = DeviceType.CUDA if activity == ProfilerActivity.CUDA \
        else DeviceType.CPU
    rows = []
    for (dt, setting), predict in preds.items():
        for _ in range(PROFILE_WARMUP):
            predict(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_BATCHES):
            predict(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILE_BATCHES
        with profile(activities=[activity]) as prof:
            for _ in range(PROFILE_BATCHES):
                predict(x)
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == dev_type]
        check(evs, f"{name} {dt} {setting}: the profiler saw no device event")
        spans = [(e.time_range.start, e.time_range.end) for e in evs]
        busy = busy_us(spans)
        span = max(b for _, b in spans) - min(a for a, _ in spans)
        ms = {"K1": 0.0, "K4": 0.0, "GEMM": 0.0, "other": 0.0}
        by_name = {"GEMM": {}, "other": {}}
        for e in evs:
            t = (e.time_range.end - e.time_range.start) / 1e3
            c = kernel_class(e.name)
            ms[c] += t
            if c in by_name:
                by_name[c][e.name] = by_name[c].get(e.name, 0.0) + t
        row = dict(model=name, dtype=dt, setting=setting, wall_ms=wall,
                   busy_ms=busy / 1e3 / PROFILE_BATCHES,
                   idle=1.0 - busy / span,
                   events=len(evs) / PROFILE_BATCHES,
                   **{k: v / PROFILE_BATCHES for k, v in ms.items()})
        rows.append(row)
        print(f"profile {name} {dt}, {setting}: wall {wall:.2f} ms/batch, "
              f"device busy {row['busy_ms']:.2f} ms/batch, idle "
              f"{100 * row['idle']:.1f}%, K1 {row['K1']:.2f}, K4 "
              f"{row['K4']:.2f}, GEMM "
              f"{row['GEMM']:.2f}, other {row['other']:.2f} ms/batch, "
              f"{row['events']:.0f} device events/batch")
        for c, top in (("GEMM", 3), ("other", 5)):
            for n, t in sorted(by_name[c].items(), key=lambda kv: -kv[1])[:top]:
                print(f"    top {c}: {t / PROFILE_BATCHES:.3f} ms/batch  "
                      f"{n[:110]}")
    return rows


def main(argv):
    import torch

    if argv not in ([], ["--profile"]):
        sys.exit("usage: python3 chip_smoke.py [--profile]")
    profile = argv == ["--profile"]
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script runs the "
              "port on an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    started = time.perf_counter()
    line = card_line()
    print(line)
    print(f"card: {line} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from adalog_tpu_torch.ops import cuda_build, fq_attn, fq_gemm

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:      # one nvcc each
        libs = list(pool.map(cuda_build.build, KERNELS))
    print(f"build: {time.perf_counter() - t0:.2f} s (in parallel) -> "
          + ", ".join(os.path.relpath(p) for p in libs))
    for lib in libs:
        rows, warnings = ptxas_report(lib + ".log")
        check(rows, f"{lib}.log names no kernel")
        for kernel, regs, spill, smem in rows:
            print(f"ptxas: {kernel}: {regs} registers, {smem} bytes of "
                  f"static shared memory, {spill} bytes of spill stores and "
                  "loads")
            check(spill == 0, f"{kernel} spills registers")
        for w in warnings:
            print(f"ptxas: {os.path.basename(lib)}: {w}")
        # a wgmma the compiler serializes waits for each product in turn
        check(not any("wgmma" in w and "serialized" in w for w in warnings),
              f"{lib}: the compiler serializes wgmma")
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "checkpoints")
    if profile:
        flash_phase_profile(torch, fq_attn, device)
        matmul_phase_profile(torch, fq_attn, device)
        gemm_phase_profile(torch, fq_gemm, device)
        int8_phase_profile(torch, device)
        for name in SMOKE_MODELS:
            profile_phase(torch, device, ckpt_dir, name)
        calibration_profile(torch, device)
        reconstruction_profile(torch, device, ckpt_dir)
        return

    (k_ms, kq_ms, kg_ms, p_ms), worst = kernel_phase(torch, fq_attn, device)
    (g_ms, gq_ms, gg_ms, gp_ms), g_worst = gemm_kernel_phase(torch, fq_gemm,
                                                             device)
    mm = matmul_kernel_phase(torch, fq_attn, device)
    # the main paths, each driven with the counts at 0 just before and read
    # just after: serving each model with the attention and GEMM kernels
    # (K1, K4), the three configurations that reach K2 and K3, and the
    # calibrated deit_small served
    launches = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}
    block_worst = {k: 0.0 for k in launches}

    def add(got, errs):
        for k, n in got.items():
            launches[k] += n
        for k, d in errs.items():
            block_worst[k] = max(block_worst[k], d)

    for name in SMOKE_MODELS:
        add(*serving_phase(torch, fq_attn, fq_gemm, device, ckpt_dir, name))
        add(*fallback_phase(torch, fq_attn, fq_gemm, device, ckpt_dir, name))
    # every other zoo shape served through K1 and K4, and K2 / K3 at the
    # deepest ViT and the largest Swin windows
    for phase, names in ((serving_phase, ZOO_MODELS),
                         (fallback_phase, ZOO_FALLBACK)):
        for name in names:
            torch.cuda.reset_peak_memory_stats(device)
            add(*phase(torch, fq_attn, fq_gemm, device, ckpt_dir, name))
            print(f"{phase.__name__} {name}: peak device memory "
                  f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} "
                  f"GiB; {card_line()}")
    # serving over a mesh of ranks on the one card: K1, K4 and K5 on each
    # rank's batch, weight and head slices
    add(*mesh_phase(torch, fq_attn, fq_gemm, device, ckpt_dir))
    # the calibration half of the main path, then its model served; then
    # the calibrated state reconstructed, folded and served
    served, start = calibration_phase(torch, fq_attn, fq_gemm, device,
                                      ckpt_dir)
    add(*served)
    # the same calibration and reconstruction over dp=2 ranks on the card,
    # the mesh-calibrated model served on the dp=2 predictor
    add(*mesh_calibration_phase(torch, fq_attn, fq_gemm, device, ckpt_dir,
                                start))
    # the shipped W3A3 and W6A6 configurations: calibrated, served (K1, K4
    # and K5) and held to the CPU's calibration on test_tiny
    add(*bits_phase(torch, fq_attn, fq_gemm, device, ckpt_dir, start))
    # the int8 path: K5's cases, then the calibrated deit_small and the
    # smoke swin_tiny served with eval_int8, diagnostics and export
    k5, got, errs = int8_phase(torch, fq_attn, fq_gemm, device, ckpt_dir,
                               start)
    k5 = k5["float32"]
    add(got, errs)
    add(*reconstruction_phase(torch, fq_attn, fq_gemm, device, ckpt_dir,
                              start))
    # the reference-compatible CLI: calibrate, load (.ckpt and .pth) and
    # optimize, each run's validations through the kernels
    add(*cli_phase(torch, fq_attn, fq_gemm, device, ckpt_dir))
    for k, n in launches.items():
        check(n > 0, f"{k} was launched no time on the main paths")

    G, S, D = (KERNEL_SHAPE[k] for k in "GSD")
    k1_bound, k1_by = flash_bound_ms(G, S, D, 0, torch.float32)
    k4_bounds = [gemm_bound_ms(T, K, O, torch.float32)
                 for site, T, K, O, kind in GEMM_SHAPES
                 if (site, kind) != ("fc2", "uniform")]

    def entry(name, source, replaces, key, err, ms, plain_ms, bound, by,
              library_ms=None, **more):
        # library_ms: no single PyTorch call computes K1-K4 (the fake
        # quantizers sit inside the products), so there is none to time;
        # K5's is torch._int_mm on the activation codes, the product alone
        return {"name": name, "route": "cuda", **more,
                "source": f"adalog_tpu_torch/csrc/{source}.cu",
                "replaces": f"adalog_tpu/ops/{replaces}",
                "launches": launches[key], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": library_ms}

    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": [
        entry("fq_flash_attn", "fq_flash_attn", "fq_attn.py:226", "K1",
              max(worst, block_worst["K1"]), k_ms, p_ms, k1_bound, k1_by,
              # what the served path launches, asserted; ms is one call a
              # timing, as every entry's, ms_back_to_back ten in a row,
              # ms_graph ten replayed from a CUDA graph (the device alone)
              variant="mma", ms_back_to_back=kq_ms, ms_graph=kg_ms),
        # K2 and K3 as their paths launch them, asserted: "mma"; K3's times
        # are the sums of its two calls of one attention
        entry("fq_softmax_attn_matmul", "fq_attn_matmul", "fq_attn.py:160",
              "K2", max(mm["K2"]["max_abs_err"], block_worst["K2"]),
              mm["K2"]["ms"], mm["K2"]["plain_ms"], mm["K2"]["bound_ms"],
              mm["K2"]["bound_by"], variant="mma",
              ms_back_to_back=mm["K2"]["ms_back_to_back"],
              ms_graph=mm["K2"]["ms_graph"]),
        entry("fq_attn_matmul", "fq_attn_matmul", "fq_attn.py:146", "K3",
              max(mm["K3"]["max_abs_err"], block_worst["K3"]),
              mm["K3"]["ms"], mm["K3"]["plain_ms"], mm["K3"]["bound_ms"],
              mm["K3"]["bound_by"], variant="mma",
              ms_back_to_back=mm["K3"]["ms_back_to_back"],
              ms_graph=mm["K3"]["ms_graph"]),
        entry("fq_gemm", "fq_gemm", "fq_gemm.py:100", "K4",
              max(g_worst, block_worst["K4"]), g_ms, gp_ms,
              sum(b for b, _ in k4_bounds), max(k4_bounds)[1],
              # ms is one call a timing and ms_back_to_back ten in a row,
              # both with the wrapper's host time; ms_graph the device alone
              variant="mma", ms_back_to_back=gq_ms, ms_graph=gg_ms),
        # K5: times summed over deit_small's three block sites and the head
        # (fp32), as K4's, of the variant its paths launch, asserted:
        # "wgmma"; "mma"'s beside them; library_ms_graph is torch._int_mm
        # from a CUDA graph
        entry("int8_gemm", "int8_gemm", "int8_linear.py:147", "K5",
              block_worst["K5"], k5["wgmma"]["ms"], k5["plain_ms"],
              k5["bound_ms"], k5["bound_by"], library_ms=k5["library_ms"],
              variant="wgmma", ms_back_to_back=k5["wgmma"]["ms_back_to_back"],
              ms_graph=k5["wgmma"]["ms_graph"],
              library_ms_graph=k5["library_ms_graph"],
              mma_ms=k5["mma"]["ms"],
              mma_ms_back_to_back=k5["mma"]["ms_back_to_back"],
              mma_ms_graph=k5["mma"]["ms_graph"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
