"""Drive the PyTorch/CUDA port (adalog_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # phases 1-5, each a hard check
    python3 chip_smoke.py --profile    # phases 1-2, then the profile below

Phases, each a hard check (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
  2. build both kernels with nvcc, one process each, started together:
     K1 (csrc/fq_flash_attn.cu) and K4 (csrc/fq_gemm.cu); the ptxas
     register and spill lines are printed;
  3. K1 kernel phase: the fused attention kernel against its plain PyTorch
     version at the deit_small attention shapes (batch 64: G=384, S=197,
     D=64), fp32 and bf16, with and without a (6, S, S) bias, per-slice
     scales and AdaLog bases other than 37; max|diff|, share past
     tolerance, median times;
  4. K4 kernel phase: the fused activation-quant GEMM against its plain
     version at the five deit_small Linear shapes of batch 32 (T=6304:
     qkv 384->1152, proj 384->384, fc1 384->1536, fc2 1536->384 in both
     kinds; the head at T=32, 384->1000), fp32 and bf16: max|diff|, share
     past tolerance, the quantized activations themselves (through an
     identity weight: uniform bit for bit, AdaLog flips bounded), the
     fused bias equal to the unfused add bit for bit, median times;
  5. serving phase: deit_small at full depth and width with random weights
     from a numpy seed and a smoke quantizer state whose fc2 biases carry
     the folded GeLU shift (calib/reparam.py); K1 against its plain version
     on the q/kT/v of all 12 blocks and K4 against its plain version on the
     inputs of all 49 Linear sites (block check); then the state saved as a
     v2 .ckpt and served through load_quantized in float32 and bfloat16,
     with the attention kernel only, with the attention and GEMM kernels,
     and plain, on 4 batches of 32 images each: per batch K1 must run 12
     times with either kernel switch on and K4 49 times with the GEMM
     switch on (0 off), logits finite and of the right shape; img/s and
     the agreement of the logits between the settings are reported.
The last two lines are a JSON summary of the kernels and the ok line.

With --profile, after the build: the same smoke model served in each
dtype and setting, 5 batches of 32 after 3 warm-up batches, wall ms a
batch untraced, then one torch.profiler trace: device busy ms a batch,
idle share of the traced span, device time split into K1, K4, cuBLAS/cuDNN
GEMM and convolution, and the rest (the top kernels of the last two are
printed).
"""

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
KERNELS = ("fq_flash_attn", "fq_gemm")        # csrc/<name>.cu
KERNEL_SHAPE = dict(G=384, S=197, D=64, P=6)     # deit_small, batch 64
BATCH, N_BATCHES = 32, 4
# K4 at deit_small's Linear sites, batch 32 (T = 32 images x 197 tokens):
# (site, T, K, O, kind)
GEMM_SHAPES = (("qkv", 6304, 384, 1152, "uniform"),
               ("proj", 6304, 384, 384, "uniform"),
               ("fc1", 6304, 384, 1536, "uniform"),
               ("fc2", 6304, 1536, 384, "uniform"),
               ("fc2", 6304, 1536, 384, "adalog_shift"),
               ("head", 32, 384, 1000, "uniform"))
SMOKE_LOG_Q = 29.0          # AdaLog base of the smoke state, not 37
# qkv weight std: q.k logits of LayerNormed tokens then have a std of about
# (QKV_STD**2 * dim) * head_dim**0.5 / 8 ~ 2
QKV_STD = 0.075
# kernel vs plain: the two sum in different orders and log2f/exp2f may
# differ by an ulp, so a probability near an AdaLog code boundary may take
# the neighbouring code and move its row's outputs. At most FLIP_SHARE of
# the outputs may leave ATOL + RTOL*|ref|, none by more than FLIP_MAX.
ATOL = RTOL = 1e-5
FLIP_SHARE = 1e-3
FLIP_MAX = 0.1
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

def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Median milliseconds of fn() over reps runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def kernel_phase(torch, fq_attn, device):
    """Hold the kernel against its plain version; returns the fp32 no-bias
    times and the largest max|diff| of all cases."""
    G, S, D, P = (KERNEL_SHAPE[k] for k in "GSDP")
    q, kT, v, m1a, m1b, m2q, m2b, bias = attention_inputs(
        torch, G, S, D, P, SEED, device)
    kw = dict(m1a_bits=4, m1b_bits=4, m2a_bits=4, m2b_bits=4,
              logit_scale=D ** -0.5)
    worst, fp32_times = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in (q, kT, v)] + [m1a, m1b, m2q, m2b]
        for b in (None, bias):
            got = fq_attn.fq_flash_attn(*args, b, **kw)
            want = fq_attn.fq_flash_attn_plain(*args, b, **kw)
            torch.cuda.synchronize()
            check(tuple(got.shape) == (G, S, D) and got.dtype == torch.float32,
                  "kernel output shape/dtype")
            check(bool(torch.isfinite(got).all()), "kernel output not finite")
            diff = (got - want).abs()
            share = (diff > ATOL + RTOL * want.abs()).float().mean().item()
            max_diff = diff.max().item()
            k_ms = cuda_ms(torch, lambda: fq_attn.fq_flash_attn(*args, b, **kw))
            p_ms = cuda_ms(torch, lambda: fq_attn.fq_flash_attn_plain(
                *args, b, **kw))
            tag = f"{str(dtype).split('.')[-1]}, {'bias' if b is not None else 'no bias'}"
            print(f"kernel K1 fq_flash_attn [{tag}] G={G} S={S} D={D}: "
                  f"max|diff|={max_diff:.3e} share_past_tol={share:.3e} "
                  f"(atol={ATOL} rtol={RTOL}; allowed share {FLIP_SHARE}, "
                  f"max {FLIP_MAX}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}")
            check(share <= FLIP_SHARE, f"[{tag}] share past tolerance {share}")
            check(max_diff <= FLIP_MAX, f"[{tag}] max|diff| {max_diff}")
            worst = max(worst, max_diff)
            if dtype == torch.float32 and b is None:
                fp32_times = (k_ms, p_ms)
    return fp32_times, worst


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


def compare(got, want, rtol):
    """(max|diff|, share of outputs past ATOL + rtol*|want|), in fp32."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return (diff.max().item(),
            (diff > ATOL + rtol * want.abs()).float().mean().item())


def gemm_kernel_phase(torch, fq_gemm, device):
    """Hold K4 against its plain version at the deit_small Linear shapes;
    returns (the fp32 times summed over one block's four sites, fc2 as
    adalog_shift, and the head: kernel ms, plain ms) and the largest
    max|diff|."""
    worst, k_sum, p_sum = 0.0, 0.0, 0.0
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for i, (site, T, K, O, kind) in enumerate(GEMM_SHAPES):
            x, w, prm, b = gemm_inputs(torch, T, K, O, kind, SEED + 10 + i,
                                       device)
            x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
            kw = dict(kind=kind, bits=4)
            got = fq_gemm.fq_gemm(x, w, prm, **kw)
            want = fq_gemm.fq_gemm_plain(x, w, prm, **kw)
            got_b = fq_gemm.fq_gemm(x, w, prm, b, **kw)
            # an identity weight passes the quantized activations through
            # the product exactly
            xq = fq_gemm.fq_gemm(x, torch.eye(K, dtype=dtype, device=device),
                                 prm, **kw)
            xq_ref = fq_gemm.quantize_plain(x, prm, **kw).to(dtype)
            torch.cuda.synchronize()
            tag = f"{dt}, {site} {kind}"
            check(tuple(got.shape) == (T, O) and got.dtype == dtype,
                  f"[{tag}] kernel output shape/dtype")
            check(bool(torch.isfinite(got).all()), f"[{tag}] not finite")
            check(torch.equal(got_b, got + b), f"[{tag}] fused bias differs "
                  "from the product plus the bias")
            flips = (xq != xq_ref).float().mean().item()
            max_diff, share = compare(got, want, GEMM_RTOL[dt])
            k_ms = cuda_ms(torch, lambda: fq_gemm.fq_gemm(x, w, prm, b, **kw))
            p_ms = cuda_ms(torch, lambda: fq_gemm.fq_gemm_plain(
                x, w, prm, b, **kw))
            print(f"kernel K4 fq_gemm [{tag}] T={T} K={K} O={O}: "
                  f"max|diff|={max_diff:.3e} share_past_tol={share:.3e} "
                  f"(atol={ATOL} rtol={GEMM_RTOL[dt]:.3e}; allowed share "
                  f"{FLIP_SHARE}, max {FLIP_MAX}) quantized_x_differ="
                  f"{flips:.3e} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}")
            check(flips == 0.0 if kind == "uniform" else flips <= FLIP_SHARE,
                  f"[{tag}] quantized activations differ: share {flips}")
            check(share <= FLIP_SHARE, f"[{tag}] share past tolerance {share}")
            check(max_diff <= FLIP_MAX, f"[{tag}] max|diff| {max_diff}")
            worst = max(worst, max_diff)
            if dt == "float32" and (site, kind) != ("fc2", "uniform"):
                k_sum, p_sum = k_sum + k_ms, p_sum + p_ms
    return (k_sum, p_sum), worst


def fold_fc2(torch, spec, model, qstate):
    """Fold the GeLU shift through each fc2's quantized weight into its
    bias (calib/reparam.py), as calibration finishes, and set the flag: fc2
    then quantizes x + shift with no subtract-back and takes K4."""
    from adalog_tpu_torch.calib.reparam import fold_gelu_shift_into_bias
    from adalog_tpu_torch.quantizers.state import GELU_MIN

    for i in range(spec.cfg.depth):
        mlp, site = model.blocks[i].mlp, qstate[f"blocks.{i}.mlp.fc2"]
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


def smoke_qstate(torch, spec, model, images, device):
    """A SMOKE quantizer state, not an FPCS calibration: init_qstate with
    activation scales and zero points set by min/max from one raw capture
    pass (per head at the attention matmuls) and the AdaLog bases of the
    post-GeLU and post-softmax sites set to SMOKE_LOG_Q."""
    from adalog_tpu_torch.calib.init_state import init_qstate
    from adalog_tpu_torch.models.layers import LinearSite, MatMulSite
    from adalog_tpu_torch.models.vit import vit_forward
    from adalog_tpu_torch.utils.config import Config

    qstate = init_qstate(spec, Config(w_bit=4, a_bit=4, s_bit=4,
                                      qhead_a_bit=4), model)
    with torch.no_grad():
        _, taps = vit_forward(spec.cfg, model, images.to(device),
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
                else:
                    site.Aq.log_q = log_q
                minmax(site.Bq, B, (0, 2, 3))
    return qstate


def block_check(torch, fq_attn, fq_gemm, spec, model, qstate, x, dt):
    """Hold K1 against its plain version on the q/kT/v that every block of
    the quantized model gives it for images x, and K4 on the input of every
    Linear site that takes it, from one capture pass with the served
    path's tables active; returns {kernel: (largest max|diff|, largest
    share past tolerance)}."""
    from adalog_tpu_torch.models.vit import vit_forward
    from adalog_tpu_torch.ops import weight_prep
    from adalog_tpu_torch.utils.config import Config

    wprep = weight_prep.prepare(spec, model, qstate, Config())
    table = fq_gemm.prepare(qstate)
    check(len(table) == 4 * spec.cfg.depth + 1,
          f"{len(table)} Linear sites take K4, want {4 * spec.cfg.depth + 1}")
    worst = {"K1": (0.0, 0.0), "K4": (0.0, 0.0)}

    def note(k, d, share):
        worst[k] = (max(worst[k][0], d), max(worst[k][1], share))

    with torch.inference_mode(), weight_prep.activate(wprep), \
            fq_gemm.activate(table):
        _, taps = vit_forward(spec.cfg, model, x, qstate, {"*": "quant"},
                              capture=True)
        for i in range(spec.cfg.depth):
            p = f"blocks.{i}.attn"
            q, kT, _ = taps[f"{p}.matmul1"]
            _, v, _ = taps[f"{p}.matmul2"]
            args, bits = fq_attn.flash_args(qstate[f"{p}.matmul1"],
                                            qstate[f"{p}.matmul2"], q, kT, v)
            kw = dict(logit_scale=spec.cfg.head_dim ** -0.5, **bits)
            got = fq_attn.fq_flash_attn(*args, **kw)
            want = fq_attn.fq_flash_attn_plain(*args, **kw)
            check(bool(torch.isfinite(got).all()), f"{p}: K1 not finite")
            note("K1", *compare(got, want, RTOL))
        for name, (kind, bits, prm) in table.items():
            xin = taps[name][0]
            xin = xin.reshape(-1, xin.shape[-1])
            args = (xin, wprep[name], prm, model.get_submodule(name).bias)
            got = fq_gemm.fq_gemm(*args, kind=kind, bits=bits)
            want = fq_gemm.fq_gemm_plain(*args, kind=kind, bits=bits)
            check(bool(torch.isfinite(got).all()), f"{name}: K4 not finite")
            note("K4", *compare(got, want, GEMM_RTOL[dt]))
    return worst


# serving settings: (name, use_pallas, use_pallas_gemm)
SETTINGS = (("attention kernel", True, False),
            ("attention + GEMM kernels", True, True),
            ("plain", False, False))


def smoke_model(torch, device, ckpt_dir):
    """deit_small with random weights from SEED and its smoke state with
    fc2 folded, saved as a v2 .ckpt; returns (spec, model, qstate, ckpt
    path, N_BATCHES numpy batches of BATCH images)."""
    from adalog_tpu_torch.models.load import load_vit
    from adalog_tpu_torch.models.zoo import model_spec
    from adalog_tpu_torch.utils.checkpoint import save_checkpoint

    spec = model_spec("deit_small")
    cfg = spec.cfg
    rng = np.random.default_rng(SEED + 1)
    shape = (BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    batches = [rng.standard_normal(shape).astype(np.float32)
               for _ in range(N_BATCHES)]
    calib = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    model = load_vit(cfg, timm_weights(cfg, SEED)).to(device)
    qstate = smoke_qstate(torch, spec, model, calib, device)
    fold_fc2(torch, spec, model, qstate)
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(ckpt_dir, "deit_small_smoke_w4a4.ckpt")
    save_checkpoint(ckpt, model, qstate, {"model": "deit_small",
                                          "state": "smoke, not FPCS"})
    return spec, model, qstate, ckpt, batches


def predictors(ckpt, device, batch):
    """{(dtype, setting): predict} for every serving setting in float32 and
    bfloat16, loaded through load_quantized and run once on ``batch``."""
    from adalog_tpu_torch.serve import load_quantized
    from adalog_tpu_torch.utils.config import Config

    preds = {}
    for dt in ("float32", "bfloat16"):
        for name, attn, gemm in SETTINGS:
            predict, *_ = load_quantized(
                "deit_small", ckpt, device=device, eval_dtype=dt,
                use_pallas=attn, config=Config(w_bit=4, a_bit=4, s_bit=4,
                                               qhead_a_bit=4,
                                               use_pallas_gemm=gemm))
            predict(batch)                           # warm-up
            preds[dt, name] = predict
    return preds


def serving_phase(torch, fq_attn, fq_gemm, device, ckpt_dir):
    """Serve deit_small through load_quantized; returns ({kernel: launches
    on this slice's main path, attention + GEMM kernels}, {kernel: largest
    block-check max|diff|})."""
    spec, model, qstate, ckpt, batches = smoke_model(torch, device, ckpt_dir)
    cfg = spec.cfg
    worst = {"K1": 0.0, "K4": 0.0}
    x0 = torch.from_numpy(batches[0]).to(device)
    for dt, dtype in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        m = model.to(dtype)
        res = block_check(torch, fq_attn, fq_gemm, spec, m, qstate,
                          x0.to(dtype), dt)
        for k, what in (("K1", f"the q/kT/v of all {cfg.depth} blocks"),
                        ("K4", f"the inputs of all {4 * cfg.depth + 1} "
                               "Linear sites")):
            d, share = res[k]
            print(f"block check {dt}: {k} vs plain on {what}, batch "
                  f"{BATCH}: max|diff|={d:.3e} share_past_tol={share:.3e} "
                  f"(allowed share {FLIP_SHARE}, max {FLIP_MAX})")
            check(share <= FLIP_SHARE, f"{dt} {k} block check share {share}")
            check(d <= FLIP_MAX, f"{dt} {k} block check max|diff| {d}")
            worst[k] = max(worst[k], d)
    del model, qstate, m
    torch.cuda.empty_cache()

    preds = predictors(ckpt, device, batches[0])
    os.remove(ckpt)
    torch.cuda.synchronize()

    def serve(predict):
        t0 = time.perf_counter()
        outs = [predict(x) for x in batches]
        torch.cuda.synchronize()
        return torch.cat(outs), BATCH * N_BATCHES / (time.perf_counter() - t0)

    # each setting is a path of its own, driven in both dtypes with the
    # launch counts set to 0 just before and read just after; the main path
    # of this slice is the second, attention + GEMM kernels
    per_batch = {"attention kernel": (cfg.depth, 0),
                 "attention + GEMM kernels": (cfg.depth, 4 * cfg.depth + 1),
                 "plain": (0, 0)}
    served, launches = {}, {}
    for name, *_ in SETTINGS:
        fq_attn.fq_flash_attn.launches = fq_gemm.fq_gemm.launches = 0
        for dt in ("float32", "bfloat16"):
            served[dt, name] = serve(preds[dt, name])
        got = (fq_attn.fq_flash_attn.launches, fq_gemm.fq_gemm.launches)
        want = tuple(n * N_BATCHES * 2 for n in per_batch[name])
        print(f"serving path '{name}': K1 {got[0]}, K4 {got[1]} launches "
              f"for 2 x {N_BATCHES} batches of {BATCH} (want K1 "
              f"{per_batch[name][0]}, K4 {per_batch[name][1]} per batch = "
              f"{want[0]}, {want[1]})")
        check(got == want, f"'{name}' launches {got} != {want}")
        launches[name] = dict(zip(("fq_flash_attn", "fq_gemm"), got))

    for dt in ("float32", "bfloat16"):
        for name, *_ in SETTINGS:
            y, ips = served[dt, name]
            check(tuple(y.shape) == (BATCH * N_BATCHES, cfg.num_classes),
                  f"{dt} {name} logits shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), f"{dt} {name} logits")
            check(y.std().item() > 0, f"{dt} {name} logits constant")
            print(f"serving deit_small {dt}, {name}: {ips:.1f} img/s")
        for a, b in ((1, 0), (1, 2), (0, 2)):
            (ya, _), (yb, _) = served[dt, SETTINGS[a][0]], \
                served[dt, SETTINGS[b][0]]
            agree = (ya.argmax(-1) == yb.argmax(-1)).float().mean().item()
            rel = ((ya - yb).norm() / yb.norm()).item()
            print(f"serving deit_small {dt} logits, {SETTINGS[a][0]} vs "
                  f"{SETTINGS[b][0]}: top-1 agreement {agree:.4f}, max|diff| "
                  f"{(ya - yb).abs().max().item():.4e}, rel L2 {rel:.4e} "
                  f"(max|logit| {yb.abs().max().item():.4e})")
    return launches["attention + GEMM kernels"], worst


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


def profile_phase(torch, device, ckpt_dir, activity=None):
    """Where the device time of a served batch goes, per dtype and serving
    setting: PROFILE_BATCHES batches of BATCH images already on the device,
    after PROFILE_WARMUP, first timed untraced (wall ms a batch), then
    traced by torch.profiler, which counts every device event (kernels,
    copies, fills). Prints and returns one row per (dtype, setting)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec, model, qstate, ckpt, batches = smoke_model(torch, device, ckpt_dir)
    del model, qstate
    x = torch.from_numpy(batches[0]).to(device)
    preds = predictors(ckpt, device, x)
    os.remove(ckpt)
    activity = ProfilerActivity.CUDA if activity is None else activity
    dev_type = DeviceType.CUDA if activity == ProfilerActivity.CUDA \
        else DeviceType.CPU
    rows = []
    for (dt, name), predict in preds.items():
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
        check(evs, f"{dt} {name}: the profiler saw no device event")
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
        row = dict(dtype=dt, setting=name, wall_ms=wall,
                   busy_ms=busy / 1e3 / PROFILE_BATCHES,
                   idle=1.0 - busy / span,
                   events=len(evs) / PROFILE_BATCHES,
                   **{k: v / PROFILE_BATCHES for k, v in ms.items()})
        rows.append(row)
        print(f"profile {dt}, {name}: wall {wall:.2f} ms/batch, device busy "
              f"{row['busy_ms']:.2f} ms/batch, idle {100 * row['idle']:.1f}%"
              f", K1 {row['K1']:.2f}, K4 {row['K4']:.2f}, GEMM "
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
        with open(lib + ".log") as f:
            for ln in f:
                if "registers" in ln or "spill" in ln:
                    print("ptxas: " + ln.strip())
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "checkpoints")
    if profile:
        profile_phase(torch, device, ckpt_dir)
        return

    (k_ms, p_ms), worst = kernel_phase(torch, fq_attn, device)
    (g_ms, gp_ms), g_worst = gemm_kernel_phase(torch, fq_gemm, device)
    launches, block_worst = serving_phase(torch, fq_attn, fq_gemm, device,
                                          ckpt_dir)

    print(json.dumps({"kernels": [
        {"name": "fq_flash_attn", "route": "cuda",
         "source": "adalog_tpu_torch/csrc/fq_flash_attn.cu",
         "replaces": "adalog_tpu/ops/fq_attn.py:226",
         "launches": launches["fq_flash_attn"],
         "max_abs_err": max(worst, block_worst["K1"]),
         "ms": k_ms, "plain_ms": p_ms},
        {"name": "fq_gemm", "route": "cuda",
         "source": "adalog_tpu_torch/csrc/fq_gemm.cu",
         "replaces": "adalog_tpu/ops/fq_gemm.py:100",
         "launches": launches["fq_gemm"],
         "max_abs_err": max(g_worst, block_worst["K4"]),
         "ms": g_ms, "plain_ms": gp_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
