"""Candidate-scoring primitives for the calibration search, the counterpart
of ``adalog_tpu.ops.scoring``.

Each scorer takes eq_n candidate quantization parameters along a leading
axis and returns one similarity per candidate (and per unit: row group,
channel or head). Candidates are scored in chunks sized by a fixed byte
budget (``_map``), the deterministic analog of the reference's
memory-derived parallel_eq_n, so intermediates stay bounded. A chunk is one
broadcast computation: the candidate axis leads every intermediate.

Conventions
  - similarity = negative sum of squared error; reductions keep the
    reference's mean-over-feature / sum-over-batch order where it affects
    ranking granularity.
  - x is pre-flattened to (T, I) tokens; targets have the layer bias
    already subtracted (the bias is candidate-independent).
  - all math in float32. The products are torch.matmul / einsum (cuBLAS on
    the card), in exact fp32: on CUDA the caller pins full-fp32 matrix
    products first (``serve.pin_fp32_matmul``; the calibrator does).
  - divisors are tensors: PyTorch's CUDA kernels divide by a Python number
    as a multiply by its reciprocal, which is not IEEE division, and the
    AdaLog code arithmetic here must be exact on both devices.
  - the token axis T (or the image axis N) may be dp-sharded: inside
    ``parallel.mesh.dp_context`` every score that sums over it takes its
    rank's partial, ``dp_sum``s it once per call (after the candidate
    chunks), then applies the global normaliser; ``gram_stats`` reduces its
    token sums once, so the Gram-form weight scores need no collective.
    The other Gram statistics are per token or per image, and the scores
    that read them reduce as the direct forms do.
"""

from __future__ import annotations

import functools

import torch

from adalog_tpu_torch.parallel.mesh import dp_count, dp_mesh, dp_sum
from adalog_tpu_torch.quantizers.logarithm import ADALOG_R

# Max bytes for any single candidate-chunk intermediate.
SCORE_BUDGET_BYTES = 1 << 30

# dtype of the scoring products' operands. float32 (default) is the
# reference's exact fp32; bfloat16 rounds the operands to bf16 and keeps
# fp32 products and sums (the JAX package's preferred_element_type=float32):
# the rounded operands are multiplied in fp32, where the product of two bf16
# values is exact, on both devices. Set by set_score_dtype() from
# Config.search_dtype.
_SCORE_DTYPE = torch.float32


def set_score_dtype(name: str):
    """Select the scoring products' operand dtype: 'float32' or
    'bfloat16'."""
    global _SCORE_DTYPE
    _SCORE_DTYPE = torch.bfloat16 if name == "bfloat16" else torch.float32


def check_score_precision(name: str):
    """Check Config.search_precision: 'highest' or 'default'. In the JAX
    package 'default' lets the TPU round fp32 operands; here both run exact
    fp32 products (the field is kept so that config files load)."""
    if name not in ("highest", "default"):
        raise ValueError(f"search_precision {name!r}: want highest or default")


def tdiv(a, d):
    """a / d with d a Python number, as an IEEE division on every device."""
    return a / torch.tensor(d, dtype=a.dtype, device=a.device)


def _operand(a):
    if _SCORE_DTYPE == torch.bfloat16:
        return a.to(torch.bfloat16).float()
    return a


def _mm(a, b):
    """Scoring matmul: operands in the configured dtype, fp32 result."""
    return torch.matmul(_operand(a), _operand(b))


def _es(subs, a, b):
    """Scoring einsum: operands in the configured dtype, fp32 result."""
    return torch.einsum(subs, _operand(a), _operand(b))


def _chunk_size(eq_n: int, bytes_per_candidate: int) -> int:
    cap = max(1, SCORE_BUDGET_BYTES // max(1, bytes_per_candidate))
    c = min(eq_n, cap)
    # the largest divisor of eq_n within the cap: equal chunks
    while eq_n % c:
        c -= 1
    return c


def _map(fn, cands, eq_n: int, bytes_per_candidate: int):
    """fn over chunks of the leading (candidate) axis of every tensor in
    ``cands`` (a tensor or a tuple of them), concatenated."""
    bs = _chunk_size(eq_n, bytes_per_candidate)
    if isinstance(cands, torch.Tensor):
        cands = (cands,)
    outs = [fn(*(c[i:i + bs] for c in cands)) for i in range(0, eq_n, bs)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def uq_asym(x, scale, zp, bits: int):
    """Search-path asymmetric fake quant (zp candidates are already
    integers): (clamp(round(x / s) + z, 0, 2N - 1) - z) * s, formed as
    clamp(round(x / s), -z, 2N - 1 - z) * s, the same value (integers
    throughout) in two fewer passes over x."""
    N = 2 ** (bits - 1)
    return torch.clamp(torch.round(x / scale), -zp, 2 * N - 1 - zp) * scale


@functools.lru_cache(maxsize=None)
def _mantissa_table(bits: int, device) -> torch.Tensor:
    """round(2^(-j/r) / ts) * ts for j = 0..36 (ts = 1 / (4N - 2)), in fp32
    on the CPU as ``quantizers.logarithm.adalog_mantissa`` forms it, then
    moved to ``device``: the same 37 values on every device."""
    j = torch.arange(int(ADALOG_R), dtype=torch.float32)
    ts = 1.0 / (4 * 2 ** (bits - 1) - 2)
    return (torch.round(torch.exp2(-j / ADALOG_R) / ts) * ts).to(device)


@functools.lru_cache(maxsize=None)
def _pow2_table(device) -> torch.Tensor:
    """2^-k for k = 0..150, exact (subnormal past 126, 0 at 150, as IEEE
    exp2 gives them): the same values on every device."""
    return torch.tensor([2.0 ** -k for k in range(151)], dtype=torch.float32,
                        device=device)


def adalog_fq_search(x, scale, q, bits: int, clamp_upper: bool = True):
    """Search-path AdaLog fake quant by the shift/mantissa decomposition;
    ``scale`` (a tensor, or None for 1) and ``q`` (a tensor of integer
    bases) may be candidates. code * q is an exact integer, so the shift
    floor(code * q / r) and the mantissa index (code * q) mod r are taken in
    integer arithmetic, exact on every device (no float division by r),
    and both factors come from fixed tables."""
    N = 2 ** (bits - 1)
    scaled = x if scale is None else x / scale
    if clamp_upper:
        scaled = torch.clamp(scaled, 1e-15, 1.0)
    code = torch.round(-torch.log2(scaled) * ADALOG_R / q)
    keep = code < 2 * N
    prod = (torch.clamp(code, 0, 2 * N - 1) * q).to(torch.int32)
    shift = torch.clamp(torch.div(prod, int(ADALOG_R), rounding_mode="floor"),
                        max=150)
    frac = torch.remainder(prod, int(ADALOG_R))
    dq = _pow2_table(prod.device)[shift] * \
        _mantissa_table(bits, prod.device)[frac] * keep
    return dq if scale is None else dq * scale


# ---------------------------------------------------------------------------
# Self-searches (score the quantization error of the tensor itself)
# ---------------------------------------------------------------------------

def score_weight_self(w_v, scales, zps, bits: int, mem_scale: int = 1):
    """w_v: (V, R, I); scales/zps: (E, V, R, 1) -> similarity (E, V, R):
    per-row-group mean of the squared weight quantization error."""
    E = scales.shape[0]

    def chunk(s, z):
        dq = uq_asym(w_v, s, z, bits)
        return -torch.mean(torch.square(w_v - dq), dim=-1)

    return _map(chunk, (scales, zps), E, w_v.numel() * 4 * mem_scale)


def score_act_self(x, scales, zps, bits: int, *, channel_wise: bool,
                   n_batch: int, mem_scale: int = 1):
    """x: (T, I) flattened tokens from n_batch calibration samples.

    Per-tensor: scales (E, 1, 1) -> (E,), the mean over T and I;
    channel-wise: scales (E, 1, I) -> (E, I), the sum over T over T."""
    E = scales.shape[0]
    mesh = dp_mesh()

    def chunk(s, z):
        err = torch.square(x - uq_asym(x, s, z, bits))
        if channel_wise:
            return -torch.sum(err, dim=1)
        if mesh is None:
            return -torch.mean(err, dim=(1, 2))
        return -torch.sum(err, dim=(1, 2))

    sims = _map(chunk, (scales, zps), E, x.numel() * 4 * mem_scale)
    T = dp_count(x.shape[0], mesh)
    if channel_wise:
        return dp_sum(sims, mesh) * (n_batch / T)
    if mesh is None:
        return sims * n_batch
    return tdiv(dp_sum(sims, mesh), T * x.shape[1]) * n_batch


# ---------------------------------------------------------------------------
# Output-MSE searches (score layer-output reconstruction)
# ---------------------------------------------------------------------------

def score_linear_w_out(x_q, target, w_v, scales, zps, bits: int,
                       mem_scale: int = 1):
    """Weight-candidate scoring against the layer output.

    x_q: (T, I) activation-quantized input; target: (T, O) raw output minus
    bias; w_v: (V, R, I); scales/zps: (E, V, R, 1) -> similarity (E, V, R):
    per-output-unit SSE."""
    E = scales.shape[0]
    T, O = target.shape
    V, R, I = w_v.shape
    tgt = target.reshape(T, V, R)

    def chunk(s, z):
        w_dq = uq_asym(w_v, s, z, bits)                      # (c, V, R, I)
        out = _es("ti,evri->etvr", x_q, w_dq)
        return -torch.sum(torch.square(tgt - out), dim=1)    # (c, V, R)

    return dp_sum(_map(chunk, (scales, zps), E,
                       (T * O + V * R * I) * 4 * mem_scale), dp_mesh())


def gram_stats(x_q, target):
    """(G, C) for the Gram-form weight scoring: G = x_qᵀ x_q (I, I),
    C = targetᵀ x_q (O, I). Once per search round; every candidate then
    scores in O(O·I²) instead of O(T·O·I). Both are sums over T: reduced
    over dp once here."""
    mesh = dp_mesh()
    return dp_sum(x_q.T @ x_q, mesh), dp_sum(target.T @ x_q, mesh)


def score_linear_w_out_gram(G, Cm, w_v, scales, zps, bits: int,
                            mem_scale: int = 1):
    """Gram-form weight-candidate scoring, ranking-equivalent to
    score_linear_w_out: per output unit, -SSE = 2·w·C[o] - w·G·w + const;
    the target-energy constant is dropped (it cancels in the argmax)."""
    E = scales.shape[0]
    V, R, I = w_v.shape
    Cv = Cm.reshape(V, R, I)

    def chunk(s, z):
        w_dq = uq_asym(w_v, s, z, bits)                      # (c, V, R, I)
        term2 = torch.sum(w_dq * Cv, dim=-1)
        wG = torch.matmul(w_dq, G)
        term3 = torch.sum(wG * w_dq, dim=-1)
        return 2.0 * term2 - term3

    return _map(chunk, (scales, zps), E, 2 * V * R * I * 4 * mem_scale)


def score_linear_a_out(x, target, w_q, scales, zps, bits: int,
                       mem_scale: int = 1):
    """Activation-candidate scoring against the layer output (per tensor).

    x: (T, I); target: (T, O) minus bias; w_q: (O, I) weight-quantized;
    scales/zps: (E, 1, 1) -> similarity (E,)."""
    E = scales.shape[0]
    T, O = target.shape

    def chunk(s, z):
        out = _mm(uq_asym(x, s, z, bits), w_q.T)
        return -torch.sum(torch.square(target - out), dim=(1, 2))

    return dp_sum(_map(chunk, (scales, zps), E,
                       (T * O + x.numel()) * 4 * mem_scale), dp_mesh())


def act_gram_stats(target, w_q):
    """(Mw, Gw) for the Gram-form activation scoring: Mw = target·w_q
    (T, I), one row per token, Gw = w_qᵀ w_q (I, I), of the weight only:
    neither is a sum over T."""
    return target @ w_q, w_q.T @ w_q


def score_linear_a_out_gram(x, Mw, Gw, scales, zps, bits: int,
                            mem_scale: int = 1):
    """Gram-form activation-candidate scoring, ranking-equivalent to
    score_linear_a_out: -SSE = 2·Σ x_dq∘Mw - Σ (x_dq Gw)∘x_dq + const."""
    E = scales.shape[0]

    def chunk(s, z):
        x_dq = uq_asym(x, s, z, bits)
        term2 = torch.sum(x_dq * Mw, dim=(1, 2))
        term3 = torch.sum(_mm(x_dq, Gw) * x_dq, dim=(1, 2))
        return 2.0 * term2 - term3

    return dp_sum(_map(chunk, (scales, zps), E, 2 * x.numel() * 4 * mem_scale),
                  dp_mesh())


def score_linear_a_out_twin(x, target, w_q, scales_pos, scale_neg, bits: int,
                            mem_scale: int = 1):
    """PTQ4ViT twin-range positive-scale scoring; scales_pos: (E, 1, 1),
    scale_neg: fixed (1,) -> similarity (E,)."""
    E = scales_pos.shape[0]
    N = 2 ** (bits - 1)
    T, O = target.shape
    x_neg = torch.clamp(torch.round(x / scale_neg), -N, 0) * scale_neg

    def chunk(sp):
        x_pos = torch.clamp(torch.round(x / sp), 0, N - 1) * sp
        out = _mm(x_pos + x_neg, w_q.T)
        return -torch.sum(torch.square(target - out), dim=(1, 2))

    return dp_sum(_map(chunk, scales_pos, E,
                       (T * O + x.numel()) * 4 * mem_scale), dp_mesh())


def score_linear_a_out_adalog(x, target, w_q, shift, scales, qs, bits: int,
                              mem_scale: int = 1):
    """Post-GeLU AdaLog scoring with per-candidate (scale, q) pairs.

    x: (T, I) raw input; target minus bias; shift: GELU_MIN;
    scales/qs: (E, 1, 1) -> similarity (E,)."""
    E = scales.shape[0]
    T, O = target.shape

    xs = x + shift

    def chunk(s, q):
        x_dq = adalog_fq_search(xs, s, q, bits) - shift
        out = _mm(x_dq, w_q.T)
        return -torch.sum(torch.square(target - out), dim=(1, 2))

    return dp_sum(_map(chunk, (scales, qs), E,
                       (T * O + x.numel()) * 4 * mem_scale), dp_mesh())


# ---------------------------------------------------------------------------
# MatMul searches (attention q@kT and softmax@v)
# ---------------------------------------------------------------------------

def _matmul_sim(err2, head_channel_wise: bool):
    """err2: (c, N, H, S, S2) -> (c, H) or (c,): per-head mean over the
    trailing dims, sum over the batch."""
    if head_channel_wise:
        return -torch.sum(torch.mean(err2, dim=(3, 4)), dim=1)
    return -torch.sum(torch.mean(err2, dim=(2, 3, 4)), dim=1)


def score_matmul_opA(A, B_q, target, scales, zps, bits: int,
                     head_channel_wise: bool, mem_scale: int = 1):
    """Candidate-quantize A against the raw A@B output.

    A: (N, H, S, C); B_q: (N, H, C, S2) quantized; target: (N, H, S, S2);
    scales/zps: (E, 1, H|1, 1, 1) -> similarity (E, H) or (E,)."""
    E = scales.shape[0]

    def chunk(s, z):
        out = _mm(uq_asym(A, s, z, bits), B_q)
        return _matmul_sim(torch.square(target - out), head_channel_wise)

    return dp_sum(_map(chunk, (scales, zps), E,
                       (target.numel() + A.numel()) * 4 * mem_scale),
                  dp_mesh())


def score_matmul_opB(A_q, B, target, scales, zps, bits: int,
                     head_channel_wise: bool, mem_scale: int = 1):
    """Candidate-quantize B against the raw A@B output."""
    E = scales.shape[0]

    def chunk(s, z):
        out = _mm(A_q, uq_asym(B, s, z, bits))
        return _matmul_sim(torch.square(target - out), head_channel_wise)

    return dp_sum(_map(chunk, (scales, zps), E,
                       (target.numel() + B.numel()) * 4 * mem_scale),
                  dp_mesh())


def _matmul_sim_gram(sse, denom, head_channel_wise: bool):
    """sse: (c, N, H) per-slice SSE (up to the dropped target energy) ->
    (c, H) or (c,) with _matmul_sim's mean/sum order."""
    sim = -tdiv(sse, denom)
    if head_channel_wise:
        return torch.sum(sim, dim=1)
    return torch.sum(torch.mean(sim, dim=2), dim=1)


def matmul_gram_stats_opA(B_q, target):
    """(G_B, M) for the Gram-form A-candidate matmul scoring:
    G_B = B_q B_qᵀ (N, H, C, C), M = target·B_qᵀ (N, H, S, C): per image,
    no sum over N."""
    return (torch.einsum("nhcs,nhds->nhcd", B_q, B_q),
            torch.einsum("nhst,nhct->nhsc", target, B_q))


def score_matmul_opA_gram(A, G_B, M, target_s2: int, scales, zps, bits: int,
                          head_channel_wise: bool, mem_scale: int = 1):
    """Gram-form A-candidate scoring, ranking-equivalent to
    score_matmul_opA: per (n, h), SSE = tr(A_dqᵀA_dq·G_B) - 2⟨A_dq, M⟩ +
    const. target_s2: the S2 extent of the dropped target."""
    E = scales.shape[0]
    N, H, S, C = A.shape
    denom = S * target_s2

    def chunk(s, z):
        A_dq = uq_asym(A, s, z, bits)
        GA = _es("enhsc,enhsd->enhcd", A_dq, A_dq)
        sse = (torch.sum(GA * G_B, dim=(3, 4))
               - 2.0 * torch.sum(A_dq * M, dim=(3, 4)))       # (c, N, H)
        return _matmul_sim_gram(sse, denom, head_channel_wise)

    return dp_sum(_map(chunk, (scales, zps), E,
                       (A.numel() + N * H * C * C) * 4 * mem_scale),
                  dp_mesh())


def matmul_gram_stats_opB(A_q, target):
    """(G_A, M2) for the Gram-form B-candidate matmul scoring:
    G_A = A_qᵀ A_q (N, H, C, C), M2 = A_qᵀ·target (N, H, C, S2): per image,
    no sum over N."""
    return (torch.einsum("nhsc,nhsd->nhcd", A_q, A_q),
            torch.einsum("nhsc,nhst->nhct", A_q, target))


def score_matmul_opB_gram(B, G_A, M2, target_s: int, scales, zps, bits: int,
                          head_channel_wise: bool, mem_scale: int = 1):
    """Gram-form B-candidate scoring, ranking-equivalent to
    score_matmul_opB: per (n, h), SSE = tr(B_dqᵀ·G_A·B_dq) - 2⟨B_dq, M2⟩ +
    const. target_s: the S extent of the dropped target."""
    E = scales.shape[0]
    N, H, C, S2 = B.shape
    denom = target_s * S2

    def chunk(s, z):
        B_dq = uq_asym(B, s, z, bits)
        GB = _mm(G_A, B_dq)
        sse = (torch.sum(GB * B_dq, dim=(3, 4))
               - 2.0 * torch.sum(B_dq * M2, dim=(3, 4)))      # (c, N, H)
        return _matmul_sim_gram(sse, denom, head_channel_wise)

    return dp_sum(_map(chunk, (scales, zps), E,
                       (B.numel() + N * H * C * S2) * 4 * mem_scale),
                  dp_mesh())


def score_postsoftmax_base(A, B_q, target, qs, bits: int,
                           mem_scale: int = 1):
    """AdaLog log-base (q) scoring for the post-softmax operand, scale
    frozen at 1. A in [0, 1]; qs: (E,) -> similarity (E,)."""
    E = qs.shape[0]

    def chunk(q):
        A_dq = adalog_fq_search(A, None, q.reshape(-1, 1, 1, 1, 1), bits,
                                clamp_upper=False)
        out = _mm(A_dq, B_q)
        return _matmul_sim(torch.square(target - out), head_channel_wise=False)

    return dp_sum(_map(chunk, qs, E,
                       (target.numel() + A.numel()) * 4 * mem_scale),
                  dp_mesh())


# ---------------------------------------------------------------------------
# Conv search (patch-embed projection)
# ---------------------------------------------------------------------------

def score_conv_w_out(x, target, w_flat, conv_dims, scales, zps, bits: int,
                     mem_scale: int = 1):
    """Weight-candidate scoring for the conv: per-out-channel SSE.

    x: (N, H, W, IC) NHWC (activations pass through unquantized at >= 8
    bits); target: (N, FH, FW, OC) minus bias; w_flat: (OC, IC*KH*KW);
    conv_dims: (kh, kw, stride, padding); scales/zps: (E, OC, 1)."""
    E = scales.shape[0]
    kh, kw, stride, padding = conv_dims
    OC = w_flat.shape[0]
    N, H, W, IC = x.shape

    if kh == stride and kw == stride and padding == 0 \
            and H % kh == 0 and W % kw == 0:
        # the patch embed of every zoo model: kernel == stride, so the conv
        # is patch extraction plus a GEMM; patches flattened in the
        # weight's (IC, KH, KW) order
        Ho, Wo = H // kh, W // kw
        patches = x.reshape(N, Ho, kh, Wo, kw, IC).permute(
            0, 1, 3, 5, 2, 4).reshape(N * Ho * Wo, IC * kh * kw)
        tgt2 = target.reshape(N, Ho * Wo, OC)

        def chunk(s, z):
            w_dq = uq_asym(w_flat, s, z, bits)                 # (c, OC, K)
            out = _mm(patches, w_dq.transpose(1, 2))           # (c, P, OC)
            err2 = torch.square(tgt2 - out.reshape(-1, N, Ho * Wo, OC))
            # mean over the spatial dims, sum over the batch
            return -torch.sum(torch.mean(err2, dim=2), dim=1)

        return dp_sum(_map(chunk, (scales, zps), E,
                           (target.numel() + w_flat.numel()) * 4 * mem_scale),
                      dp_mesh())

    import torch.nn.functional as F

    from adalog_tpu_torch.models.layers import _cudnn_full_fp32

    xc = x.permute(0, 3, 1, 2)

    def one(s, z):
        w_dq = uq_asym(w_flat, s, z, bits).reshape(OC, IC, kh, kw)
        with _cudnn_full_fp32():
            out = F.conv2d(xc, w_dq, stride=stride, padding=padding)
        err2 = torch.square(target - out.permute(0, 2, 3, 1))
        # mean over the spatial dims, sum over the batch
        return -torch.sum(torch.mean(err2, dim=(1, 2)), dim=0)

    def chunk(s, z):
        return torch.stack([one(s[i], z[i]) for i in range(s.shape[0])])

    return dp_sum(_map(chunk, (scales, zps), E,
                       (target.numel() + w_flat.numel()) * 4 * mem_scale),
                  dp_mesh())
