"""EVA-02 in the port (``adalog_tpu_torch/models/eva.py``) against the plain
reference ``tests/torch_ref_eva02.py`` (float64, timm's keys), on the CPU:
RoPE's angles and its untouched class token, the raw forward of
``test_tiny_eva`` loaded from a timm-keyed file, each quantized site from
the program's own inputs, the family's quantization layout, its int8 table
and one calibration.
"""

import numpy as np
import pytest
import torch

import torch_ref_eva02 as ref
from adalog_tpu_torch.calib.calibrator import QuantCalibrator
from adalog_tpu_torch.calib.init_state import init_qstate
from adalog_tpu_torch.calib.layout import quant_layout
from adalog_tpu_torch.models import eva, zoo
from adalog_tpu_torch.models.layers import LinearSite, MatMulSite
from adalog_tpu_torch.models.load import load_timm_state_dict
from adalog_tpu_torch.ops import routes
from adalog_tpu_torch.utils.config import Config, load_config

TINY = "test_tiny_eva"


def ref_cfg(cfg):
    return dict(img_size=cfg.img_size, patch_size=cfg.patch_size,
                dim=cfg.dim, depth=cfg.depth, heads=cfg.heads,
                rope_grid=cfg.rope_grid)


def timm_state_dict(cfg, seed):
    """A random EVA-02 state dict under timm's keys (separate q/k/v, k
    without a bias; fc1_g / fc1_x): weights of std 0.2, so the attention
    rows are not flat, LayerNorms about 1."""
    g = torch.Generator().manual_seed(seed)
    D, H, P = cfg.dim, cfg.mlp_hidden, cfg.patch_size

    def n(*shape, std=0.2, mean=0.0):
        return torch.randn(shape, generator=g) * std + mean

    sd = {"patch_embed.proj.weight": n(D, 3, P, P, std=0.05),
          "patch_embed.proj.bias": n(D, std=0.02),
          "cls_token": n(1, 1, D, std=0.5),
          "pos_embed": n(1, cfg.num_patches + 1, D, std=0.5)}

    def ln(key, d):
        sd[f"{key}.weight"] = n(d, std=0.1, mean=1.0)
        sd[f"{key}.bias"] = n(d, std=0.1)

    def lin(key, o, i, bias=True):
        sd[f"{key}.weight"] = n(o, i, std=i ** -0.5)
        if bias:
            sd[f"{key}.bias"] = n(o, std=0.1)

    for i in range(cfg.depth):
        p = f"blocks.{i}"
        ln(f"{p}.norm1", D)
        lin(f"{p}.attn.q_proj", D, D)
        lin(f"{p}.attn.k_proj", D, D, bias=False)
        lin(f"{p}.attn.v_proj", D, D)
        lin(f"{p}.attn.proj", D, D)
        ln(f"{p}.norm2", D)
        lin(f"{p}.mlp.fc1_g", H, D)
        lin(f"{p}.mlp.fc1_x", H, D)
        ln(f"{p}.mlp.norm", H)
        lin(f"{p}.mlp.fc2", D, H)
    ln("fc_norm", D)
    lin("head", cfg.num_classes, D)
    return sd


def images(n, cfg, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, cfg.img_size, cfg.img_size, 3)).astype(np.float32))


def rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """(spec, timm state dict, the port's model loaded from it as a file)."""
    spec = zoo.model_spec(TINY)
    sd = timm_state_dict(spec.cfg, 0)
    path = str(tmp_path_factory.mktemp("eva") / "tiny_eva.npz")
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return spec, sd, load_timm_state_dict(spec, path)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,c,j", [(0, 0, 0), (0, 5, 3), (7, 0, 15),
                                   (31, 31, 16), (3, 17, 20), (12, 9, 31)])
def test_rope_angles_closed_form(r, c, j):
    """eva02_large_448: a_j = r * 16/32 * 10000^(-j/16) for j < 16 and
    c * 16/32 * 10000^(-(j-16)/16) for j >= 16, patch p = 32 r + c."""
    cfg = zoo.model_spec("eva02_large_448").cfg
    a = eva.rope_angles(cfg)
    assert a.shape == (1024, 32) and a.dtype == torch.float64
    pos, m = (r, j) if j < 16 else (c, j - 16)
    want = pos * 16 / 32 * 10000.0 ** (-m / 16)
    assert a[32 * r + c, j].item() == pytest.approx(want, rel=1e-15, abs=0)
    assert ref.rope_angles(32, 16, 64)[32 * r + c, j].item() == \
        pytest.approx(want, rel=1e-15, abs=0)


def test_rope_turns_pairs_and_leaves_the_class_token():
    """The port's rotation equals the reference's, pair (2j, 2j+1) by the
    closed form, and token 0 (the class token) is untouched; norms of each
    pair are kept."""
    cfg = zoo.model_spec(TINY).cfg
    x = torch.randn(2, cfg.heads, cfg.num_patches + 1, cfg.head_dim,
                    generator=torch.Generator().manual_seed(3))
    got = eva.apply_rope(x.double(), eva.rope_tables(cfg, dtype=torch.float64))
    for dtype in (torch.float32, torch.bfloat16):     # complex, and cos / sin
        low = eva.apply_rope(x.to(dtype), eva.rope_tables(cfg, dtype=dtype))
        assert low.dtype == dtype and rel(low, got) < (1e-6 if dtype ==
                                                       torch.float32 else 1e-2)
    assert torch.equal(got[..., 0, :], x[..., 0, :].double())
    want = ref.rope(x, ref.rope_angles(cfg.grid, cfg.rope_grid,
                                       cfg.head_dim))
    assert rel(got, want) < 1e-14
    a = eva.rope_angles(cfg)
    p, j = 5, 3
    x0, x1 = x[0, 1, 1 + p, 2 * j].double(), x[0, 1, 1 + p, 2 * j + 1].double()
    t = a[p, j]
    assert got[0, 1, 1 + p, 2 * j].item() == pytest.approx(
        (x0 * torch.cos(t) - x1 * torch.sin(t)).item(), rel=1e-12)
    assert got[0, 1, 1 + p, 2 * j + 1].item() == pytest.approx(
        (x1 * torch.cos(t) + x0 * torch.sin(t)).item(), rel=1e-12)
    pairs = got[..., 1:, :].unflatten(-1, (-1, 2)).norm(dim=-1)
    assert torch.allclose(pairs, x[..., 1:, :].double().unflatten(
        -1, (-1, 2)).norm(dim=-1), rtol=1e-12)


# ---------------------------------------------------------------------------
# The raw model
# ---------------------------------------------------------------------------

def test_timm_keys_map_onto_the_fused_sites(loaded):
    """q, k, v stack into one qkv (k's bias 0) and gate, value into one
    fc1, gate first; timm's fused layout (qkv with q_bias / v_bias) and the
    module's own keys load to the same model."""
    spec, sd, model = loaded
    D, H = spec.cfg.dim, spec.cfg.mlp_hidden
    a, m = model.blocks[1].attn, model.blocks[1].mlp
    assert a.qkv.weight.shape == (3 * D, D) and m.fc1.weight.shape == (2 * H, D)
    assert torch.equal(a.qkv.weight[D:2 * D], sd["blocks.1.attn.k_proj.weight"])
    assert torch.equal(a.qkv.bias[D:2 * D], torch.zeros(D))
    assert torch.equal(a.qkv.bias[2 * D:], sd["blocks.1.attn.v_proj.bias"])
    assert torch.equal(m.fc1.weight[:H], sd["blocks.1.mlp.fc1_g.weight"])
    assert torch.equal(m.fc1.bias[H:], sd["blocks.1.mlp.fc1_x.bias"])
    fused = {k: v for k, v in sd.items() if "_proj" not in k}
    for i in range(spec.cfg.depth):
        p = f"blocks.{i}.attn"
        fused[f"{p}.qkv.weight"] = torch.cat(
            [sd[f"{p}.{n}_proj.weight"] for n in "qkv"])
        fused[f"{p}.q_bias"] = sd[f"{p}.q_proj.bias"]
        fused[f"{p}.v_bias"] = sd[f"{p}.v_proj.bias"]
    from adalog_tpu_torch.models.load import load_state_dict
    for other in (fused, model.state_dict()):
        again = load_state_dict(spec, other)
        for k, v in model.state_dict().items():
            assert torch.equal(again.state_dict()[k], v), k


def test_raw_forward_matches_reference(loaded):
    """The port's fp32 forward of test_tiny_eva, loaded from timm's keys,
    within 1e-5 relative of the float64 reference: fp32 rounding over two
    blocks of width 32 is about 1e-7."""
    spec, sd, model = loaded
    x = images(4, spec.cfg, 1)
    with torch.no_grad():
        got = zoo.model_forward_fn(spec)(spec.cfg, model, x)
    want = ref.forward(sd, ref_cfg(spec.cfg), x)
    assert rel(got, want) < 1e-5
    for i in range(4):
        assert rel(got[i], want[i]) < 1e-5


# ---------------------------------------------------------------------------
# The quantized model
# ---------------------------------------------------------------------------

def small_cfg():
    cfg = load_config("configs/4bit.py")
    cfg.eq_n, cfg.steps, cfg.search_round = 32, 2, 1
    return cfg


@pytest.fixture(scope="module")
def calibrated(loaded):
    """One FPCS calibration of test_tiny_eva at W4A4 (small search)."""
    spec, _, model = loaded
    calib = QuantCalibrator(spec, model, small_cfg(), device="cpu")
    calib.calibrate([images(8, spec.cfg, 2).numpy()])
    params, qstate = calib.finish_calibration()
    return spec, calib, params, qstate


def plan_of(qstate):
    """The reference's plain-dict plan from the port's quantizer state."""
    plan = {}
    for name, s in qstate.items():
        if isinstance(s, MatMulSite):
            d = {"B_scale": s.Bq.scale.reshape(-1),
                 "B_zp": s.Bq.zero_point.reshape(-1), "bits": s.Bq.bits}
            if s.Aq.kind == "adalog":
                d.update(log_q=s.Aq.log_q, s_bits=s.Aq.bits)
            else:
                d.update(A_scale=s.Aq.scale.reshape(-1),
                         A_zp=s.Aq.zero_point.reshape(-1))
            plan[name] = d
        else:
            plan[name] = {"w_scale": s.wq.scale.reshape(-1),
                          "w_zp": s.wq.zero_point.reshape(-1),
                          "w_bits": s.wq.bits}
            if isinstance(s, LinearSite):
                plan[name].update(a_scale=s.aq.scale.reshape(-1),
                                  a_zp=s.aq.zero_point.reshape(-1),
                                  a_bits=s.aq.bits)
    return plan


def test_calibration_step(calibrated):
    """One calibration through QuantCalibrator: every site of the layout
    searched; qkv and fc1 folded into their LayerNorms; fc2 uniform."""
    spec, calib, params, qstate = calibrated
    assert set(qstate) == set(calib.layout)
    assert {"capture", "linear", "matmul", "matmul_post", "conv",
            "reparam"} <= set(calib.seconds)
    assert "postgelu" not in calib.seconds
    for i in range(spec.cfg.depth):
        assert qstate[f"blocks.{i}.mlp.fc2"].aq.kind == "uniform"
        assert qstate[f"blocks.{i}.attn.matmul2"].Aq.kind == "adalog"
        assert calib.layout[f"blocks.{i}.attn.qkv"].kind == "linear_reparam"
        assert calib.layout[f"blocks.{i}.mlp.fc1"].kind == "linear_reparam"
    for name, site in qstate.items():
        if isinstance(site, LinearSite):
            assert site.aq.scale.numel() == 1, name


def test_block_reconstruction_steps(calibrated):
    """BRECQ's units of the family (``recon.blocks``): the patch embedding,
    each block and the head, reconstructed a few steps each on the CPU,
    give a state of the same sites whose forward stays finite."""
    from adalog_tpu_torch.recon.blocks import block_units
    from adalog_tpu_torch.recon.brecq import BlockReconstructor

    spec, calib, params, qstate = calibrated
    assert [u.name for u in block_units(spec)] == \
        ["patch_embed", "blocks.0", "blocks.1", "head"]
    cfg = small_cfg()
    cfg.recon_iters, cfg.optim_batch_size = 3, 4
    recon = BlockReconstructor(spec, params, params, qstate, calib.layout,
                               cfg, device="cpu")
    p2, q2 = recon.reconstruct([images(8, spec.cfg, 6).numpy()])
    assert set(q2) == set(qstate)
    with torch.no_grad():
        y = eva.eva_forward(spec.cfg, p2, images(2, spec.cfg, 7), q2,
                            {"*": "quant"})
    assert bool(torch.isfinite(y).all())


def test_quantized_sites_match_reference(calibrated):
    """Each quantized site of the port's forward, from the program's own
    input to it, against the reference's site (the same float32 codes,
    then float64): Linear and convolution outputs within 1e-5 relative
    (fp32 sums of at most 192 terms), matmul1 within 1e-5 (exact integer
    codes, fp32 sums of 16), matmul2 within 1e-5 (the same AdaLog codes of
    the program's own probabilities); the glue between sites (RoPE between
    qkv and matmul1, SiLU gate and sub-LN between fc1 and fc2, the pooled
    head input) within 1e-5 (fp32 elementwise work)."""
    spec, _, params, qstate = calibrated
    cfg, plan = spec.cfg, plan_of(qstate)
    x = images(3, cfg, 4)
    with torch.no_grad():
        _, taps = eva.eva_forward(cfg, params, x, qstate, {"*": "quant"},
                                  capture=True, capture_blocks=True)
    conv = params.patch_embed.proj
    xi, yi = taps["patch_embed.proj"]
    assert rel(yi, ref.patch_conv(xi, conv.weight, conv.bias, cfg.patch_size,
                                  plan["patch_embed.proj"])) < 1e-5
    angles = ref.rope_angles(cfg.grid, cfg.rope_grid, cfg.head_dim)
    H, hd = cfg.heads, cfg.head_dim
    for i, bp in enumerate(params.blocks):
        p = f"blocks.{i}"
        for nm, mod in (("attn.qkv", bp.attn.qkv), ("attn.proj", bp.attn.proj),
                        ("mlp.fc1", bp.mlp.fc1), ("mlp.fc2", bp.mlp.fc2)):
            xs, ys = taps[f"{p}.{nm}"]
            assert rel(ys, ref.linear(xs, mod.weight, mod.bias,
                                      plan[f"{p}.{nm}"])) < 1e-5, nm
        q, kT, a = taps[f"{p}.attn.matmul1"]
        assert rel(a, ref.matmul1(q, kT, plan[f"{p}.attn.matmul1"])) < 1e-5
        pr, v, o = taps[f"{p}.attn.matmul2"]
        assert rel(o, ref.matmul2(pr, v, plan[f"{p}.attn.matmul2"])) < 1e-5
        qkv = taps[f"{p}.attn.qkv"][1]
        B, N, _ = qkv.shape
        rq, rk, rv = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        assert rel(q, ref.rope(rq, angles)) < 1e-5
        assert rel(kT, ref.rope(rk, angles).transpose(-2, -1)) < 1e-5
        assert torch.equal(q[..., 0, :], rq[..., 0, :])
        assert rel(v, rv) == 0.0
        m = torch.nn.functional.layer_norm(
            ref.glu(taps[f"{p}.mlp.fc1"][1]), (cfg.mlp_hidden,),
            bp.mlp.norm.weight.double(), bp.mlp.norm.bias.double(), ref.EPS)
        assert rel(taps[f"{p}.mlp.fc2"][0], m) < 1e-5
    pooled, logits = taps["head"]
    want = torch.nn.functional.layer_norm(
        taps[f"blocks.{cfg.depth - 1}"][1].double()[:, 1:].mean(1),
        (cfg.dim,), params.fc_norm.weight.double(),
        params.fc_norm.bias.double(), ref.EPS)
    assert rel(pooled, want) < 1e-5
    assert rel(logits, ref.linear(pooled, params.head.weight, params.head.bias,
                                  plan["head"])) < 1e-5


def test_layout_and_initial_state():
    """fc2 is a uniform site (its input is a LayerNorm's), no post-GeLU
    site, one site over q | k | v (n_V 3) and one over gate | value (n_V 2),
    each with one per-tensor activation quantizer."""
    spec, model = zoo.build_model(TINY, seed=0)
    cfg = Config()
    layout = quant_layout(spec, cfg)
    kinds = {ss.kind for ss in layout.values()}
    assert not kinds & {"postgelu", "postgelu_twin"}
    assert len(layout) == 2 + 6 * spec.cfg.depth
    qs = init_qstate(spec, cfg, model)
    assert set(qs) == set(layout)
    D, H = spec.cfg.dim, spec.cfg.mlp_hidden
    for i in range(spec.cfg.depth):
        p = f"blocks.{i}"
        assert layout[f"{p}.mlp.fc2"].kind == "linear"
        assert layout[f"{p}.attn.qkv"].n_V == 3
        assert layout[f"{p}.mlp.fc1"].n_V == 2
        assert qs[f"{p}.mlp.fc2"].aq.kind == "uniform"
        assert qs[f"{p}.attn.qkv"].wq.scale.shape == (3, D, 1)
        assert qs[f"{p}.mlp.fc1"].wq.scale.shape == (2, H, 1)
        for nm in ("attn.qkv", "mlp.fc1"):
            assert qs[f"{p}.{nm}"].aq.scale.shape == (1,)
    assert not any(k.endswith(("q_proj", "k_proj", "v_proj", "fc1_g",
                               "fc1_x")) for k in layout)


def test_int8_table_covers_every_linear_site(calibrated):
    """The plan with int8 on routes every Linear site of the family (qkv,
    proj, fc1, fc2 of each block and the head) to int8 with its codes, and
    the int8 path serves the same logits as the fake-quant path to 1e-5."""
    from adalog_tpu_torch.serve import make_predictor

    spec, _, params, qstate = calibrated
    cfg = small_cfg()
    plan = routes.build(spec, params, qstate, cfg, use_int8=True)
    table = {n for n, r in plan.linear.items()
             if r.kind == "int8" and r.int8.w_int.dtype == torch.int8}
    linear = {n for n, s in qstate.items() if isinstance(s, LinearSite)}
    assert table == linear and len(linear) == 4 * spec.cfg.depth + 1
    x = images(2, spec.cfg, 5).numpy()
    fq = make_predictor(spec, params, qstate, cfg=cfg, device="cpu")(x)
    i8 = make_predictor(spec, params, qstate, cfg=cfg, device="cpu",
                        use_int8=True)(x)
    assert rel(i8, fq) < 1e-5
