"""The port's checkpoint formats beyond v2 against adalog_tpu on the CPU:
``checkpoint_name``, the JAX package's round-1 pickles (read through a
restricted unpickler that maps the JAX dataclass names onto the port's by
string), and the reference's flat state dicts (utils/ref_checkpoint.py) in
both directions, for test_tiny and test_tiny_swin.

States: one small W4A4 calibration by the port (eq_n 32, steps 2, one
round, LayerNorm reparam, folded post-GeLU bias), carried to the JAX
package's dataclasses through a v2 checkpoint. Loaded qstates are held
equal leaf by leaf, bit for bit, to what the other package loads from the
same file; quantized logits to LOGIT_TOL (the two packages' GEMMs sum in
other orders; measured max |diff| 4.5e-8 on logits of about 0.2).
"""

import dataclasses
import functools
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adalog_tpu.models import zoo as j_zoo
from adalog_tpu.utils import checkpoint as j_checkpoint
from adalog_tpu.utils import ref_checkpoint as j_ref
from adalog_tpu.utils.config import Config as JConfig
from adalog_tpu.utils.config import load_config as j_load_config
from adalog_tpu_torch.calib.calibrator import QuantCalibrator
from adalog_tpu_torch.models import zoo
from adalog_tpu_torch.serve import load_quantized, make_predictor
from adalog_tpu_torch.utils import checkpoint
from adalog_tpu_torch.utils import ref_checkpoint as ref
from adalog_tpu_torch.utils.config import Config, load_config
from adalog_tpu_torch.utils.interop import from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 2e-5
SMALL = dict(w_bit=4, a_bit=4, s_bit=4, qhead_a_bit=4, eq_n=32, steps=2,
             search_round=1)
MODELS = ["test_tiny", "test_tiny_swin"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, n=8):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    spec = j_zoo.model_spec(name)
    fwd = j_zoo.model_forward_fn(spec)
    return jax.jit(lambda p, x, q: fwd(spec.cfg, p, x, q, {"*": "quant"}))


def _jax_logits(name, params, qstate, x):
    return np.asarray(_jax_forward(name)(params, jnp.asarray(x), qstate))


def _port_logits(name, model, qstate, x):
    spec = zoo.model_spec(name)
    with torch.no_grad():
        return zoo.model_forward_fn(spec)(
            spec.cfg, model, torch.from_numpy(x), qstate,
            {"*": "quant"}).numpy()


@pytest.fixture(scope="module")
def port_states():
    """{model: (model, qstate)} of a port calibration on the CPU."""
    out = {}
    for name in MODELS:
        spec, model = zoo.build_model(name, seed=0)
        calib = QuantCalibrator(spec, model, Config(**SMALL), device="cpu")
        calib.calibrate([_images(2)])
        out[name] = calib.finish_calibration()
    return out


@pytest.fixture(scope="module")
def jax_states(port_states, tmp_path_factory):
    """{model: (params, qstate)}: the port's states as the JAX package's
    dataclasses with numpy leaves, carried by a v2 checkpoint (a JAX
    calibration would cost a minute here)."""
    out = {}
    for name in MODELS:
        path = str(tmp_path_factory.mktemp("v2") / f"{name}.ckpt")
        checkpoint.save_checkpoint(path, *port_states[name])
        params, qstate, _ = j_checkpoint.load_checkpoint(path)
        out[name] = (_np_tree(params), _np_tree(qstate))
    return out


def _leaves(site, prefix=""):
    if dataclasses.is_dataclass(site):
        for f in dataclasses.fields(site):
            yield from _leaves(getattr(site, f.name), prefix + f.name + ".")
    else:
        yield prefix[:-1], site


def assert_qstate_equal(port_q, jax_q):
    """Every site and field, bit for bit (numbers, shapes, flags)."""
    assert sorted(port_q) == sorted(jax_q)
    for name in jax_q:
        got, want = dict(_leaves(port_q[name])), dict(_leaves(jax_q[name]))
        assert got.keys() == want.keys(), name
        for k, w in want.items():
            g = got[k]
            if w is None or isinstance(w, (str, bool, int, float)):
                assert g == w, (name, k, g, w)
                continue
            assert isinstance(g, torch.Tensor), (name, k)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name}.{k}")
            assert g.shape == np.shape(w), (name, k)


# ---------------------------------------------------------------------------
# checkpoint_name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", ["3bit", "4bit", "6bit"])
@pytest.mark.parametrize("mode", ["calibrate", "optimize"])
def test_checkpoint_name_matches_jax(bits, mode):
    path = os.path.join(ROOT, "configs", f"{bits}.py")
    got = checkpoint.checkpoint_name("deit_small", load_config(path), mode)
    assert got == j_checkpoint.checkpoint_name("deit_small",
                                               j_load_config(path), mode)
    assert got.startswith(f"deit_small_w{bits[0]}_a{bits[0]}_s{bits[0]}_")


# ---------------------------------------------------------------------------
# round-1 pickles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_round1_pickle_loads_to_jax_qstate(name, jax_states, tmp_path):
    params, qstate = jax_states[name]
    path = str(tmp_path / "legacy.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"version": 1, "params": params, "qstate": qstate,
                     "meta": {"run": 1}}, f)
    model, q, meta = checkpoint.load_checkpoint(path,
                                                zoo.model_spec(name).cfg)
    assert meta == {"run": 1}
    jp, jq, _ = j_checkpoint.load_checkpoint(path)
    assert_qstate_equal(q, _np_tree(jq))
    ref_model, ref_q = from_jax(zoo.model_spec(name).cfg, params, qstate)
    for k, v in ref_model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    x = _images(3)
    np.testing.assert_allclose(_port_logits(name, model, q, x),
                               _jax_logits(name, jp, jq, x),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _gadget_pickle(path, target, args):
    class Gadget:
        def __reduce__(self):
            return (target, args)

    with open(path, "wb") as f:
        pickle.dump({"params": Gadget(), "qstate": {}, "meta": {}}, f)


def _jax_package_function():
    from adalog_tpu.models.layers import qlinear
    return qlinear


@pytest.mark.parametrize("target", ["os.system", "load_config", "qlinear",
                                    "eval"])
def test_poisoned_pickle_rejected(target, tmp_path):
    """Any global outside numpy, the builtins containers and the JAX
    package's dataclass names raises, the JAX package's own callables (a
    config loader that executes a file, a function of a whitelisted module)
    included."""
    fn = {"os.system": os.system, "load_config": j_load_config,
          "qlinear": _jax_package_function(), "eval": eval}[target]
    path = str(tmp_path / "evil.ckpt")
    _gadget_pickle(path, fn, ("echo pwned",))
    with pytest.raises(pickle.UnpicklingError, match="forbidden global"):
        checkpoint.load_checkpoint(path, zoo.model_spec("test_tiny").cfg)


# ---------------------------------------------------------------------------
# reference-format state dicts
# ---------------------------------------------------------------------------

def _torch_save(sd, path):
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, path)


@pytest.mark.parametrize("name", MODELS)
def test_export_matches_jax_export(name, jax_states):
    """The same state exported by both packages: the same keys (the port's
    module carries no key the JAX export lacks) and equal arrays."""
    params, qstate = jax_states[name]
    spec = zoo.model_spec(name)
    model, q = from_jax(spec.cfg, params, qstate)
    got = ref.export_reference_state_dict(spec, Config(**SMALL), model, q)
    want = j_ref.export_reference_state_dict(j_zoo.model_spec(name),
                                             JConfig(**SMALL), params, qstate)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_jax_pth_loads_in_port(name, jax_states, tmp_path):
    params, qstate = jax_states[name]
    sd = j_ref.export_reference_state_dict(j_zoo.model_spec(name),
                                           JConfig(**SMALL), params, qstate)
    path = str(tmp_path / "ref.pth")
    _torch_save(sd, path)
    spec = zoo.model_spec(name)
    model, q = ref.load_reference_checkpoint(spec, Config(**SMALL), path)
    jp, jq = j_ref.load_reference_checkpoint(j_zoo.model_spec(name),
                                             JConfig(**SMALL), path)
    assert_qstate_equal(q, _np_tree(jq))
    x = _images(4)
    np.testing.assert_allclose(_port_logits(name, model, q, x),
                               _jax_logits(name, jp, jq, x),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_port_pth_loads_in_jax(name, port_states, tmp_path):
    model, qstate = port_states[name]
    spec = zoo.model_spec(name)
    path = str(tmp_path / "ref.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                ref.export_reference_state_dict(
                    spec, Config(**SMALL), model, qstate).items()}, path)
    jp, jq = j_ref.load_reference_checkpoint(j_zoo.model_spec(name),
                                             JConfig(**SMALL), path)
    m2, q2 = ref.load_reference_checkpoint(spec, Config(**SMALL), path)
    assert_qstate_equal(q2, _np_tree(jq))
    x = _images(5)
    want = _port_logits(name, model, qstate, x)
    np.testing.assert_array_equal(_port_logits(name, m2, q2, x), want)
    np.testing.assert_allclose(_jax_logits(name, jp, jq, x), want,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_quantizer_only_dict_overlays_site_weights(jax_states, tmp_path):
    """A dict without the backbone: each site's weights in it replace the
    base model's, as the JAX package's loader does."""
    name = "test_tiny"
    params, qstate = jax_states[name]
    sd = j_ref.export_reference_state_dict(j_zoo.model_spec(name),
                                           JConfig(**SMALL), params, qstate)
    sd = {k: v for k, v in sd.items()
          if "quantizer" in k or k.startswith("blocks.")}
    sd.pop("patch_embed.proj.weight", None)
    path = str(tmp_path / "ref.npz")
    np.savez(path, **sd)
    spec = zoo.model_spec(name)
    base = from_jax(spec.cfg, params)[0]
    model, q = ref.load_reference_checkpoint(spec, Config(**SMALL), path,
                                             zoo.build_model(name, seed=3)[1])
    jp, jq = j_ref.load_reference_checkpoint(
        j_zoo.model_spec(name), JConfig(**SMALL), path,
        j_zoo.build_model(name, seed=3)[1])
    assert_qstate_equal(q, _np_tree(jq))
    for i in range(spec.cfg.depth):
        for site in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            key = f"blocks.{i}.{site}.weight"
            np.testing.assert_array_equal(model.state_dict()[key].numpy(),
                                          base.state_dict()[key].numpy())
    # the patch embedding kept the base model's own (no weight in the dict)
    assert not torch.equal(model.patch_embed.proj.weight,
                           base.patch_embed.proj.weight)


@pytest.mark.parametrize("name", MODELS)
def test_load_quantized_reads_pth(name, port_states, tmp_path):
    model, qstate = port_states[name]
    spec = zoo.model_spec(name)
    path = str(tmp_path / "ref.pth")
    _torch_save(ref.export_reference_state_dict(spec, Config(**SMALL), model,
                                                qstate), path)
    predict, spec2, m2, q2 = load_quantized(name, path, device="cpu",
                                            config=Config(**SMALL))
    x = _images(6)
    want = make_predictor(spec, model, qstate, cfg=Config(**SMALL),
                          device="cpu")(x)
    assert torch.equal(predict(x), want)
