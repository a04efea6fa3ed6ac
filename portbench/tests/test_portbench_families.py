"""The model families (``portbench/families/<family>.py``) give the
benchmark exactly what it read before they were split out of its shared
modules: the weights, plan, images, sites, shapes, operation counts and
float64 reference logits of each family's tiny stand-in, and the sites,
parameters and shapes of the real configurations, are pinned by digest
(the first 32 hex digits of a sha256 over raw bytes) as the shared
modules gave them before the split. A family module imports nothing of
the program, and a site kind of a family's own reaches its plan
function."""

import ast
import hashlib
import json
import os
import shutil
import struct

import pytest
import torch

from conftest import ROOT
from portbench import cell as cells, counts, reference, state

SEED = 2147496000
PINNED = {
    "tiny:deit_small_w4a4": {
        "leaves": "a5e95ec0f70c302e17223c4f0c93e1c2",
        "sites": "8ab27eba7f00ea7018633e3e501573c9",
        "linear_shapes": "13abad5f18c800959083245c9d82d890",
        "attention_calls": "187905fd354e3f58f26899b987711a97",
        "forward_flops": "8bebe221be8ccadfd1c82b80e16ff40a",
        "weights": "485a5f66d973e96ddfaaf372f54c254c",
        "plan": "244d909acb0cb74ff8dfb5703ead9df0",
        "images": "a6d9791126fc9fbf80a56044f53295ca",
        "raw_logits": "4defff55c23222fda898e7a5205943f2",
        "logits": "27bd3ab4e713560b07cb0ef5c3e5da67",
    },
    "tiny:swin_base_w4a4": {
        "leaves": "8523d4f2f36f37ef66511595cfe0f0a5",
        "sites": "cef474b601e09957f883c0baa05e7117",
        "linear_shapes": "5f92a94abb84c885f6ecc27504862ddb",
        "attention_calls": "f1ed858fe16827bd8d34feff5d21b3f7",
        "forward_flops": "903576018f9ab91427cfb06f5c7c3447",
        "weights": "8a312481895c6fadf3ad54b8b1fb176f",
        "plan": "318999dfb2ad2206c466318f67419a5d",
        "images": "a6d9791126fc9fbf80a56044f53295ca",
        "raw_logits": "c06039a347fbca6988b42dfbdd28de62",
        "logits": "e55fe662172b26622571570582fdfcaa",
    },
    "deit_small_w4a4": {
        "leaves": "37d2eb052e2605f94b9797a16a2a1ebb",
        "sites": "bedc1c61482117a8fc578f0bf0c0974a",
        "linear_shapes": "76f2df453337d767270bf7f9f3ec7773",
        "attention_calls": "76eec4622685b30af2ac152e8a44d5f6",
        "forward_flops": "56a7761facc3c1f9925598bba85ac70b",
    },
    "swin_base_w4a4": {
        "leaves": "9ba2e9f82c9b0b5b05b70c6f64a59ab3",
        "sites": "b350d79ca3f3ee025a423219e13963e2",
        "linear_shapes": "38b03631a5eee5d96b3b131646e44707",
        "attention_calls": "ce46d3fbbe3eb2cc84eb9360c13c3f81",
        "forward_flops": "844e445662b65f3c77c483c543f2cab0",
    },
}


def _feed(h, obj):
    if torch.is_tensor(obj):
        t = obj.detach().cpu().contiguous()
        h.update(f"T{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())
    elif isinstance(obj, dict):
        h.update(b"{")
        for k, v in obj.items():
            _feed(h, k)
            _feed(h, v)
        h.update(b"}")
    elif isinstance(obj, (list, tuple)):
        h.update(b"[")
        for v in obj:
            _feed(h, v)
        h.update(b"]")
    elif isinstance(obj, float):
        h.update(b"f" + struct.pack("<d", obj))
    else:
        h.update(repr(obj).encode())


def digest(obj):
    h = hashlib.sha256()
    _feed(h, obj)
    return h.hexdigest()[:32]


def shapes(arch):
    return {"leaves": digest(state.leaves(arch)),
            "sites": digest(state.sites(arch)),
            "linear_shapes": digest(counts.linear_shapes(arch, 200)),
            "attention_calls": digest(counts.attention_calls(arch, 200)),
            "forward_flops": digest(counts.forward_flops(arch))}


@pytest.fixture
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.mark.parametrize("config", ["deit_small_w4a4", "swin_base_w4a4"])
def test_stand_in_unchanged(tiny_root, one_thread, config):
    root, names = tiny_root
    arch = cells.load(names[f"{config}.serve_b200"], root)["arch"]
    cpu = torch.device("cpu")
    w = state.make_weights(arch, SEED, cpu)
    calib = state.make_images(arch, SEED, 1, 8, cpu, salt=1)[0]
    plan = state.make_plan(arch, w, calib, SEED)
    images = state.make_images(arch, SEED, 2, 4, cpu)
    got = shapes(arch)
    got.update(weights=digest(w), plan=digest(plan), images=digest(images),
               raw_logits=digest(reference.forward(arch, w, None,
                                                   images[0])),
               logits=digest(reference.forward(arch, w, plan, images[0])))
    assert got == PINNED[f"tiny:{config}"]


@pytest.mark.parametrize("config", ["deit_small_w4a4", "swin_base_w4a4"])
def test_configuration_unchanged(config):
    arch = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                       f"{config}.json")))
    assert shapes(arch) == PINNED[config]


FAMILIES = sorted(f for f in os.listdir(os.path.join(
    ROOT, "portbench", "families")) if f.endswith(".py"))


@pytest.mark.parametrize("name", FAMILIES)
def test_family_imports(name):
    """torch, the standard library's functools and math, and the shared
    reference: nothing of the program, of JAX, or of another family."""
    tree = ast.parse(open(os.path.join(ROOT, "portbench", "families",
                                       name)).read())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            found.add(node.module)
    assert found <= {"__future__", "functools", "math", "torch",
                     "portbench", "portbench.reference"}, found


PLANNED = """

_sites = sites


def sites(arch):
    return [(n, "head_own" if k == "head" else k, w)
            for n, k, w in _sites(arch)]


def plan_head_own(s, quant, ranges, generator):
    s["a_bits"] = quant["qhead_a_bit"]
    s["ranges"] = sorted(ranges)
"""


@pytest.mark.parametrize("planned", [True, False])
def test_family_site_kind(tiny_root, planned):
    """A family that gives its head a kind of its own fills that site's
    plan with its plan_<kind>; without one, make_plan raises naming it."""
    root, names = tiny_root
    fam = os.path.join(root, "portbench", "families")
    shutil.copy(os.path.join(fam, "vit.py"), os.path.join(fam, "vit_own.py"))
    with open(os.path.join(fam, "vit_own.py"), "a") as f:
        f.write(PLANNED if planned else PLANNED.split("\n\n\ndef plan")[0])
    arch = dict(cells.load(names["deit_small_w4a4.serve_b200"],
                           root)["arch"], family="vit_own")
    cpu = torch.device("cpu")
    w = state.make_weights(arch, 3, cpu)
    calib = state.make_images(arch, 3, 1, 4, cpu, salt=1)[0]
    if not planned:
        with pytest.raises(AttributeError, match="plan_head_own"):
            state.make_plan(arch, w, calib, 3)
        return
    plan = state.make_plan(arch, w, calib, 3)
    assert plan["head"]["ranges"] == ["x"]
    assert plan["head"]["a_bits"] == arch["quant"]["qhead_a_bit"]
    assert set(plan["head"]) == {"w_scale", "w_zp", "a_bits", "ranges"}
