"""Finding a cell's parts by name: everything here is read from files, so a
configuration, a traffic mix, a cell or a per-layer metric is added by
adding a file (and its entry in BENCHMARK.json), never by editing code.

  BENCHMARK.json                 the cells, their configuration and traffic
                                 names, and the metrics each reports
  portbench/configs/<config>.json   the model's sizes and quantization
  portbench/families/<family>.py    what the benchmark knows of the
                                 configuration's model family
                                 (``family``)
  portbench/traffic/<traffic>.json  the mix: the generator that reads it
                                 ("generator", a module of portbench)
                                 and its parameters
  portbench/limits/<cell>.json      the limits of the numbers compared
  portbench/metrics/<metric>.py     one reader per per-layer metric
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


def load(workload, root=ROOT):
    """The cell named ``workload``: {'name', 'workload' (its BENCHMARK.json
    entry), 'arch', 'traffic', 'limits', 'end_to_end', 'per_layer'}, the
    last two the BENCHMARK.json entries of the metrics the cell reports.
    'arch' is the configuration's file with the root it was found under
    ('root'), where its family module is looked up; a family that has no
    module raises here."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"choices: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    arch = dict(_json(os.path.join(root, configs[w["config"]]["file"])),
                root=root)
    family_of(arch)
    base = os.path.join(root, "portbench")
    traffic = _json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    limits_path = os.path.join(base, "limits", f"{workload}.json")
    limits = _json(limits_path) if os.path.exists(limits_path) else None
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"name": workload, "workload": w, "arch": arch,
            "traffic": traffic, "limits": limits, "end_to_end": e2e,
            "per_layer": layer, "root": root}


def reader(name, root=ROOT):
    """The module of ``portbench/metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_FAMILIES = {}


def family(name, root=ROOT):
    """The module of ``portbench/families/<name>.py`` under ``root``, loaded
    once a file. A family module imports torch, the standard library and
    ``portbench.reference``, nothing of the program, and holds everything
    the benchmark knows of one model family:

      embed, units(arch), head   the reference's stages (``reference``)
      leaves(arch), sites(arch)  the parameters in draw order, and the
                                 quantization sites in forward order
                                 (``state``); plan_<kind>(site, quant,
                                 ranges, generator) fills the plan of a
                                 site kind of its own
      linear_shapes(arch, batch), attention_calls(arch, batch)
                                 the shapes that ``counts`` reads
      PROGRAM_MODULE, MODEL_CLASS, PROGRAM_KEYS, SEAMS, UNIT_SEAMS
                                 the program's names, as plain data
                                 (``program``)
      TINY                       the sizes of its CPU stand-in (tests)
    """
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"family {name!r}: not a module name")
    path = os.path.join(root, "portbench", "families", f"{name}.py")
    if path not in _FAMILIES:
        if not os.path.exists(path):
            raise FileNotFoundError(f"family {name!r}: no module {path}")
        spec = importlib.util.spec_from_file_location(
            f"portbench_family_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _FAMILIES[path] = mod
    return _FAMILIES[path]


def family_of(arch):
    """The family module of a configuration: under the root ``load`` found
    it in, or this checkout's for a configuration read otherwise."""
    return family(arch["family"], arch.get("root", ROOT))
