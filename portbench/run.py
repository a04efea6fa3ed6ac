"""The benchmark of adalog_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for. The cell, its configuration and traffic are found by name
(``portbench/cell.py``). With ``--trace 0`` the result reports the cell's
end-to-end metrics; with ``--trace 1`` a profiled stretch after the window
gives its per-layer metrics and the device's busy and window seconds. The
last line of standard output is the result, one JSON object; the numbers
that decided ``correct`` are the last lines of standard error, each beside
its limit.

Exits non-zero, printing no result, where torch finds fewer CUDA devices
than the cell needs, and where ``jax``, ``jaxlib``, ``flax`` or the JAX
package (``adalog_tpu``) has been imported by the time the window closes.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# transformers, where present, would load flax without this
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "adalog_tpu")


def forbidden_modules(modules=None):
    """Names in ``sys.modules`` whose whole top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def layer_metrics(cell, ctx):
    """{name: {"value", "unit"}} of the cell's per-layer metrics that found
    something to read."""
    from portbench import cell as cells

    out = {}
    for m in cell["per_layer"]:
        v = cells.reader(m["name"], cell["root"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def execute(cell, seed, seconds, trace, device, wrap=None):
    """Run the cell on ``device``; returns the result object (without the
    forbidden-module check, which ``main`` makes)."""
    import torch

    gen = importlib.import_module("portbench." + cell["traffic"]["generator"])
    e2e, ctx, found, attempted, failed, peak, summary = gen.run(
        cell, seed, seconds, trace, device, STARTED, wrap=wrap)
    from portbench import check

    if cell["limits"] is None:
        raise SystemExit(f"portbench: no limits file for {cell['name']}")
    correct, compared = check.judge(found, cell["limits"])
    correct = correct and failed == 0
    if trace:
        metrics = layer_metrics(cell, ctx)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["workload"]["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["check"] = compared
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_main = time.perf_counter()

    import torch

    from portbench import cell as cells

    cell = cells.load(args.workload)
    print(f"setup: interpreter and modules {t_main - STARTED:.2f} s, torch "
          f"{time.perf_counter() - t_main:.2f} s", file=sys.stderr)
    need = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {need} CUDA device(s); "
              f"torch finds {n}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, args.trace,
                     torch.device("cuda:0"))
    print(f"portbench: card {card_line()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules imported: {bad}",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result, out=None, err=None):
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=err or sys.stderr)
    print(json.dumps(result), file=out or sys.stdout)


if __name__ == "__main__":
    sys.exit(main())
