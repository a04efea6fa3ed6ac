"""Readings that the limits of ``correct`` are set from: for each seed, the
numbers that ``check`` compares for the program, and the same numbers for
the control, the reference computed in float32 with TF32 products put in
the program's place. Both are judged against the float64 reference on the
same images. No window is timed: each seed builds the cell's state, serves
``check_batches`` batches through the same ``predict`` at the cell's
batch, and compares them.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 [--out f]

Prints one JSON line a seed, and the largest program reading and the
smallest control reading over the seeds last.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def read_seed(cell, seed, device):
    """{'program': numbers, 'control': numbers, 'worst': the program's
    five widest gaps by site, 'control_worst': the control's, 'tied': the
    largest share of query rows that an attention site leaves out} of one
    seed."""
    import gc

    import torch

    from portbench import check, serving

    arch, tr = cell["arch"], cell["traffic"]
    weights, plan, images, predict = serving.prepare(arch, tr, seed, device)
    checked = []
    for i in range(tr["check_batches"]):
        bi = i % len(images)
        y = predict(images[bi]).cpu()
        rows = check.sample_rows(seed, i, y.shape[0], tr["check_images"])
        checked.append((bi, y, rows, serving.served_again(
            predict, images[bi], arch, rows)))
    del predict
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found, gaps = serving.judge_batches(arch, weights, plan, images,
                                        checked)
    ctrl, ctrl_gaps = serving.judge_batches(
        arch, weights, plan, images, checked, dtype=torch.float32, tf32=True)

    def worst(g):
        return sorted(([f"{s}:{k}", max(v)] for (s, k), v in g.items()
                       if k != "tied"), key=lambda kv: -kv[1])[:5]

    return {"program": found, "control": ctrl, "worst": worst(gaps),
            "control_worst": worst(ctrl_gaps),
            "tied": max(max(v) for (s, k), v in gaps.items() if k == "tied")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--out", help="also append the lines to this file")
    args = ap.parse_args(argv)

    import torch

    from portbench import cell as cells

    if not torch.cuda.is_available():
        print("readings: torch finds no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    device = torch.device("cuda:0")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        row = dict(workload=args.workload, seed=seed,
                   **read_seed(cell, seed, device))
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    names = rows[0]["program"].keys()
    print(json.dumps({
        "workload": args.workload, "seeds": len(rows),
        "program_max": {n: max(r["program"][n] for r in rows)
                        for n in names},
        "control_min": {n: min(r["control"][n] for r in rows)
                        for n in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
