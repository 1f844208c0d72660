"""Readings that set a cell's limits, many seeds in one process:

    python3 -m benchmark.harness.control --workload <name> --seeds 1,2,3 [--seconds 8]

Each seed runs the cell as the benchmark does (a short window at the cell's
own load and sizes) and prints one ``reading`` line: the compared numbers of
the program (the lower readings) and of its control on the same sampled
rows, against the same reference and yardstick (the upper readings). The
control is the plain reference with every op rounded to bfloat16 and its
weight products one precision below what the cell states (the traffic
file's ``control``: fp8 for a bf16 cell, int4 weights and activations for a
W8A8 one). ``--extra '{"name": {"bf16": "int4"}}'`` reads more controls on
the same rows. None of this is part of a benchmark run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time


def main(argv=None) -> int:
    from . import common

    common.set_environment()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--extra", default="{}", help="more controls: name -> schemes, JSON")
    args = p.parse_args(argv)
    bench = common.load_benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = common.load_json("configs", cell["config"])
    traffic = dict(common.load_json("traffic", cell["traffic"]), name=cell["traffic"])
    limits = common.load_json("limits", cell["name"])
    driver = importlib.import_module(f"benchmark.harness.drivers.{traffic['driver']}")
    controls = dict(control=traffic["control"], **json.loads(args.extra))
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        try:
            out = driver.run(cfg, traffic, limits, seed=seed, seconds=args.seconds, trace=False,
                             device=args.device, t_start=t, controls=controls)
            line = {"seed": seed, "correct": out["correct"], "gaps": out["gaps"],
                    "controls": out["control_gaps"], "checks": out["checks"],
                    "metrics": out["metrics"], "seconds": time.perf_counter() - t}
        except Exception as e:  # a control that crashes has failed
            line = {"seed": seed, "error": repr(e)}
        print("reading " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
