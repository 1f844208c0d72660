"""Run one cell of the benchmark of the PyTorch port (``llava_reward_torch``)
on the CUDA devices of this machine:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads`` in BENCHMARK.json) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``); the mix names the driver that runs
it (``benchmark/harness/drivers/<driver>.py``). With ``--trace 0`` the last
line of standard output carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``benchmark/metrics/<metric>.py``: a
reader, and the spans and work counter it needs), read from a profiled part
of the window. Either way the run checks what the
timed path produced against the plain reference (``benchmark/reference``)
and prints each number compared beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import common  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)  # cpu: tests only
    p.add_argument("--root", default=common.ROOT, help=argparse.SUPPRESS)  # tests only
    args = p.parse_args(argv)

    common.set_environment()
    bench = common.load_benchmark(args.root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"benchmark: no workload {args.workload!r}; the cells are {sorted(cells)}",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if args.device == "cuda":
        common.device_or_exit(cell["chips"])
        print(f"card: {common.power_line()}", flush=True)  # shares are of the 700 W peaks
    cfg = common.load_json("configs", cell["config"], args.root)
    traffic = dict(common.load_json("traffic", cell["traffic"], args.root), name=cell["traffic"])
    limits = common.load_json("limits", cell["name"], args.root)

    import importlib

    layer_metrics = []
    if args.trace:
        layer_metrics = [(m, common.load_metric(m["name"], args.root))
                         for m in common.metrics_for(bench, cell["name"], "per_layer")]
    driver = importlib.import_module(f"benchmark.harness.drivers.{traffic['driver']}")
    out = driver.run(cfg, traffic, limits, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=args.device, t_start=T_START,
                     span_entries=common.metric_spans(mod for _, mod in layer_metrics))

    bad = common.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}; the port must not import JAX or the "
              "JAX package", file=sys.stderr)
        return 4

    if args.trace:
        metrics = {}
        for m, mod in layer_metrics:
            v = common.read_layer_metric(mod, out["layer_data"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device = dict(out["device"], busy_s=out["layer_data"]["trace"]["busy_s"],
                      window_s=out["layer_data"]["trace"]["window_s"])
        breakdown = {k: out["layer_data"]["trace"][k] for k in ("device_ops", "idle_gaps")}
    else:
        wanted = common.metrics_for(bench, cell["name"], "end_to_end")
        missing = [m["name"] for m in wanted if m["name"] not in out["metrics"]]
        if missing:
            print(f"benchmark: the driver gave no {missing}", file=sys.stderr)
            return 5
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in wanted}
        device, breakdown = out["device"], None
    common.emit(out["correct"], out["attempted"], out["failed"], metrics, device,
                out["checks"], breakdown, out.get("gaps"))
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the batcher thread of a serving cell blocks for ever on its queue:
    # leave without the interpreter's teardown, which may print after the
    # check lines that have to end standard error
    os._exit(rc)
