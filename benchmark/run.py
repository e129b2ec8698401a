"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``python3 -m benchmark.run`` works too).
With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window. The last line of standard output
is one JSON object; the numbers the check compared, each beside its
limit, are the last lines of standard error and the result's last key.
Exits 2, printing no result, without enough CUDA devices; 3 when JAX or
the JAX package is loaded once the result line is built, the per-layer
readers loaded with it.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    # run as a file: the checkout's root on the path, not this folder
    _here = os.path.dirname(os.path.abspath(__file__))
    if sys.path and os.path.abspath(sys.path[0]) == _here:
        sys.path.pop(0)
    sys.path.insert(0, os.path.dirname(_here))

BANNED = ("jax", "jaxlib", "flax", "brpc_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of BANNED, compared
    whole (``brpc_tpu_torch`` is not ``brpc_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port's own kernels build into ``build/brpc_tpu_torch`` there."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(torch, chips: int, peak: int, trace) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": peak}
    if trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["window_s"]
    return out


def result_line(reg, cell: str, run: dict, trace: bool, device: dict,
                traffic: dict) -> dict:
    """The contract's result object from a driver's run."""
    metrics = {}
    if not trace:
        for m in reg.end_to_end(cell):
            metrics[m["name"]] = {"value": run["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = {"trace": run["trace"], "steps": run["steps"],
               "model": run["model"], "traffic": traffic}
        for m in reg.per_layer(cell):
            value = reg.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(run["correct"]), "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics, "device": device}
    if trace:
        out["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                            "idle_gaps": run["trace"]["idle_gaps"]}
    out["checks"] = run["check"]
    return out


def report(reg, cell: str, run: dict, trace: bool, device: dict,
           traffic: dict) -> int:
    """Print the run's result line, the numbers compared last on standard
    error; 3, printing no result, when JAX or the JAX package is loaded by
    then (the per-layer readers load as the line is built)."""
    out = result_line(reg, cell, run, trace, device, traffic)
    print(f"window losses every {traffic.get('loss_every')} steps: "
          f"{run.get('logged')}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    found = banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.registry import Registry

    reg = Registry()
    cell = reg.workload(args.workload)
    cache_env(reg.root)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    driver = reg.driver(traffic["kind"])
    run = driver.run(config, traffic, reg.limits(args.workload),
                     args.seed, args.seconds, bool(args.trace), T_START,
                     torch.device("cuda", 0))
    device = device_info(torch, cell["chips"], run["memory_peak_bytes"],
                         run["trace"])
    return report(reg, args.workload, run, bool(args.trace), device,
                  traffic)


if __name__ == "__main__":
    sys.exit(main())
