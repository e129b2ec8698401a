"""The readings a cell's correctness limits are set from, on the card at
the cell's own size, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] \
        [--lrs 1,16,256 --lr-seed 1] [--out FILE]

For each of ``--seeds``, the program's checked steps (the window's own
call, :func:`benchmark.drivers.train.checked_steps`) against the plain
reference: the numbers of a sound run. For each of ``--control-seeds``,
the reference in fp8 put in the program's place (the control). For each
of ``--fault-seeds``, the program with each fault of
:mod:`benchmark.faults` planted. With ``--lrs``, one sound step of
``--lr-seed`` at each of those SGD rates, to show how ``update_gap``
follows the rate. One JSON line a reading, with
:func:`benchmark.check.census` of the states after one step, on standard
output and appended to ``--out``. The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
import time


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--lrs", default="")
    p.add_argument("--lr-seed", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import check, faults
    from benchmark.drivers import train as drv
    from benchmark.registry import Registry
    from benchmark.run import cache_env

    reg = Registry()
    cell = reg.workload(args.workload)
    cache_env(reg.root)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    m = drv.model_fields(reg.config(cell["config"]))
    traffic = reg.traffic(cell["traffic"])
    control = set(_seeds(args.control_seeds))
    faulty = set(_seeds(args.fault_seeds))

    def program(seed, traffic=traffic):
        model, weights = drv.build(m, seed, dev)
        mine = drv.checked_steps(model, weights,
                                 drv.Batches(m, traffic, seed, dev),
                                 traffic)
        del model, weights
        drv.free()
        return mine

    def emit(kind, seed, mine, ref, t0, lr=traffic["lr"]):
        initial = drv.make_weights(m, seed, dev)
        line = {"workload": args.workload, "kind": kind, "seed": seed,
                "lr": lr, "numbers": check.compare(mine, ref, dev),
                "census": check.census(mine, ref, initial, dev),
                "leaves": check.leaves(mine, ref),
                "losses": mine["losses"], "ref_losses": ref["losses"],
                "seconds": time.time() - t0}
        del initial
        drv.free()
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")

    sound = _seeds(args.seeds)
    for seed in sound + sorted((control | faulty) - set(sound)):
        t0 = time.time()
        ref = drv.reference_readings(m, traffic, seed, dev)
        if seed in sound:
            emit("sound", seed, program(seed), ref, t0)
        if seed in control:
            t0 = time.time()
            emit("control_fp8", seed, drv.reference_readings(
                m, traffic, seed, dev, quant="fp8"), ref, t0)
        for name in faults.FAULTS if seed in faulty else ():
            t0 = time.time()
            with faults.planted(name):
                mine = program(seed)
            emit(f"fault_{name}", seed, mine, ref, t0)
    for lr in (float(x) for x in args.lrs.split(",") if x):
        t0 = time.time()
        one = dict(traffic, lr=lr, checked_steps=1)
        ref = drv.reference_readings(m, one, args.lr_seed, dev)
        emit("lr_sweep", args.lr_seed, program(args.lr_seed, one), ref, t0,
             lr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
