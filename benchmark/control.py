"""The control of the comparison that decides ``correct``, on the card.

    python3 benchmark/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--program]

runs the cell once per seed, in this one process, with the program's own
reduced-precision path switched on (``RouterOpts(plane_dtype="bf16",
dtype_guard="off")``: the relaxation planes in bfloat16, the step below
the configuration's float32), and with ``--program`` also as it is; each
run prints one JSON line with its seed, its mode, ``correct`` and every
compared number.  The control has to read not correct.  The benchmark's
own runs do not run it.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))

CONTROL_OPTS = {"plane_dtype": "bf16", "dtype_guard": "off"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)

    import harness
    import torch

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 3
    modes = (["program"] if args.program else []) + ["control"]
    for seed in args.seeds:
        for mode in modes:
            cell = harness.load_cell(args.workload)
            if mode == "control":
                cell.traffic = dict(cell.traffic, router_opts=dict(
                    cell.traffic.get("router_opts", {}), **CONTROL_OPTS))
            run = harness.CellRun(cell, seed, args.seconds, False,
                                  device="cuda:0",
                                  t_start=time.perf_counter())
            run.execute()
            run.free_program_state()
            checks = harness.verdict(run)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "mode": mode,
                "correct": all(v <= lim for v, lim in checks.values()),
                "routes": len(run.window),
                "checks": {k: v for k, (v, _) in checks.items()}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
