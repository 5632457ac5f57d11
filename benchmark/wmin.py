"""The least routable channel width of each configuration, on the card.

    python3 benchmark/wmin.py [--out DIR] [config ...]

For each configuration (default: every file in configs/ that has no
``w_min`` yet) the port's ``flow.binary_search_route`` searches, on the
card and congestion-driven, over the placement that the benchmark's
route cells give the pool's job 0, starting from the
architecture's default width.  Every attempt (width, legal or not,
iterations, seconds) is written to the configuration's ``w_search`` file,
and ``w_min`` into the configuration itself; with ``--out`` both are
also copied into DIR.
"""

import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, ROOT)


def search(name: str, out_dir=None) -> dict:
    import harness
    import torch

    from parallel_eda_tpu_torch import flow as flow_mod

    path = os.path.join(BENCH_DIR, "configs", name + ".json")
    with open(path) as f:
        cfg = json.load(f)
    fe = harness.FrontEnd(cfg, 40)
    flow = fe.flow
    flow.pos = fe.place_native(harness.job_seed(0))
    flow.term = fe.terminals(flow.pos)
    attempts = []
    inner = flow_mod.run_route

    def recorded(f, *a, **kw):
        t0 = time.perf_counter()
        out = inner(f, *a, **kw)
        torch.cuda.synchronize()
        attempts.append({"W": int(f.rr.chan_width),
                         "legal": bool(f.route.success),
                         "iterations": int(f.route.iterations),
                         "wirelength": int(f.route.wirelength),
                         "seconds": time.perf_counter() - t0})
        print(f"wmin {name}: {attempts[-1]}", flush=True)
        return out

    flow_mod.run_route = recorded
    try:
        w = flow_mod.binary_search_route(flow, timing_driven=False,
                                         device="cuda")
    finally:
        flow_mod.run_route = inner
    doc = {"config": name, "w_min": w, "card": torch.cuda.get_device_name(0),
           "placement": "the pool's job 0",
           "attempts": attempts}
    cfg["w_min"] = w
    targets = [(os.path.join(ROOT, cfg["w_search"]), doc), (path, cfg)]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        targets += [(os.path.join(out_dir, name + ".wsweep.json"), doc),
                    (os.path.join(out_dir, name + ".json"), cfg)]
    for target, body in targets:
        with open(target, "w") as f:
            json.dump(body, f, indent=1)
            f.write("\n")
    return doc


def main(argv) -> int:
    import argparse

    import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("configs", nargs="*")
    args = ap.parse_args(argv)
    harness.build_program(True)
    names = args.configs or sorted(
        n[:-5] for n in os.listdir(os.path.join(BENCH_DIR, "configs"))
        if n.endswith(".json") and not n.endswith(".wsweep.json")
        and json.load(open(os.path.join(BENCH_DIR, "configs", n)))
        .get("w_min") is None)
    for name in names:
        doc = search(name, args.out)
        print(f"wmin {name}: W_min {doc['w_min']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
