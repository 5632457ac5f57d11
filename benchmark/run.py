"""Run one cell of the benchmark of ``parallel_eda_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The cells, configurations and metrics are BENCHMARK.json's;
harness.py runs the cell, ref/ decides ``correct``, metrics/ reads the
metrics.  The last line of standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device`` (and,
traced, ``breakdown``), whose last key ``checks`` gives each compared
number beside its limit; the same numbers end standard error.  Without
the cards, or with JAX loaded once the window has closed, it prints no
result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, ROOT)
# kernel caches at fixed paths inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "parallel_eda_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_line() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    return (f"host: cards [{smi}], cpus {os.cpu_count()}, usable "
            f"{len(os.sched_getaffinity(0))}")


def result(run, checks: dict) -> dict:
    """The result line of a finished run and its verdict."""
    import harness
    import torch

    entries = run.cell.per_layer if run.trace else run.cell.end_to_end
    metrics = {}
    for m in entries:
        v = harness.read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    outs = run.window
    failed = sum(not o.success for o in outs)
    correct = all(v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": (torch.cuda.get_device_name(0) if run.cuda
                    else "cpu"),
           "count": run.cell.chips,
           "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": bool(correct), "attempted": len(outs),
           "failed": failed, "metrics": metrics, "device": dev}
    if run.trace and run.profile is not None:
        tr = run.profile
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        spans = [(o.t0, o.t1, "route job, outside route.window")
                 for o in outs]
        if run.tracer is not None:
            t0 = run.tracer.t0
            # route.iter spans share a window's time evenly and
            # route.kernel spans last no time: neither says where the
            # host was
            spans += [(t0 + e["ts"] * 1e-6, t0 + (e["ts"] + e["dur"]) * 1e-6,
                       e["name"]) for e in run.tracer.events
                      if e.get("ph") == "X"
                      and e["name"] not in ("route.iter", "route.kernel")]
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.idle_gaps(spans, 10)}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import parallel_eda_tpu_torch  # noqa: F401  (the program under test)

    run = harness.CellRun(cell, args.seed, args.seconds, bool(args.trace),
                          device="cuda:0", t_start=T_START)
    run.execute()
    found = forbidden_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 4
    run.free_program_state()
    checks = harness.verdict(run)
    out = result(run, checks)
    info = (f"{host_line()}; build_s {run.build_s}; window_s "
            f"{run.window_s}; relaxation calls {run.spy.calls}, kernel "
            f"launches {run.spy.launched}; job seconds "
            f"{[round(o.t1 - o.t0, 3) for o in run.window]}")
    print(info)
    print(info, file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
