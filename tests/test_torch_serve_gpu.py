"""Continuous batching and the program library on a CUDA card.

    python -m pytest --noconftest -m gpu tests/test_torch_serve_gpu.py

Imports nothing of JAX (tests/conftest.py does, hence ``--noconftest``
on a machine without it).  Without a card every test skips; the
decision is taken inside the ``cuda`` fixture, never at import.

* two jobs through ``RouteService(fused=True)`` on the card equal their
  solo card routes, with multi calls made;
* ``serve --fused`` processes over one program library and compile
  cache: an exporting process, then a fresh one that builds nothing
  (``compile_seconds() == 0``, no nvcc process) and counts no new
  dispatch variant, with the same jobs;
* a truncated copy of libplanes_relax in the library, with a fresh
  compile cache: evicted before it is loaded and rebuilt from source,
  with the same jobs.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

pytestmark = pytest.mark.gpu

# runs the port's CLI and prints, after its own line, the build seconds,
# the nvcc processes started and the files the libraries were loaded from
CHILD = """\
import json, os, subprocess, sys
from parallel_eda_tpu_torch.__main__ import main
from parallel_eda_tpu_torch.obs import compile_seconds
from parallel_eda_tpu_torch.route import cuda_lib
nvcc = []
_init = subprocess.Popen.__init__
def init(self, args, *a, **k):
    if os.path.basename(str(args[0])) == "nvcc":
        nvcc.append(str(args[1]))
    _init(self, args, *a, **k)
subprocess.Popen.__init__ = init
rc = main(sys.argv[1:])
print(json.dumps({"rc": rc, "compile_s": compile_seconds(), "nvcc": nvcc,
                  "loaded": [l.loaded_path for l in cuda_lib.LOADED]}))
"""
SERVE = ["serve", "--fused", "--jobs", "2", "--luts", "10", "--slice", "3"]


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _child(*args):
    r = subprocess.run([sys.executable, "-c", CHILD, *SERVE, *args],
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


def _jobs(line):
    return [{k: v for k, v in j.items() if k not in ("route_s",
                                                      "nets_per_s")}
            for j in line["jobs"]]


def test_gpu_fused_service_equals_solo(cuda):
    from parallel_eda_tpu_torch import obs
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts
    from parallel_eda_tpu_torch.serve.service import (RouteService,
                                                      ServeJobSpec)

    flows = [synth_flow(num_luts=10, seed=s) for s in (1, 2)]
    rr = flows[0].rr
    opts = RouterOpts(batch_size=32, sink_group=0)
    solo = [Router(rr, opts, device=cuda).route(f.term) for f in flows]
    reg = obs.set_metrics(obs.MetricsRegistry(enabled=True))
    svc = RouteService(rr, opts, slice_iters=2, fused=True, device=cuda)
    for i, f in enumerate(flows):
        svc.admit(ServeJobSpec(term=f.term, name=f"j{i}"))
    for job, ref in zip(svc.run(), solo):
        res = job.result["result"]
        assert job.state.value == "done"
        assert np.array_equal(res.paths, ref.paths)
        assert (res.wirelength, res.iterations) == (ref.wirelength,
                                                    ref.iterations)
    assert reg.values()["route.serve.fused.dispatches"] > 0


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = tmp_path_factory.mktemp("serve_gpu")
    lib, cc = str(d / "L"), str(d / "C")
    first = _child("--library", lib, "--compile_cache_dir", cc,
                   "--export_library")
    return d, lib, cc, first


def test_gpu_warm_library_builds_nothing(cuda, exported):
    d, lib, cc, (first, c1) = exported
    assert first["library_exported"] > 0 and c1["compile_s"] > 0
    second, c2 = _child("--library", lib, "--compile_cache_dir", cc)
    assert c2["compile_s"] == 0 and c2["nvcc"] == []
    assert second["dispatch_compiles"] == 0
    assert second["serve"]["route.serve.aot_hits"] > 0
    assert _jobs(second) == _jobs(first)


def test_gpu_corrupt_so_evicted_before_load(cuda, exported):
    d, lib, cc, (first, _) = exported
    with open(os.path.join(lib, "library.json")) as f:
        so = json.load(f)["libs"]["planes_relax"]
    path = os.path.join(lib, so["file"])
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    third, c3 = _child("--library", lib, "--compile_cache_dir",
                       str(d / "C3"))
    assert c3["compile_s"] > 0 and c3["nvcc"]
    assert not any(p.startswith(lib) for p in c3["loaded"])
    assert third["serve"]["route.serve.aot_errors"] >= 1
    assert _jobs(third) == _jobs(first)
    with open(os.path.join(lib, "library.json")) as f:
        assert "planes_relax" not in json.load(f)["libs"]
