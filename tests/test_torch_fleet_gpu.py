"""The fleet and the serial QoR oracle with the port's routes on a CUDA
card.

    python -m pytest --noconftest -m gpu tests/test_torch_fleet_gpu.py

Imports nothing of JAX (tests/conftest.py does, hence ``--noconftest``
on a machine without it).  Without a card every test skips; the
decision is taken inside the ``cuda`` fixture, never at import.

* a solo card ``daemon run`` over two 6-LUT jobs exports a program
  library; then ``daemon fleet --workers 2`` on the card over that
  library, with a fresh ``--cache_base`` (so no worker's first slice
  stalls on an nvcc build), under ``transport.drop:1,worker.kill:1``:
  every job released once with the solo run's wirelength and
  iterations, one worker killed, a job failed over;
* ``qor_compare`` on the card equals it on the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

pytestmark = pytest.mark.gpu

JOBS = (("fjA", "t0", 3), ("fjB", "t1", 4))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cli(*args, timeout=900):
    r = subprocess.run([sys.executable, "-m", "parallel_eda_tpu_torch",
                        "daemon", *args], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _jobs(doc):
    return {j["job_id"]: (j["state"], j.get("wirelength"),
                          j.get("iterations"))
            for j in doc["jobs"] if j["state"] == "done"}


def test_gpu_fleet_worker_kill_equals_solo(cuda, tmp_path):
    from parallel_eda_tpu_torch.serve.daemon import submit_job
    from parallel_eda_tpu_torch.serve.transport import TransportClient

    lib = str(tmp_path / "L")
    solo = str(tmp_path / "solo")
    for jid, tenant, seed in JOBS:
        submit_job(solo, {"luts": 6, "chan_width": 16, "seed": seed,
                          "name": f"l6_s{seed}"}, tenant=tenant,
                   job_id=jid)
    ref = _cli("run", "--inbox", solo, "--luts", "6", "--slice", "2",
               "--exit_when_idle", "2", "--library", lib,
               "--compile_cache_dir", str(tmp_path / "C"),
               "--export_library")
    assert len(_jobs(ref)) == len(JOBS)

    box = str(tmp_path / "box")
    p = subprocess.Popen(
        [sys.executable, "-m", "parallel_eda_tpu_torch", "daemon", "fleet",
         "--inbox", box, "--workers", "2", "--luts", "6", "--slice", "2",
         "--library", lib, "--cache_base", str(tmp_path / "fresh"),
         "--expect_jobs", str(len(JOBS)), "--tick_s", "0.05",
         "--chaos", "transport.drop:1,worker.kill:1", "--timeout_s", "600",
         "--summary", str(tmp_path / "fleet.json")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        url = os.path.join(box, "transport.json")
        deadline = time.time() + 120
        while not os.path.exists(url):
            assert p.poll() is None and time.time() < deadline
            time.sleep(0.05)
        with open(url) as f:
            cl = TransportClient(json.load(f)["url"], max_attempts=4)
        for jid, tenant, seed in JOBS:
            cl.submit({"luts": 6, "chan_width": 16, "seed": seed,
                       "name": f"l6_s{seed}"}, tenant=tenant, job_id=jid)
        out, err = p.communicate(timeout=700)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, err[-3000:]
    doc = json.loads(out.strip().splitlines()[-1])
    fl = doc["fleet"]
    assert _jobs(doc) == _jobs(ref)
    assert len([j for j in doc["jobs"] if j["state"] == "done"]) == \
        len(JOBS)
    assert all(v["released"] for v in fl["leases"].values())
    assert fl["metrics"]["route.fleet.workers_killed"] == 1
    assert fl["metrics"]["route.fleet.jobs_failed_over"] >= 1
    assert fl["transport"]["drops"] == 1 and fl["transport"]["retries"] == 1


def test_gpu_qor_compare_equals_cpu(cuda):
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.route import qor_compare
    from parallel_eda_tpu_torch.route.router import RouterOpts

    fix = dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
               seed=3)
    rows = [dataclasses.asdict(qor_compare(
        synth_flow(**fix), "fix15", RouterOpts(batch_size=32), device=d))
        for d in ("cuda", "cpu")]
    assert rows[0] == rows[1]
