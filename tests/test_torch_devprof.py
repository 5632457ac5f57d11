"""The port's device profiler (parallel_eda_tpu_torch/obs/devprof.py) on
the CPU: CUDA-event milliseconds per kernel and dispatch variant, the
route.devcost.* gauges and the stats_dir devprof.json, with the JAX
package's note/dedup/dominant rules and its file's keys (its XLA cost
numbers have no counterpart).

A CPU tensor has no CUDA event, so the capture arithmetic is driven here
with stand-in events (``_Event``: elapsed_time in ms, as
torch.cuda.Event's); the card's events are checked by
tests/test_torch_kernels_gpu.py and chip_smoke.py."""

import json

import pytest
import torch

from parallel_eda_tpu_torch import obs as TOBS
from parallel_eda_tpu_torch.flow import synth_flow
from parallel_eda_tpu_torch.obs.devprof import CPU_UNAVAILABLE, DevProfiler
from parallel_eda_tpu_torch.route import router as TR
from test_torch_route import FIXTURE


@pytest.fixture(autouse=True)
def _clean_obs():
    old = TOBS.get_metrics(), TOBS.get_devprof()
    TOBS.set_metrics(TOBS.MetricsRegistry())
    TOBS.set_devprof(DevProfiler())
    yield
    TOBS.set_metrics(old[0])
    TOBS.set_devprof(old[1])


class _Event:
    """Stands in for a recorded torch.cuda.Event pair's end."""

    def __init__(self, t):
        self.t = t
        self.waited = False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        return end.t - self.t


def _fake_launch(p, name, ms):
    rec = p._pending[p._current]
    rec["events"].append((name, _Event(0.0), _Event(ms)))
    return rec["events"][-1][2]


def test_disabled_profiler_is_noop():
    p = DevProfiler()
    assert p.note_variant(("k",), {"nets": 1}) is False
    with p.launch("planes_relax_full_cuda", torch.device("cpu")):
        pass
    p.note_cpu_call()
    assert p.capture_all() == []
    assert p.summary() == {"unavailable": "no dispatch variants captured"}


def test_note_dedup_and_capture_reads_events_only_at_capture(tmp_path):
    """A variant noted twice is one record; every launch after a note is
    attributed to it; events are waited for at capture_all, not before;
    per-kernel launches and milliseconds, the gauges, the file."""
    p = DevProfiler(enabled=True)
    meta = {"variant": "planes_relax_full_cuda/mode2", "nets": 32,
            "bytes_per_sweep": 4096, "plane_dtype": "f32"}
    assert p.note_variant(("w", 1), meta) is True
    ends = [_fake_launch(p, "planes_relax_full_cuda", 0.25)]
    assert p.note_variant(("w", 1), meta) is False
    ends.append(_fake_launch(p, "planes_relax_full_cuda", 0.5))
    ends.append(_fake_launch(p, "planes_relax_cropped_cuda", 0.125))
    assert not any(e.waited for e in ends)
    recs = p.capture_all()
    assert all(e.waited for e in ends)
    assert len(recs) == 1
    r = recs[0]
    assert r["key"] == ["w", 1] and r["meta"] == meta
    assert r["kernels"]["planes_relax_full_cuda"] == {
        "launches": 2, "ms": 0.75, "ms_per_launch": 0.375}
    assert r["kernels"]["planes_relax_cropped_cuda"]["launches"] == 1
    assert r["launches"] == 3 and r["device_ms"] == 0.875
    v = TOBS.get_metrics().values("route.devcost.")
    assert v == {"route.devcost.variants": 1,
                 "route.devcost.device_ms": 0.875,
                 "route.devcost.launches": 3}
    p.dump(str(tmp_path / "devprof.json"))
    doc = json.loads((tmp_path / "devprof.json").read_text())
    assert set(doc) == {"delta_band_log10", "records", "summary"}
    assert doc["summary"]["measured_variants"] == 1
    assert doc["summary"]["modeled_bytes_per_sweep"] == 4096
    assert p.capture_all() == recs        # idempotent between notes


def test_cpu_tensors_are_unavailable():
    """Relaxations of a noted variant on CPU tensors leave the record
    "unavailable" with its reason (nothing runs in the kernel's
    place); a variant with no launch says so."""
    p = DevProfiler(enabled=True)
    p.note_variant(("cpu",), {"nets": 4})
    with p.launch("planes_relax_full_cuda", torch.device("cpu")):
        pass
    p.note_cpu_call()
    p.note_variant(("none",), {"nets": 8})
    recs = p.capture_all()
    assert recs[0]["unavailable"] == CPU_UNAVAILABLE
    assert recs[1]["unavailable"] == "no kernel launches recorded"
    s = p.summary()
    assert s == {"unavailable": CPU_UNAVAILABLE, "variants": 2}


def test_dominant_variant_rule():
    """summary() and the gauges quote the measured variant covering the
    most nets, as the JAX package's (and the route.kernel.* gauges')
    dominant rule."""
    p = DevProfiler(enabled=True)
    p.note_variant(("small",), {"nets": 4, "bytes_per_sweep": 1024})
    _fake_launch(p, "planes_relax_full_cuda", 1.0)
    p.note_variant(("big",), {"nets": 64, "bytes_per_sweep": 65536})
    _fake_launch(p, "planes_relax_full_cuda", 2.0)
    _fake_launch(p, "planes_relax_full_cuda", 2.0)
    p.note_variant(("cpu",), {"nets": 128})
    p.note_cpu_call()
    p.capture_all()
    s = p.summary()
    assert s["variants"] == 3 and s["measured_variants"] == 2
    assert s["modeled_bytes_per_sweep"] == 65536
    assert s["device_ms"] == 4.0 and s["launches"] == 2
    assert TOBS.get_metrics().values("route.devcost.")[
        "route.devcost.device_ms"] == 4.0


def test_route_integration_writes_devprof_ledger(tmp_path):
    """A stats_dir route turns the profiler on for the route (and back
    off after it) and writes devprof.json with the JAX package's keys: one record per per-rung dispatch variant
    (JAX's key, (tile, K, nsweeps, L, waves, group)) with the planner's
    modelled row under JAX's field names, and on CPU tensors each record
    "unavailable".  (tests/test_torch_cli.py holds the file's variant set
    equal to the JAX CLI's.)"""
    tf = synth_flow(**FIXTURE)
    res = TR.Router(tf.rr, TR.RouterOpts(
        batch_size=32, stats_dir=str(tmp_path)),
        device="cpu").route(tf.term)
    assert res.success and not TOBS.get_devprof().enabled
    doc = json.loads((tmp_path / "devprof.json").read_text())
    assert set(doc) == {"delta_band_log10", "records", "summary"}
    keys = [json.dumps(r["key"]) for r in doc["records"]]
    assert keys and len(set(keys)) == len(keys)
    for r in doc["records"]:
        assert len(r["key"]) == 6
        assert r["unavailable"] == CPU_UNAVAILABLE
        assert set(r["meta"]) == {"variant", "block_nets", "lane_occupancy",
                                  "bytes_per_sweep", "tile", "nets",
                                  "nsweeps", "plane_dtype"}
        assert r["meta"]["variant"].startswith("planes_relax_full_cuda/")
    v = TOBS.get_metrics().values("route.devcost.")
    assert v == {"route.devcost.variants": len(doc["records"])}
