"""The port's program library (parallel_eda_tpu_torch/serve/library.py),
the Router's ``program_library_dir`` / ``compile_cache_dir`` and the
compile cache of the built CUDA libraries (route/cuda_lib.py), on the
CPU (the card's cases: tests/test_torch_serve_gpu.py).

* ``key_id``, ``LIBRARY_SCHEMA`` and the index name are JAX's: one
  variant key has one id in both packages (keys mixing tuples, lists,
  numpy scalars, None and bools);
* the warm round trip, in fresh processes (``python -m
  parallel_eda_tpu_torch serve --device cpu --library L``): an
  exporting process, then a warm one that counts
  ``route.dispatch.compiles == 0`` and only library hits, with the
  exporting process's jobs (exact, seconds aside), interleaved and
  ``--fused``; a torn entry is dropped at load and not pre-registered;
  ``library.corrupt`` evicts the entry it hits (on disk too) and
  degrades to the same routes; a provenance mismatch refuses the whole
  library with its reason;
* the compile cache against a stand-in nvcc on PATH (a script that
  writes a fake library and logs each call; there is no nvcc here): a
  cold process builds into a temporary name and installs it with its
  sha256 record; a warm one starts no nvcc at all (``nvcc --version``
  included) and books no build; a torn cached file, or a torn copy the
  library offers, is evicted before anything loads it and rebuilt from
  source; a failed build leaves nothing under the final name; the key
  follows the source text and the compute capability, not the mtime.
"""

import json
import os
import stat
import subprocess
import sys

import numpy as np
import pytest

from parallel_eda_tpu.serve import library as JL
from parallel_eda_tpu_torch.flow import synth_flow
from parallel_eda_tpu_torch.obs import trace as TT
from parallel_eda_tpu_torch.route import cuda_lib
from parallel_eda_tpu_torch.route import router as TR
from parallel_eda_tpu_torch.serve import library as TL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = ["serve", "--device", "cpu", "--jobs", "2", "--luts", "10",
         "--slice", "3"]
TIMED_JOB = ("route_s", "nets_per_s")


# ---- key ids and the index ------------------------------------------------

@pytest.mark.parametrize("key", [
    ("fused", ((None, 7, 2, 32, False),), 4, 64, ((32, 9),), True, False,
     False, False, 18, 3, 2416, "f32"),
    ((4, 4), np.int64(3), np.int32(9), 64, 2, 16, True, np.int64(32),
     np.int64(5), True, False, False, False, 40, 4, 9000, "bf16"),
    ["multi", [(None, 1), [np.float32(0.5), None]], ("x", (np.int16(2),))],
    (None,), (), (True, 1, False, 0),
])
def test_key_id_matches_jax(key):
    """The same id, and the same canonical form, in both packages; a key
    read back from library.json (tuples as lists) keeps its id."""
    assert TL.key_id(key) == JL.key_id(key)
    assert TL._tupled(key) == JL._tupled(key)
    back = json.loads(json.dumps(TL._tupled(key)))
    assert TL.key_id(back) == TL.key_id(key) == JL.key_id(back)


def test_index_constants_match_jax():
    assert (TL.INDEX_NAME, TL.LIBRARY_SCHEMA) == (JL.INDEX_NAME,
                                                  JL.LIBRARY_SCHEMA)


# ---- the warm round trip in fresh processes --------------------------------

def _serve(args):
    r = subprocess.run([sys.executable, "-m", "parallel_eda_tpu_torch",
                        *SERVE, *args], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _jobs(line):
    return [{k: v for k, v in j.items() if k not in TIMED_JOB}
            for j in line["jobs"]]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Per mode, an exporting process, then a warm one, over the same
    library: mode -> (mode, library dir, mode flags, cold line, warm
    line)."""
    out = {}
    for mode in ("interleaved", "fused"):
        flags = ["--fused"] if mode == "fused" else []
        lib = str(tmp_path_factory.mktemp("lib") / "L")
        cold = _serve(["--library", lib, "--export_library", *flags])
        hot = _serve(["--library", lib, *flags])
        out[mode] = (mode, lib, flags, cold, hot)
    return out


@pytest.fixture
def warm(libs):
    """The fused library (its entries hold the multi keys and the solo
    windows' keys)."""
    return libs["fused"]


@pytest.mark.parametrize("mode", ["interleaved", "fused"])
def test_warm_process_dispatches_no_new_variant(mode, libs):
    """The warm process: no new dispatch variant, every dispatch a
    library hit, no fallback, the exporting process's jobs."""
    mode, lib, _, cold, hot = libs[mode]
    s = hot["serve"]
    assert cold["library_exported"] > 0
    assert cold["dispatch_compiles"] == cold["library_exported"]
    assert hot["dispatch_compiles"] == 0
    assert s["route.serve.aot_hits"] > 0
    assert s.get("route.serve.jit_fallbacks", 0) == 0
    assert s.get("route.serve.aot_errors", 0) == 0
    assert s["route.serve.library_variants"] == cold["library_exported"]
    assert s["route.serve.library_stale"] == 0
    assert hot["library_exported"] == 0
    assert _jobs(hot) == _jobs(cold)
    if mode == "fused":
        with open(os.path.join(lib, TL.INDEX_NAME)) as f:
            keys = [e["key"] for e in json.load(f)["entries"].values()]
        assert any(k[0] == "multi" for k in keys)
        assert hot["rebatch"]["counters"]["route.serve.fused.dispatches"] > 0


def test_torn_entry_dropped_and_not_preregistered(warm, tmp_path):
    """A truncated entry blob: load drops it (aot_errors) and does not
    pre-register its key, so its variant counts one compile; the rest
    stay hits and the routes are unchanged."""
    import shutil

    _, lib, mode, cold, _ = warm
    lib2 = str(tmp_path / "L")
    shutil.copytree(lib, lib2)
    with open(os.path.join(lib2, TL.INDEX_NAME)) as f:
        idx = json.load(f)
    kid, meta = sorted(idx["entries"].items())[0]
    path = os.path.join(lib2, meta["file"])
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    line = _serve(["--library", lib2, *mode])
    s = line["serve"]
    assert line["dispatch_compiles"] == 1
    assert s["route.serve.aot_errors"] == 1
    assert s["route.serve.jit_fallbacks"] >= 1
    assert s["route.serve.library_variants"] == len(idx["entries"]) - 1
    assert _jobs(line) == _jobs(cold)


def test_library_corrupt_site_evicts_entry(warm, tmp_path):
    """``--chaos library.corrupt`` firing at the first library dispatch:
    the entry is evicted (from library.json on disk too), the dispatch
    runs the same window function without the library, and the routes
    are unchanged."""
    import shutil

    _, lib, mode, cold, _ = warm
    lib2 = str(tmp_path / "L")
    shutil.copytree(lib, lib2)
    with open(os.path.join(lib2, TL.INDEX_NAME)) as f:
        before = set(json.load(f)["entries"])
    line = _serve(["--library", lib2, "--chaos", "library.corrupt:1:1",
                   *mode])
    s = line["serve"]
    assert s["route.serve.aot_errors"] == 1
    assert s["route.serve.library_evictions"] == 1
    assert s["route.serve.jit_fallbacks"] >= 1
    assert line["resil"]["faults"]["fired"] == {"library.corrupt": [0]}
    with open(os.path.join(lib2, TL.INDEX_NAME)) as f:
        after = set(json.load(f)["entries"])
    assert len(before - after) == 1 and after <= before
    assert _jobs(line) == _jobs(cold)


@pytest.mark.parametrize("field,value", [
    ("torch", "0.0.0"), ("csrc", {"planes_relax.cu": "0" * 16}),
    ("backend", "gpu"), ("schema", 0)])
def test_provenance_mismatch_refuses_library(warm, tmp_path, field, value):
    """A library stamped by another torch, other kernel sources, another
    backend or another schema is refused whole, with the field named."""
    import shutil

    _, lib, _, _, _ = warm
    lib2 = str(tmp_path / "L")
    shutil.copytree(lib, lib2)
    p = os.path.join(lib2, TL.INDEX_NAME)
    with open(p) as f:
        idx = json.load(f)
    idx["provenance"][field] = value
    with open(p, "w") as f:
        json.dump(idx, f)
    got = TL.ProgramLibrary(lib2, device="cpu")
    assert got.load() == 0 and got.keys() == []
    assert got.stale_reason.startswith(f"provenance_mismatch:{field}(")


def test_router_attaches_library_single_device_only(tmp_path):
    """As in JAX: a library on a one-device planes Router, none under a
    row mesh or on the ELL program; export without one writes nothing;
    the last RouterOpts option left ``_NOT_PORTED``."""
    f = synth_flow(num_luts=10, seed=1)
    d = str(tmp_path / "L")
    r = TR.Router(f.rr, TR.RouterOpts(program_library_dir=d), device="cpu")
    assert isinstance(r._library, TL.ProgramLibrary)
    assert r._library.stale_reason == "no_index"
    for opts in (dict(mesh_shards=2), dict(program="ell")):
        r = TR.Router(f.rr, TR.RouterOpts(program_library_dir=d, **opts),
                      device="cpu")
        assert r._library is None and r.export_program_library() == 0
    assert TR._NOT_PORTED == {}


# ---- the compile cache against a stand-in nvcc -----------------------------

FAKE_NVCC = r'''#!{python}
import hashlib, os, sys
log = os.environ["FAKE_NVCC_LOG"]
with open(log, "a") as f:
    f.write(("version" if "--version" in sys.argv else "build") + "\n")
if "--version" in sys.argv:
    print("Cuda compilation tools, release 12.9 (stand-in)")
    sys.exit(0)
out = sys.argv[sys.argv.index("-o") + 1]
src = open(sys.argv[-1], "rb").read()
with open(out, "wb") as f:
    f.write(b"\x7fELF-stand-in " + hashlib.sha256(src).digest() * 64)
    if os.environ.get("FAKE_NVCC_FAIL"):
        sys.exit(2)
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc first on PATH, the capability pinned, and the
    module's process state (cache dir, offers, version memo) restored
    after the test."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "nvcc"
    exe.write_text(FAKE_NVCC.replace("{python}", sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(cuda_lib, "compute_capability", lambda: "9.0")
    monkeypatch.setattr(cuda_lib, "_CACHE_DIR", [None])
    monkeypatch.setattr(cuda_lib, "_OFFERS", {})
    monkeypatch.setattr(cuda_lib, "_NVCC_VERSION", [None])
    TT.reset_compile_seconds()

    def calls():
        return log.read_text().split() if log.exists() else []

    return calls


def _lib(name="planes_relax"):
    return cuda_lib.CudaLib(name, lambda lib: None)


def _fresh_process():
    """What a new process starts with: no version memo, no offers."""
    cuda_lib._NVCC_VERSION[0] = None
    cuda_lib._OFFERS.clear()


def test_cache_cold_build_then_warm_runs_no_nvcc(fake_nvcc, tmp_path):
    cache = str(tmp_path / "cc")
    cuda_lib.set_cache_dir(cache)
    tracer = TT.Tracer()
    TT.set_tracer(tracer)
    try:
        cold = _lib()
        path = cold._resolve()
        assert fake_nvcc() == ["version", "build"]
        assert TT.compile_seconds() > 0
        assert os.path.dirname(path) == cache
        assert os.path.basename(path) == f"libplanes_relax-{cold.digest()}.so"
        with open(path + ".json") as f:
            rec = json.load(f)
        assert rec["sha256"] == cuda_lib.file_sha256(path)
        assert sorted(os.listdir(cache)) == sorted(
            [os.path.basename(path), os.path.basename(path) + ".json",
             "nvcc_version.json"])
        builds = [e for e in tracer.events if e.get("name") == "cuda.build"]
        assert len(builds) == 1
        # a fresh process on the warm cache: no nvcc at all
        _fresh_process()
        TT.reset_compile_seconds()
        tracer2 = TT.Tracer()
        TT.set_tracer(tracer2)
        assert _lib()._resolve() == path
        assert fake_nvcc() == ["version", "build"]
        assert TT.compile_seconds() == 0
        assert not [e for e in tracer2.events
                    if e.get("name") == "cuda.build"]
    finally:
        TT.set_tracer(None)


def test_cache_torn_file_evicted_and_rebuilt(fake_nvcc, tmp_path):
    cuda_lib.set_cache_dir(str(tmp_path / "cc"))
    path = _lib()._resolve()
    good = cuda_lib.file_sha256(path)
    with open(path, "r+b") as f:
        f.truncate(100)
    _fresh_process()
    lib = _lib()
    assert lib._resolve() == path
    assert lib.evicted == [(path, "sha256 mismatch")]
    assert cuda_lib.file_sha256(path) == good
    assert fake_nvcc().count("build") == 2


def test_offered_copies(fake_nvcc, tmp_path):
    """An intact offered copy is installed into a fresh cache without a
    build; a torn one is evicted, never returned, and the library is
    rebuilt from source."""
    cuda_lib.set_cache_dir(str(tmp_path / "cc1"))
    built = _lib()._resolve()
    digest = _lib().digest()
    sha = cuda_lib.file_sha256(built)
    copy = str(tmp_path / "copy.so")
    with open(built, "rb") as f, open(copy, "wb") as g:
        g.write(f.read())
    _fresh_process()
    cuda_lib.set_cache_dir(str(tmp_path / "cc2"))
    cuda_lib.offer("planes_relax", digest, copy, sha)
    n = fake_nvcc().count("build")
    got = _lib()._resolve()
    assert os.path.dirname(got) == str(tmp_path / "cc2")
    assert cuda_lib.file_sha256(got) == sha and fake_nvcc().count("build") == n
    with open(copy, "r+b") as f:
        f.truncate(10)
    _fresh_process()
    cuda_lib.set_cache_dir(str(tmp_path / "cc3"))
    cuda_lib.offer("planes_relax", digest, copy, sha)
    lib = _lib()
    got = lib._resolve()
    assert got != copy and cuda_lib.file_sha256(got) == sha
    assert lib.evicted == [(copy, "offered copy sha256 mismatch")]
    assert fake_nvcc().count("build") == n + 1


def test_offered_nvcc_version_runs_no_nvcc(fake_nvcc, tmp_path):
    """A process with a fresh compile cache over offered copies takes
    the recorded ``nvcc --version`` when the live nvcc has the record's
    stamp, and so starts no nvcc at all; a record from another binary is
    refused and nvcc --version runs (a "cuda.nvcc" span)."""
    cuda_lib.set_cache_dir(str(tmp_path / "cc1"))
    lib = _lib()
    built = lib._resolve()
    rec = cuda_lib.nvcc_record()
    digest, sha = lib.digest(), cuda_lib.file_sha256(built)
    assert rec["version"].endswith("(stand-in)")
    assert rec["stamp"][0] == os.path.realpath(
        str(tmp_path / "bin" / "nvcc"))
    n = len(fake_nvcc())
    for k, (record, taken) in enumerate((
            (rec, True),
            (dict(rec, stamp=[rec["stamp"][0], 1, 2]), False))):
        _fresh_process()
        cuda_lib.set_cache_dir(str(tmp_path / f"fresh{k}"))
        cuda_lib.offer("planes_relax", digest, built, sha)
        assert cuda_lib.offer_nvcc_version(record) is taken
        tracer = TT.Tracer()
        TT.set_tracer(tracer)
        try:
            got = _lib()._resolve()
        finally:
            TT.set_tracer(None)
        assert cuda_lib.file_sha256(got) == sha
        spans = [e for e in tracer.events if e.get("name") == "cuda.nvcc"]
        if taken:
            assert len(fake_nvcc()) == n and not spans
        else:
            assert fake_nvcc()[n:] == ["version"] and len(spans) == 1
            n += 1


def test_failed_build_leaves_no_final_file(fake_nvcc, tmp_path, monkeypatch):
    cache = str(tmp_path / "cc")
    cuda_lib.set_cache_dir(cache)
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="nvcc planes_relax.cu failed"):
        _lib()._resolve()
    assert [n for n in os.listdir(cache) if n.endswith(".so")
            or ".so.tmp" in n] == []


def test_cache_key_follows_source_and_capability(fake_nvcc, tmp_path,
                                                 monkeypatch):
    lib = _lib()
    d0 = lib.digest()
    src = tmp_path / "planes_relax.cu"
    src.write_bytes(open(lib.src, "rb").read())
    lib.src = str(src)
    assert lib.digest() == d0           # same text, another file
    os.utime(src, (1, 1))
    assert lib.digest() == d0           # the mtime is not in the key
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert lib.digest() != d0
    lib.src = _lib().src
    monkeypatch.setattr(cuda_lib, "compute_capability", lambda: "8.0")
    assert lib.digest() != d0
