"""Building and loading the port's hand-written CUDA sources.

Each source ``csrc/<name>.cu`` has a plain C interface; it is compiled
with nvcc for sm_90a into ``parallel_eda_tpu_torch/build/lib<name>.so``
at first use (or by chip_smoke.py, which starts every build at once)
and loaded with ctypes.  Nothing here runs at import.  Each build's
seconds go to ``obs.trace.note_build`` (the tracer's "cuda.build"
spans, ``compile_seconds()``).

The compile cache (``set_cache_dir``, set by ``RouterOpts.
compile_cache_dir`` and the CLIs' ``--compile_cache_dir``) keeps the
built libraries across processes under a key that is a digest of the
source text, the nvcc command (``CudaLib.command``), ``nvcc --version``
and the card's compute capability, never a file's mtime:
``<dir>/lib<name>-<digest>.so`` beside a ``.json`` record of its
sha256.  A process that finds a library there whose bytes match the
record loads it and runs no nvcc.  A build writes a temporary name and
installs it with ``os.replace``, so a killed process, or two processes
building at once, never leave a torn library under the final name; and
every library's sha256 is checked against its record BEFORE
``ctypes.CDLL`` opens it (a torn or foreign shared object can crash the
process inside the loader, where no ``except`` reaches): a mismatch
deletes the file and rebuilds it from the repo's source.  The program
library (serve/library.py) offers its own copies of the libraries
(``offer``) under the same digests, and its record of ``nvcc
--version`` (``offer_nvcc_version``).  Without a cache directory and
without offers the default ``build/`` behaviour (rebuild when the source
is newer) stays as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import time
from typing import Callable, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")

# the process's compile cache directory (None: the default build/)
_CACHE_DIR = [None]
# libraries the program library offers: name -> {digest: (path, sha256)}
_OFFERS: dict = {}
# every CudaLib this process loaded, in load order
LOADED: list = []
# nvcc --version of this process (memoized)
_NVCC_VERSION = [None]


def set_cache_dir(path: Optional[str]) -> None:
    """Use ``path`` as this process's compile cache (None: the default
    build/ directory).  Libraries already loaded stay loaded."""
    _CACHE_DIR[0] = os.path.abspath(path) if path else None


def cache_dir() -> Optional[str]:
    return _CACHE_DIR[0]


def offer(name: str, digest: str, path: str, sha256: str) -> None:
    """A prebuilt library for ``name`` under ``digest`` (the program
    library's copy): used instead of a build when its digest is the
    live one and its bytes match ``sha256``."""
    _OFFERS.setdefault(name, {})[digest] = (path, sha256)


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _atomic_json(path: str, doc: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def nvcc_path() -> str:
    p = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(p):
        raise RuntimeError("nvcc not found (needs the CUDA toolkit)")
    return p


def nvcc_stamp() -> list:
    """The nvcc binary's real path, size and mtime (no process)."""
    exe = os.path.realpath(nvcc_path())
    st = os.stat(exe)
    return [exe, st.st_size, st.st_mtime_ns]


def nvcc_record() -> dict:
    """``nvcc --version`` beside the stamp of the binary that gave it
    (what the program library keeps, ``offer_nvcc_version``)."""
    return {"stamp": nvcc_stamp(), "version": nvcc_version()}


def offer_nvcc_version(record: Optional[dict]) -> bool:
    """Take a recorded ``nvcc --version`` (``nvcc_record``) as this
    process's when the live nvcc binary has the record's stamp, so that
    a process with a fresh compile cache over a program library starts
    no nvcc at all.  Returns whether it was taken."""
    if _NVCC_VERSION[0] is not None or not isinstance(record, dict):
        return False
    try:
        live = nvcc_stamp()
    except (RuntimeError, OSError):
        return False
    if record.get("stamp") != live or \
            not isinstance(record.get("version"), str):
        return False
    _NVCC_VERSION[0] = record["version"]
    return True


def nvcc_version() -> str:
    """``nvcc --version``.  With a compile cache it is kept there, keyed
    by the nvcc binary's real path, size and mtime, so that a process on
    a warm cache starts no nvcc at all; a run of it is a "cuda.nvcc"
    span in the tracer."""
    if _NVCC_VERSION[0] is not None:
        return _NVCC_VERSION[0]
    stamp = nvcc_stamp()
    exe = stamp[0]
    memo = (os.path.join(_CACHE_DIR[0], "nvcc_version.json")
            if _CACHE_DIR[0] else None)
    if memo is not None and os.path.exists(memo):
        try:
            with open(memo) as f:
                doc = json.load(f)
            if doc.get("stamp") == stamp:
                _NVCC_VERSION[0] = doc["version"]
                return _NVCC_VERSION[0]
        except (OSError, ValueError, KeyError):
            pass
    from ..obs.trace import get_tracer

    t0 = time.perf_counter()
    out = subprocess.run([exe, "--version"], capture_output=True,
                         text=True, check=True).stdout
    tr = get_tracer()
    if tr is not None:
        tr.add_complete("cuda.nvcc", t0, time.perf_counter() - t0,
                        cat="cuda.nvcc", args="--version")
    _NVCC_VERSION[0] = out.strip()
    if memo is not None:
        os.makedirs(_CACHE_DIR[0], exist_ok=True)
        _atomic_json(memo, {"stamp": stamp, "version": _NVCC_VERSION[0]})
    return _NVCC_VERSION[0]


def compute_capability() -> str:
    """The current card's compute capability, e.g. "9.0"."""
    major, minor = torch.cuda.get_device_capability()
    return f"{major}.{minor}"


class CudaLib:
    """One CUDA source and its shared library.  ``setup`` declares the
    argtypes/restype of the loaded library's functions."""

    def __init__(self, name: str, setup: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.src = os.path.join(_PKG, "csrc", name + ".cu")
        self.path = os.path.join(BUILD_DIR, f"lib{name}.so")
        self.setup = setup
        # filled by finish_build(): seconds, and nvcc's -Xptxas -v
        # register / shared memory / spill report
        self.info: dict = {}
        # the file the loaded library came from, and its cache digest
        self.loaded_path: Optional[str] = None
        self.loaded_digest: Optional[str] = None
        # (path, reason) of every library file this process refused
        self.evicted: list = []
        self._lib = None
        self._out = None

    def command(self, out: Optional[str] = None) -> list:
        """sm_90a, no FMA contraction (kernels round as their plain
        versions do), register/spill report on."""
        return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
                "-shared", "-Xcompiler", "-fPIC", "-o", out or self.path,
                self.src]

    def digest(self) -> str:
        """The compile cache key: source text, nvcc command (its output
        path left out), nvcc version and compute capability."""
        cmd = self.command(out="<out>")
        cmd[0] = os.path.basename(cmd[0])
        cmd[-1] = os.path.basename(cmd[-1])
        doc = json.dumps([file_sha256(self.src), cmd, nvcc_version(),
                          compute_capability()])
        return hashlib.sha256(doc.encode()).hexdigest()[:24]

    def cache_path(self, digest: str) -> str:
        return os.path.join(_CACHE_DIR[0], f"lib{self.name}-{digest}.so")

    def start_build(self, out: Optional[str] = None) -> subprocess.Popen:
        """Start nvcc in the background into a temporary name beside
        ``out`` (default: the compile cache's file when a cache is set,
        else build/lib<name>.so); finish_build() installs it."""
        if out is None:
            out = (self.cache_path(self.digest()) if _CACHE_DIR[0]
                   else self.path)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.tmp.{os.getpid()}"
        self._out = (tmp, out)
        self.info["t0"] = time.perf_counter()
        return subprocess.Popen(self.command(out=tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: subprocess.Popen) -> dict:
        from ..obs.trace import note_build

        out, _ = proc.communicate()
        t0 = self.info.pop("t0")
        self.info["seconds"] = time.perf_counter() - t0
        note_build(self.name, t0, self.info["seconds"])
        self.info["ptxas"] = [ln.strip() for ln in out.splitlines()
                              if "ptxas" in ln or "spill" in ln
                              or "Used" in ln]
        tmp, final = self._out
        self._out = None
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(f"nvcc {self.name}.cu failed "
                               f"({proc.returncode}):\n{out}")
        sha = file_sha256(tmp)
        os.replace(tmp, final)
        if _CACHE_DIR[0] and os.path.dirname(final) == _CACHE_DIR[0]:
            # the record goes in after the library: a library without
            # its record is rebuilt, never trusted
            _atomic_json(final + ".json", {"name": self.name,
                                           "sha256": sha,
                                           "bytes": os.path.getsize(final)})
        return self.info

    def _verified(self, path: str) -> bool:
        """``path`` exists with its record's sha256; a file that does not
        match is deleted (with its record) and booked in ``evicted``."""
        if not os.path.exists(path):
            return False
        try:
            with open(path + ".json") as f:
                want = json.load(f)["sha256"]
        except (OSError, ValueError, KeyError):
            want = None
        if want is not None and file_sha256(path) == want:
            return True
        self.evicted.append((path, "no record" if want is None
                             else "sha256 mismatch"))
        for p in (path, path + ".json"):
            try:
                os.unlink(p)
            except OSError:
                pass
        return False

    def _resolve(self) -> str:
        """The verified file to load, built first if need be."""
        offers = _OFFERS.get(self.name)
        if _CACHE_DIR[0] is None and not offers:
            if (not os.path.exists(self.path) or os.path.getmtime(self.path)
                    < os.path.getmtime(self.src)):
                self.finish_build(self.start_build())
            return self.path
        digest = self.digest()
        self.loaded_digest = digest
        final = self.cache_path(digest) if _CACHE_DIR[0] else None
        if final is not None and self._verified(final):
            return final
        off = (offers or {}).get(digest)
        if off is not None:
            path, sha = off
            if os.path.exists(path) and file_sha256(path) == sha:
                if final is None:
                    return path
                os.makedirs(os.path.dirname(final), exist_ok=True)
                tmp = f"{final}.tmp.{os.getpid()}"
                shutil.copyfile(path, tmp)
                if file_sha256(tmp) == sha:
                    os.replace(tmp, final)
                    _atomic_json(final + ".json", {
                        "name": self.name, "sha256": sha,
                        "bytes": os.path.getsize(final)})
                    return final
                os.unlink(tmp)
            self.evicted.append((path, "offered copy sha256 mismatch"))
        if final is None:
            final = self.path
        self.finish_build(self.start_build(out=final))
        return final

    def get(self) -> ctypes.CDLL:
        """The loaded library, found in the compile cache or among the
        offered copies, else built from source."""
        if self._lib is None:
            path = self._resolve()
            lib = ctypes.CDLL(path)
            self.setup(lib)
            self._lib = lib
            self.loaded_path = path
            LOADED.append(self)
        return self._lib


class Launch:
    """A ``(void** p, long long* v, void* stream)`` launch entry with its
    argument tables built once, as ctypes arrays ``p`` and ``v``: a
    caller whose tensors change between calls sets their slots (slice
    assignment) before calling.  Calling the object launches on
    ``device``'s current stream (the entry makes the card current
    itself) and raises on a non-zero CUDA error code.  ``keep`` holds the
    tensors whose pointers the tables carry."""

    __slots__ = ("fn", "p", "v", "index", "what", "keep")

    def __init__(self, fn, ptrs, ints, device: torch.device, what: str,
                 keep=()):
        if device.type != "cuda" or device.index is None:
            raise ValueError(f"{what}: needs a CUDA device with an index, "
                             f"got {device}")
        self.fn = fn
        self.p = (ctypes.c_void_p * len(ptrs))(*ptrs)
        self.v = (ctypes.c_longlong * len(ints))(*ints)
        self.index = device.index
        self.what = what
        self.keep = keep

    def __call__(self) -> None:
        # the current stream's raw handle, read as Triton's launcher reads
        # it, without building a torch.cuda.Stream object per call
        rc = self.fn(self.p, self.v,
                     torch._C._cuda_getCurrentRawStream(self.index))
        if rc != 0:
            raise RuntimeError(f"{self.what} kernel launch failed "
                               f"(cudaError {rc})")


def check_tensor(t, dtype, shape, name: str) -> None:
    """A kernel argument: a contiguous CUDA tensor of this type/shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
