"""Program library for warm-start serving (the counterpart of
parallel_eda_tpu/serve/library.py: its index ``library.json``, its
schema, its ``key_id`` and its lifecycle ``load`` / ``keys`` / ``note``
/ ``save`` / ``evict`` / ``dispatch``).

The JAX library serializes compiled window programs with ``jax.export``
so that a warm process compiles nothing.  The port compiles no program
per variant: what a fresh process pays instead is the nvcc builds of
``csrc/*.cu`` and the launch plans the kernel wrappers build at a
variant's first launch (route/planes_kernels.py ``_plan``).  So an
entry here, keyed by the same ``_note_dispatch_variant`` signature as
JAX's, records that variant's launch plans: per plan the kernel kind,
the shared-memory mode, the grid, the block and the dynamic shared
bytes (``planes_kernels.plan_record``), with a ``sig`` (a digest of the
call's tensor shapes and dtypes, its structure and the variant key) and
the blob's ``sha256``.  ``save`` also copies every CUDA library the
process loaded into ``so/<digest>.so``; ``load`` offers them to
route/cuda_lib.py under the same compile-cache digests, after checking
each copy's sha256 — a torn copy is evicted and never reaches
``ctypes.CDLL``, and the library it stood for is rebuilt from the repo's
source (into the compile cache when one is set).  The index also keeps
the ``nvcc --version`` the digests were taken with, beside the nvcc
binary's stamp, so that a process with a fresh compile cache on the
same toolchain starts no nvcc at all.

``load`` pre-registers every intact entry's key as a seen dispatch
variant, so a warm process counts ``route.dispatch.compiles == 0`` for
the variants in the library, as in JAX; a torn entry is not
pre-registered.  ``dispatch(key, fn, args, kwargs)`` fires
``library.corrupt``, checks the entry's ``sig`` and ``sha256``,
installs its launch plans (``planes_kernels.install_plan``, which also
checks them against the live card), then runs ``fn``, the port's own
window function, which launches the hand-written kernels, and counts
``route.serve.aot_hits``.  Any error before ``fn`` evicts the entry,
counts ``route.serve.aot_errors`` and runs the same ``fn`` without the
library, counting ``route.serve.jit_fallbacks`` (JAX's names: in the
port "aot" is a library entry's launch plans, "jit" the wrappers
planning at first launch).  No rung of this is the plain PyTorch
version: on a CUDA tensor ``fn`` launches the kernels or raises, and an
error inside ``fn`` is the caller's (the resilience guard's), never
retried here on half-written state.

Provenance is the port's own: schema, torch, the CUDA runtime, the
backend, the device name and compute capability, the digest of each
``csrc/*.cu`` and, opt-in, the git rev.  A mismatch refuses the whole
library with ``provenance_mismatch:<field>(...)``; a refused library
degrades to the behaviour without a library, never to a wrong answer.

Imports nothing of route/ at module level (the router imports it
lazily).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs.metrics import get_metrics

INDEX_NAME = "library.json"
LIBRARY_SCHEMA = 1
SO_DIR = "so"

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")


def _tupled(x):
    """Canonicalize a variant key: JSON round-trips tuples as lists,
    and live keys may carry numpy scalars — normalize both so the
    on-disk and in-process forms hash/repr identically."""
    if isinstance(x, (list, tuple)):
        return tuple(_tupled(v) for v in x)
    if isinstance(x, bool):
        return x
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def key_id(key: Tuple) -> str:
    """Stable filename stem for a variant key (JAX's, so one key has one
    id in both packages)."""
    return hashlib.sha256(repr(_tupled(key)).encode()).hexdigest()[:16]


def _sig_digest(key: Tuple, args: tuple, kwargs: dict) -> str:
    """Digest of the call's structure: every tensor's shape and dtype,
    the types of the scalars (their values change window to window),
    the names of the graph objects, and the variant key, which carries
    the call's static values."""
    parts = [repr(_tupled(key))]

    def walk(x):
        if isinstance(x, torch.Tensor):
            parts.append(f"T{tuple(x.shape)}:{x.dtype}")
        elif isinstance(x, (tuple, list)):
            parts.append("(")
            for v in x:
                walk(v)
            parts.append(")")
        elif isinstance(x, dict):
            parts.append("{")
            for k in sorted(x):
                parts.append(str(k))
                walk(x[k])
            parts.append("}")
        elif x is None or isinstance(x, (str, bool)):
            parts.append(repr(x))
        else:
            # numbers (their values change window to window) and the
            # graph objects: the type alone
            parts.append(type(x).__name__)

    walk(args)
    walk(kwargs)
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def _csrc_digests() -> Dict[str, str]:
    from ..route.cuda_lib import file_sha256

    return {os.path.basename(p): file_sha256(p)[:16]
            for p in sorted(glob.glob(os.path.join(_CSRC, "*.cu")))}


def _provenance(device: torch.device,
                repo_dir: Optional[str] = None) -> Dict[str, Any]:
    try:
        from ..obs.runstore import git_rev
        rev = git_rev(repo_dir)
    except Exception:
        # a checkout without git is an expected environment; the
        # recorded outcome IS rev=None in the stamp
        rev = None
    cuda = device.type == "cuda"
    return {
        "schema": LIBRARY_SCHEMA,
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "backend": "gpu" if cuda else device.type,
        "device_name": (torch.cuda.get_device_name(device) if cuda
                        else device.type),
        "capability": (".".join(map(str, torch.cuda.get_device_capability(
            device))) if cuda else None),
        "csrc": _csrc_digests(),
        "git_rev": rev,
    }


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _sha256(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


class ProgramLibrary:
    """Directory of variant launch-plan records and built CUDA libraries.

    Lifecycle: a warm-up process routes once with the library attached
    (``dispatch`` misses ``note`` each variant's plans), then calls
    ``save()`` to write every noted variant and the loaded CUDA
    libraries.  A serving process constructs the library on the same
    directory, ``load()``s the index, and ``dispatch()`` serves matching
    variants with their plans installed — falling back to planning at
    first launch (and noting the variant for a later save) on any miss
    or error."""

    def __init__(self, directory: str, device=None,
                 repo_dir: Optional[str] = None,
                 check_git_rev: bool = False):
        from ..device import resolve_device

        self.dir = os.path.abspath(directory)
        self.device = resolve_device(device)
        self.repo_dir = repo_dir
        # the git rev changes on every commit while the kernels rarely
        # do; the csrc digests are the binary compatibility boundary,
        # so rev checking is opt-in
        self.check_git_rev = check_git_rev
        self.stale_reason: Optional[str] = None
        self._index: Dict[str, Dict[str, Any]] = {}   # kid -> meta
        self._keys: Dict[str, Tuple] = {}             # kid -> key
        self._libs: Dict[str, Dict[str, Any]] = {}    # lib name -> meta
        self._nvcc: Optional[dict] = None   # cuda_lib.nvcc_record()
        self._blobs: Dict[str, dict] = {}             # kid -> blob
        self._pending: Dict[str, Dict[str, Any]] = {} # kid -> capture
        self._dead: set = set()                       # kid evicted
        self.dropped: List[Tuple[str, str]] = []      # (kid, reason)
        self.fault_plan = None  # optional resil FaultPlan (set by serve)

    # ---------------------------------------------------------- load

    def load(self) -> int:
        """Read the index; returns the number of usable entries (0 and
        a ``stale_reason`` when provenance refuses the library)."""
        path = os.path.join(self.dir, INDEX_NAME)
        if not os.path.exists(path):
            self.stale_reason = "no_index"
            return 0
        try:
            with open(path) as f:
                idx = json.load(f)
        except (OSError, ValueError) as e:
            self.stale_reason = f"unreadable_index: {e}"
            return 0
        prov = idx.get("provenance", {})
        want = _provenance(self.device, self.repo_dir)
        checked = ["schema", "torch", "cuda_runtime", "backend",
                   "device_name", "capability", "csrc"]
        if self.check_git_rev:
            checked.append("git_rev")
        for field in checked:
            if prov.get(field) != want[field]:
                self.stale_reason = (
                    f"provenance_mismatch:{field}"
                    f"({prov.get(field)}!={want[field]})")
                return 0
        self.stale_reason = None
        m = get_metrics()
        for kid, meta in idx.get("entries", {}).items():
            blob = os.path.join(self.dir, meta.get("file", ""))
            if not os.path.exists(blob):
                continue
            # content checksum: a torn blob must degrade to planning at
            # first launch here, not raise at first dispatch — and must
            # not pre-register its key as a warm variant
            want_sha = meta.get("sha256")
            if want_sha is not None:
                with open(blob, "rb") as f:
                    got = _sha256(f.read())
                if got != want_sha:
                    m.counter("route.serve.aot_errors").inc()
                    self.dropped.append(
                        (kid, f"checksum mismatch (torn file?): "
                              f"{got[:12]} != {want_sha[:12]}"))
                    self._dead.add(kid)
                    continue
            self._index[kid] = meta
            self._keys[kid] = _tupled(meta["key"])
        self._nvcc = idx.get("nvcc")
        self._load_libs(idx.get("libs", {}))
        return len(self._index)

    def _load_libs(self, libs: dict) -> None:
        """Offer every intact library copy to cuda_lib; a copy whose
        bytes do not match its sha256 is evicted (file and index entry)
        before anything can load it."""
        from ..route import cuda_lib

        torn = []
        for name, meta in sorted(libs.items()):
            path = os.path.join(self.dir, meta.get("file", ""))
            ok = (os.path.exists(path)
                  and cuda_lib.file_sha256(path) == meta.get("sha256"))
            if not ok:
                torn.append(name)
                get_metrics().counter("route.serve.aot_errors").inc()
                self.dropped.append((f"so:{name}",
                                     "library copy sha256 mismatch "
                                     "(torn file?)"))
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            self._libs[name] = meta
            cuda_lib.offer(name, meta["digest"], path, meta["sha256"])
        if self._libs:
            # the digests' nvcc --version, taken where the binary is
            # the one that gave it: a fresh cache then starts no nvcc
            cuda_lib.offer_nvcc_version(self._nvcc)
        if torn:
            def drop(idx):
                for name in torn:
                    idx.get("libs", {}).pop(name, None)
            self._rewrite_index(drop)

    def keys(self) -> List[Tuple]:
        """Variant keys available for warm dispatch."""
        return list(self._keys.values())

    def _blob(self, kid: str) -> dict:
        """Read and verify an entry's blob (once per process)."""
        if kid in self._blobs:
            return self._blobs[kid]
        meta = self._index[kid]
        with open(os.path.join(self.dir, meta["file"]), "rb") as f:
            raw = f.read()
        # re-verify at read time (load() may be long past): any
        # corruption raises here and dispatch() degrades
        want_sha = meta.get("sha256")
        if want_sha is not None and _sha256(raw) != want_sha:
            raise ValueError(f"library blob {meta['file']} checksum "
                             f"mismatch (torn file?)")
        doc = json.loads(raw.decode("utf-8"))
        self._blobs[kid] = doc
        return doc

    # ------------------------------------------------------- capture

    def note(self, key: Tuple, sig: str, plans: list) -> None:
        """Record a variant's launch plans for a later save()."""
        kid = key_id(key)
        if kid in self._index or kid in self._pending or kid in self._dead:
            return
        uniq = []
        for p in plans:
            if p not in uniq:
                uniq.append(p)
        self._pending[kid] = {"key": _tupled(key), "sig": sig,
                              "plans": uniq}

    def _rewrite_index(self, edit: Callable[[dict], Any]) -> None:
        path = os.path.join(self.dir, INDEX_NAME)
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                idx = json.load(f)
            edit(idx)
            _atomic_write(path, json.dumps(idx, indent=1,
                                           default=str).encode())
        except (OSError, ValueError):
            pass  # the in-process state still holds

    def _save_libs(self) -> None:
        """Copy every CUDA library this process loaded into so/ under
        its compile-cache digest."""
        from ..route import cuda_lib

        for lib in cuda_lib.LOADED:
            digest = lib.loaded_digest or lib.digest()
            have = self._libs.get(lib.name)
            if have is not None and have.get("digest") == digest:
                continue
            with open(lib.loaded_path, "rb") as f:
                raw = f.read()
            fname = os.path.join(SO_DIR, f"lib{lib.name}-{digest}.so")
            os.makedirs(os.path.join(self.dir, SO_DIR), exist_ok=True)
            _atomic_write(os.path.join(self.dir, fname), raw)
            self._libs[lib.name] = {"digest": digest, "file": fname,
                                    "bytes": len(raw),
                                    "sha256": _sha256(raw)}
        if cuda_lib.LOADED:
            self._nvcc = cuda_lib.nvcc_record()

    def save(self) -> int:
        """Write every pending variant and the loaded CUDA libraries;
        merge the index.  Returns entries written."""
        os.makedirs(self.dir, exist_ok=True)
        written = 0
        for kid, cap in list(self._pending.items()):
            blob = json.dumps({"key": list(cap["key"]),
                               "plans": cap["plans"]},
                              sort_keys=True, default=str).encode("utf-8")
            fname = f"{kid}.plans.json"
            # atomic blob install (tmp + rename): a crash mid-save can
            # never leave a torn blob behind a valid index entry
            _atomic_write(os.path.join(self.dir, fname), blob)
            self._index[kid] = {
                "key": list(cap["key"]),
                "file": fname,
                "sig": cap["sig"],
                "plans": len(cap["plans"]),
                "bytes": len(blob),
                "sha256": _sha256(blob),
            }
            self._keys[kid] = cap["key"]
            del self._pending[kid]
            written += 1
        self._save_libs()
        index = {
            "provenance": _provenance(self.device, self.repo_dir),
            "entries": {kid: {**meta, "key": list(meta["key"])}
                        for kid, meta in self._index.items()},
            "libs": self._libs,
            "nvcc": self._nvcc,
        }
        _atomic_write(os.path.join(self.dir, INDEX_NAME),
                      json.dumps(index, indent=1, default=str).encode())
        return written

    # ------------------------------------------------------ eviction

    def evict(self, key: Tuple, reason: str = "") -> None:
        """Blacklist a variant (resil quarantine, a failed dispatch):
        dead for this process AND removed from the on-disk index so a
        later process never serves the entry either."""
        kid = key_id(key)
        self._dead.add(kid)
        self._blobs.pop(kid, None)
        self.dropped.append((kid, reason or "evicted"))
        if self._index.pop(kid, None) is None:
            return
        self._keys.pop(kid, None)
        get_metrics().counter("route.serve.library_evictions").inc()
        self._rewrite_index(lambda idx: idx.get("entries", {}).pop(kid,
                                                                   None))

    # ------------------------------------------------------ dispatch

    def _install(self, kid: str, args: tuple) -> None:
        plans = self._blob(kid)["plans"]
        if plans:
            from ..route.planes_kernels import install_plan

            pg = args[0]
            for rec in plans:
                install_plan(rec, pg)

    def dispatch(self, key: Tuple, fn: Callable,
                 args: tuple, kwargs: dict):
        """Serve one window dispatch: with the entry's launch plans
        installed when the library has this variant, else planning at
        first launch (and noting the variant's plans)."""
        from ..route.planes_kernels import record_plans

        m = get_metrics()
        kid = key_id(key)
        sig = _sig_digest(key, args, kwargs)
        if kid in self._index and kid not in self._dead:
            try:
                if self.fault_plan is not None:
                    # injected stale/truncated-entry fault: exercises
                    # the same evict-and-degrade path a torn blob takes
                    self.fault_plan.raise_if("library.corrupt",
                                             detail=kid)
                meta = self._index[kid]
                if meta.get("sig") not in (None, sig):
                    raise ValueError(
                        f"signature drift {meta.get('sig')} != {sig}")
                self._install(kid, args)
            except Exception as e:
                # evict and fall through: a broken entry must never
                # take the route down, only cost planning at launch
                m.counter("route.serve.aot_errors").inc()
                self.evict(key, f"{type(e).__name__}: {e}")
            else:
                out = fn(*args, **kwargs)
                m.counter("route.serve.aot_hits").inc()
                return out
        m.counter("route.serve.jit_fallbacks").inc()
        with record_plans() as plans:
            out = fn(*args, **kwargs)
        self.note(key, sig, plans)
        return out
