"""Durable, crash-safe job checkpoints: the counterpart of
parallel_eda_tpu/resil/checkpoint.py.

Serialized ``RouteCheckpoint`` snapshots (full negotiation state at a
window boundary) written atomically — tmp + fsync + rename — with a
sha256 content checksum in the header.  The previous good checkpoint
is kept alongside the current one; a load that fails verification
falls back to it.  Resuming from ANY good checkpoint is QoR-neutral:
the router replays the remaining deterministic iterations to the same
bit-identical answer, whether the snapshot is one window or five
windows old (restart-from-scratch, the empty fallback, is just the
zero-window case).

File layout per job: ``<dir>/<job_id>.ck`` (current) and
``<dir>/<job_id>.ck.prev`` (previous good).  Blob format:
``PEDACK1\n<sha256hex>\n<pickle payload>``.  A ``RouteCheckpoint``
is pickled as its field dict (route/router.py ``checkpoint_to_numpy``:
numpy arrays and Python scalars, no tensor and no class of the port)
and rebuilt with ``checkpoint_from_numpy``, so a file resumes under any
device; any other picklable object is stored as it is.
"""

import hashlib
import os
import pickle

from ..obs.metrics import get_metrics
from ..obs.trace import get_tracer

_MAGIC = b"PEDACK1\n"


# the pickled form of a RouteCheckpoint: (_CK_TAG, its field dict)
_CK_TAG = "RouteCheckpoint/fields"


def _encode(obj) -> bytes:
    from ..route.router import RouteCheckpoint, checkpoint_to_numpy

    if isinstance(obj, RouteCheckpoint):
        obj = (_CK_TAG, checkpoint_to_numpy(obj))
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sha = hashlib.sha256(payload).hexdigest().encode("ascii")
    return _MAGIC + sha + b"\n" + payload


def _decode(blob: bytes):
    """Return the object, or raise ValueError on any corruption."""
    if not blob.startswith(_MAGIC):
        raise ValueError("bad magic (torn or foreign file)")
    rest = blob[len(_MAGIC):]
    nl = rest.find(b"\n")
    if nl != 64:
        raise ValueError("malformed checksum header")
    sha, payload = rest[:nl], rest[nl + 1:]
    if hashlib.sha256(payload).hexdigest().encode("ascii") != sha:
        raise ValueError("checksum mismatch (torn or corrupt payload)")
    obj = pickle.loads(payload)
    if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == _CK_TAG:
        from ..route.router import checkpoint_from_numpy

        obj = checkpoint_from_numpy(obj[1])
    return obj


def checkpoint_file(directory: str, job_id: str) -> str:
    """The current-generation file of ``job_id``'s checkpoint under
    ``directory`` (the job id sanitised for a file name)."""
    safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                   for c in str(job_id))
    return os.path.join(directory, f"{safe}.ck")


class CheckpointStore:
    """Atomic two-generation checkpoint files under one directory."""

    def __init__(self, directory: str, plan=None):
        self.dir = directory
        self.plan = plan        # optional FaultPlan ("checkpoint.corrupt")
        os.makedirs(directory, exist_ok=True)
        self.gc()

    def gc(self) -> int:
        """Bound the store to its two-generation contract on startup.

        A crash between the tmp write and the rename leaves an orphaned
        ``*.ck.tmp`` blob; a crash *loop* over changing job ids leaks
        them without bound.  Only files this store itself creates are
        touched (``<id>.ck.tmp``), and only at init — save() is about
        to overwrite its own tmp anyway, so a single-process store can
        never GC a live write.  Returns the number of blobs removed."""
        removed = 0
        try:
            names = os.listdir(self.dir)
        except OSError:
            return 0
        for name in names:
            if not name.endswith(".ck.tmp"):
                continue
            try:
                os.remove(os.path.join(self.dir, name))
                removed += 1
            except OSError:
                continue
        if removed:
            get_metrics().counter(
                "route.resil.checkpoint_gc").inc(removed)
            tr = get_tracer()
            if tr is not None:
                tr.instant("route.resil.checkpoint.gc", cat="resil",
                           removed=removed)
        return removed

    def _path(self, job_id: str) -> str:
        return checkpoint_file(self.dir, job_id)

    def save(self, job_id: str, ck) -> str:
        path = self._path(job_id)
        blob = _encode(ck)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        # Rotate current -> prev before installing, so a verification
        # failure on the new file can still recover the old state.
        if os.path.exists(path):
            os.replace(path, path + ".prev")
        os.replace(tmp, path)
        get_metrics().counter("route.resil.checkpoint_writes").inc()
        tr = get_tracer()
        if tr is not None:
            tr.instant("route.resil.checkpoint.write", cat="resil",
                       job=str(job_id), bytes=len(blob))
        if self.plan is not None:
            f = self.plan.fire("checkpoint.corrupt", detail=str(job_id))
            if f is not None:
                # Tear the file we just wrote: keep the header, drop
                # half the payload.  load() must detect and fall back.
                with open(path, "r+b") as fh:
                    fh.truncate(max(len(_MAGIC) + 65, len(blob) // 2))
        return path

    def load(self, job_id: str):
        """Return the newest verifiable checkpoint, or None.

        Counts a recovery on success; counts a fallback each time a
        generation fails verification and an older one is tried.
        """
        m = get_metrics()
        path = self._path(job_id)
        for cand in (path, path + ".prev"):
            try:
                with open(cand, "rb") as f:
                    blob = f.read()
            except OSError:
                continue
            try:
                ck = _decode(blob)
            except (ValueError, pickle.UnpicklingError, EOFError):
                m.counter("route.resil.checkpoint_fallbacks").inc()
                tr = get_tracer()
                if tr is not None:
                    tr.instant("route.resil.checkpoint.fallback",
                               cat="resil", file=cand)
                continue
            m.counter("route.resil.checkpoint_recoveries").inc()
            tr = get_tracer()
            if tr is not None:
                tr.instant("route.resil.checkpoint.recover", cat="resil",
                           job=str(job_id), file=cand)
            return ck
        return None

    def drop(self, job_id: str) -> None:
        path = self._path(job_id)
        for cand in (path, path + ".prev", path + ".tmp"):
            try:
                os.remove(cand)
            except OSError:
                pass
