"""Building and loading the port's hand-written CUDA sources.

Each source ``csrc/<name>.cu`` has a plain C interface; it is compiled
with nvcc for sm_90a into ``parallel_eda_tpu_torch/build/lib<name>.so``
at first use (or by chip_smoke.py, which starts every build at once)
and loaded with ctypes.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from typing import Callable

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")


def nvcc_path() -> str:
    p = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(p):
        raise RuntimeError("nvcc not found (needs the CUDA toolkit)")
    return p


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
        self._lib = None

    def command(self) -> list:
        """sm_90a, no FMA contraction (kernels round as their plain
        versions do), register/spill report on."""
        return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
                "-shared", "-Xcompiler", "-fPIC", "-o", self.path, self.src]

    def start_build(self) -> subprocess.Popen:
        """Start nvcc in the background; finish with finish_build()."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        self.info["t0"] = time.time()
        return subprocess.Popen(self.command(), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: subprocess.Popen) -> dict:
        out, _ = proc.communicate()
        self.info["seconds"] = time.time() - self.info.pop("t0")
        self.info["ptxas"] = [ln.strip() for ln in out.splitlines()
                              if "ptxas" in ln or "spill" in ln
                              or "Used" in ln]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {self.name}.cu failed "
                               f"({proc.returncode}):\n{out}")
        return self.info

    def get(self) -> ctypes.CDLL:
        """The loaded library, built from source first if missing or
        older than its source."""
        if self._lib is None:
            if (not os.path.exists(self.path) or os.path.getmtime(self.path)
                    < os.path.getmtime(self.src)):
                self.finish_build(self.start_build())
            lib = ctypes.CDLL(self.path)
            self.setup(lib)
            self._lib = lib
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
