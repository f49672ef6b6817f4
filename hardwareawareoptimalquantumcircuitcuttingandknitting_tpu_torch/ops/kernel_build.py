"""Build, bind and feed the package's hand-written CUDA kernels.

Every kernel source in ``csrc/`` has a plain C interface.  It is compiled
at first use with ``nvcc`` for ``sm_90a`` into a shared library under
``build/`` (named by the hash of the source and of the headers in
``csrc/`` it may include, so an edit of either rebuilds) and loaded with
``ctypes``.  Nothing here runs when a module is imported.

The launch side the wrappers share sits here too: the width gates and
:func:`launch_geometry` of the variant and collapse kernels,
:func:`upload` for a plan's tables and :func:`run_starts` for a run
table built on the device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from ..convert import to_device

# The variant kernel's width gate: up to 15 qubits the state is on chip,
# from 16 to 20 it lives in a global scratch that a cluster of CTAs
# shares.  Wider fragments need the segmented blocked kernel.
MAX_QUBITS = 20
CLUSTER_QUBITS = 15  # the width a cluster of two CTAs holds on chip

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD = pathlib.Path(__file__).resolve().parent.parent.parent / "build"


class KernelLibrary:
    """One ``csrc/<stem>.cu`` and its shared library, built and loaded
    once per process.  ``bind(lib)`` declares the argument types of the
    exported functions; ``error_string`` names the export that turns a
    CUDA error code into text.  ``log`` holds the compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) when this process
    built the library."""

    def __init__(self, stem: str, bind, error_string: str):
        self.stem = stem
        self.source = _CSRC / f"{stem}.cu"
        self._bind = bind
        self._error_string = error_string
        self.lib = None
        self.log = ""
        self.path = None
        self._pending = None  # (process, temporary output, final output)

    def start_build(self) -> None:
        """Start ``nvcc`` for this source without waiting (so several
        sources compile side by side); :meth:`load` collects it.  No-op
        when the library is loaded, built or already building."""
        if self.lib is not None or self._pending is not None:
            return
        sha = hashlib.sha256(self.source.read_bytes())
        for header in sorted(_CSRC.glob("*.cuh")):
            sha.update(header.read_bytes())
        digest = sha.hexdigest()[:12]
        so = _BUILD / f"lib{self.stem}_{digest}.so"
        self.path = so
        if so.exists():
            return
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        _BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, str(self.source)]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError:
            os.unlink(tmp)
            raise
        self._pending = (proc, tmp, so)

    def load(self):
        """The ``ctypes`` library, built first if need be.  Raises
        RuntimeError with the compiler's output when the build fails."""
        if self.lib is not None:
            return self.lib
        self.start_build()
        if self._pending is not None:
            proc, tmp, so = self._pending
            self._pending = None
            out, _ = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on "
                    f"{self.source.name}:\n{out}"
                )
            os.replace(tmp, so)
            self.log = out
        lib = ctypes.CDLL(str(self.path))
        self._bind(lib)
        err = getattr(lib, self._error_string)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self.lib = lib
        return lib

    def error_text(self, code: int) -> str:
        return getattr(self.lib, self._error_string)(code).decode()


def build_all(libraries) -> None:
    """Build and load several kernel libraries, their compilers running
    side by side."""
    for lib in libraries:
        lib.start_build()
    for lib in libraries:
        lib.load()


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise ValueError unless ``t`` is what a kernel takes: on
    ``device``, of ``dtype`` and ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def upload(table, device) -> torch.Tensor:
    """A plan's numpy table on ``device``; an empty one as one zero row
    of its shape, so a kernel is always handed a valid pointer."""
    table = np.asarray(table)
    if table.size == 0:
        table = np.zeros((1,) + table.shape[1:], table.dtype)
    return to_device(table, device)


def launch_geometry(n: int) -> tuple[int, int, bool]:
    """``(threads, csize, use_smem)`` of a launch of the variant or the
    collapse kernel: the state is split over ``csize`` CTAs (2 at n = 15,
    else 1; past n = 15 the variant kernel's cluster is
    ``variant_kernel.cluster_size``'s), held in shared memory up to
    n = 15 (``use_smem``); a CTA has 8 amplitudes of its share a thread
    (at least 32 threads, at most 512: 32 amplitudes a thread at n = 14
    and 15, all in the collapse kernel's register checkpoint), so narrow
    states leave registers for more CTAs an SM."""
    csize = 2 if n == CLUSTER_QUBITS else 1
    threads = min(512, max(32, ((1 << n) // csize) // 8))
    return threads, csize, n <= CLUSTER_QUBITS


def run_starts(heads: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(starts [C + 1] int64, count [1] int32)`` of the runs that the
    ``[C]`` bool ``heads`` open, on their device with no wait for them:
    run ``r`` starts at row ``starts[r]``, and ``starts[count:]`` are all
    ``C``, so ``starts[1:] - starts[:-1]`` is each run's length (0 past
    the last run)."""
    c = heads.shape[0]
    rid = torch.cumsum(heads, dim=0) - 1
    # rows that open no run land past the end, and starts[R] keeps its
    # fill c, the end of the last run
    starts = torch.full((c + 2,), c, dtype=torch.int64, device=heads.device)
    starts.scatter_(0, torch.where(heads, rid, c + 1),
                    torch.arange(c, device=heads.device))
    return starts[:c + 1], (rid[-1:] + 1).to(torch.int32)
