"""Build and bind the package's hand-written CUDA kernels.

Every kernel source in ``csrc/`` has a plain C interface.  It is compiled
at first use with ``nvcc`` for ``sm_90a`` into a shared library under
``build/`` (named by the hash of the source and of the headers in
``csrc/`` it may include, so an edit of either rebuilds) and loaded with
``ctypes``.  Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

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
