"""ctypes bindings for the native C++ cut solver (native/cutsolver.cc).

Port of the JAX package's ``cutter/native_solver.py``: the same
``solve_cut`` call and the same results.  The library is built at first
use with the host's ``g++`` from ``native/cutsolver.cc``, read in place,
into the repository's ``build/``, named by the hash of the source and of
the compiler flags (as ``ops/kernel_build.py`` names its CUDA libraries).
The compiler writes a temporary file that is renamed into place, so
processes that build at once each load a whole library.  A failed build
raises RuntimeError with the compiler's output: the port does not fall
back to the pure-Python search in silence.  The search is integer work,
so the flags leave out ``-march=native`` and the library runs on any
x86-64 host.  Nothing here runs when the module is imported.
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

from .graph import WIRE, CutGraph
from .plan import CutDecision, CutPlan, PlanMetrics

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "cutsolver.cc"
_BUILD = _ROOT / "build"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lib = None


def library_path() -> pathlib.Path:
    """Where the library for this source and these flags lives."""
    sha = hashlib.sha256(SOURCE.read_bytes())
    sha.update(" ".join(FLAGS).encode())
    return _BUILD / f"libcutsolver_{sha.hexdigest()[:12]}.so"


def _build(so: pathlib.Path) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("native cut solver: no g++ on PATH to build "
                           f"{SOURCE}")
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"native cut solver: {cxx} failed ({res.returncode}) on "
                f"{SOURCE}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The ``ctypes`` library, built first if need be."""
    global _lib
    if _lib is not None:
        return _lib
    if not SOURCE.is_file():
        raise RuntimeError(f"native cut solver: source {SOURCE} not found")
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    lib.solve_cut.restype = ctypes.c_int
    _lib = lib
    return lib


def solve_native(graph: CutGraph, cfg) -> CutPlan | None:
    lib = load()
    nv = graph.num_vertices
    if nv == 0:
        return None
    # same invalid-config behavior as the Python twin (solver.py, Cutter.py:364)
    assert cfg.num_partitions <= nv
    ne = len(graph.edges)
    i32 = lambda xs: np.asarray(xs, dtype=np.int32)
    i64 = lambda xs: np.asarray(xs, dtype=np.int64)

    eu = i32([e[0] for e in graph.edges])
    ev = i32([e[1] for e in graph.edges])
    ek = i32([e[2] for e in graph.edges])
    init = i32(graph.initial)
    caps = i64(cfg.caps)

    out_assign = np.zeros(nv, dtype=np.int32)
    out_cu = np.zeros(ne, dtype=np.int32)
    out_cv = np.zeros(ne, dtype=np.int32)
    out_ck = np.zeros(ne, dtype=np.int32)
    out_ct = np.zeros(ne, dtype=np.int32)
    out_nc = np.zeros(1, dtype=np.int32)
    out_metrics = np.zeros(8, dtype=np.int64)
    out_qp = np.zeros(cfg.num_partitions, dtype=np.int64)
    out_cp = np.zeros(cfg.num_partitions, dtype=np.int64)

    def ptr(arr):
        return arr.ctypes.data_as(ctypes.c_void_p)

    def opt(x):
        return -1 if x is None else int(x)

    ok = lib.solve_cut(
        nv, ne, ptr(eu), ptr(ev), ptr(ek), len(init), ptr(init),
        cfg.num_partitions, ptr(caps),
        opt(cfg.force_n_wire_cuts), opt(cfg.force_n_gate_cuts),
        opt(cfg.max_n_cuts), opt(cfg.max_n_qpd_cuts),
        opt(cfg.max_cuts_per_partition), opt(cfg.spare_capacity),
        ptr(out_assign), ptr(out_cu), ptr(out_cv), ptr(out_ck), ptr(out_ct),
        ptr(out_nc), ptr(out_metrics), ptr(out_qp), ptr(out_cp),
    )
    if ok == -2:
        raise ValueError(
            "native solver: a search leaf accumulated more than 31 cut "
            "edges with teleport enumeration enabled — tighten maxNCuts/"
            "maxNQpdCuts or use the pure-Python solver"
        )
    if not ok:
        return None

    nc = int(out_nc[0])
    cuts = [
        CutDecision(
            (int(out_cu[i]), int(out_cv[i])),
            "wire" if out_ck[i] == WIRE else "gate",
            bool(out_ct[i]),
        )
        for i in range(nc)
    ]
    metrics = PlanMetrics(
        S=int(out_metrics[0]), A=int(out_metrics[1]), L=int(out_metrics[2]),
        Q=int(out_metrics[3]), C=int(out_metrics[4]),
        Q_p=[int(x) for x in out_qp], C_p=[int(x) for x in out_cp],
        n_wire_cuts=int(out_metrics[5]), n_gate_cuts=int(out_metrics[6]),
    )
    return CutPlan(
        cfg.num_partitions, [int(x) for x in out_assign], cuts, metrics,
        bool(out_metrics[7]),
    )
