"""The torch port's native cut solver against the JAX package's.

The port builds ``native/cutsolver.cc`` with ``g++`` at first use into
``build/`` (``cutter/native_solver.py``); the JAX package loads its own
prebuilt copy.  On the cases of ``tests/test_native_solver.py`` both
return the same plan, bit for bit; the port's ``solve`` routes as the
JAX package's does; a failed build raises.
"""
import pathlib
import random
import subprocess
import sys

import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.graph import (  # noqa: E501
    read_circuit as j_read_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.native_solver import (  # noqa: E501
    solve_native as j_solve_native,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.solver import (  # noqa: E501
    SolverConfig as JSolverConfig,
    plan_signature as j_plan_signature,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter import (  # noqa: E501
    gamma,
    native_solver,
    solver,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
    Cutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.graph import (  # noqa: E501
    read_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
    genCirc,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.plans import (  # noqa: E501
    load_plan,
)
from torch_port_common import to_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = "hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch"


def random_config(circ, seed):
    """tests/test_native_solver.py's random configuration."""
    rng = random.Random(seed)
    p = rng.choice([2, 3])
    cap = rng.randint(max(2, circ.num_qubits // p), circ.num_qubits)
    return JSolverConfig(
        num_partitions=p,
        caps=[cap] * p,
        max_n_cuts=rng.choice([2, 3, 5]),
        max_n_qpd_cuts=rng.choice([None, 5]),
        max_cuts_per_partition=rng.choice([None, 5]),
        spare_capacity=rng.choice([None, 0, 1, cap * p - circ.num_qubits]),
    )


def _port_cfg(jcfg):
    return solver.SolverConfig(
        num_partitions=jcfg.num_partitions, caps=list(jcfg.caps),
        force_n_wire_cuts=jcfg.force_n_wire_cuts,
        force_n_gate_cuts=jcfg.force_n_gate_cuts,
        max_n_cuts=jcfg.max_n_cuts, max_n_qpd_cuts=jcfg.max_n_qpd_cuts,
        max_cuts_per_partition=jcfg.max_cuts_per_partition,
        spare_capacity=jcfg.spare_capacity)


def _same_plan(want, got):
    if want is None or got is None:
        return want is None and got is None
    return (j_plan_signature(want) == solver.plan_signature(got)
            and vars(want.metrics) == vars(got.metrics)
            and want.soft_satisfied == got.soft_satisfied)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name,n", [("ghz", 6), ("bv", 5), ("qft", 5),
                                    ("hwe", 6), ("add", 6)])
def test_native_plan_equals_jax_native_plan(name, n, seed):
    jcirc = j_gen_circ(name, n, 1).decompose()
    jcfg = random_config(jcirc, seed)
    want = j_solve_native(j_read_circuit(jcirc), jcfg)
    got = native_solver.solve_native(read_circuit(to_port(jcirc)),
                                     _port_cfg(jcfg))
    assert _same_plan(want, got)


def test_native_unsat_as_jax():
    jcirc = j_gen_circ("ghz", 4, 1).decompose()
    jcfg = JSolverConfig(2, [2, 2], force_n_wire_cuts=0,
                         force_n_gate_cuts=0, max_n_cuts=1)
    assert j_solve_native(j_read_circuit(jcirc), jcfg) is None
    assert native_solver.solve_native(read_circuit(to_port(jcirc)),
                                      _port_cfg(jcfg)) is None


def test_cutter_resolves_the_stored_ghz40_plan():
    """The port's ``Cutter`` (native route) re-solves ghz-40 P2 Q20 to
    the plan stored in the package."""
    cutter = Cutter(genCirc("ghz", 40, 1), maxNPartitions=2,
                    maxNQubitsPerPartition=20, maxNQpdCuts=5, maxNCuts=5,
                    maxCutsPerPartitions=5)
    assert cutter.solve()
    stored = load_plan("ghz40_p2_q20")
    assert solver.plan_signature(cutter.plan) == \
        solver.plan_signature(stored)
    assert vars(cutter.plan.metrics) == vars(stored.metrics)


def test_library_is_built_under_build_and_never_the_jax_copy():
    """In a process that imports only the port, a solve maps one
    ``libcutsolver`` library, the one under the repository's
    ``build/``, named by the hash of source and flags."""
    code = (
        f"from {PORT}.cutter import native_solver\n"
        f"from {PORT}.cutter.cutter import Cutter\n"
        f"from {PORT}.models.zoo import genCirc\n"
        "assert Cutter(genCirc('ghz', 8, 1), maxNPartitions=2, "
        "maxNQubitsPerPartition=5).solve()\n"
        "maps = open('/proc/self/maps').read().split()\n"
        "libs = sorted({p for p in maps if 'libcutsolver' in p})\n"
        "print(libs)\n"
        "assert libs == [str(native_solver.library_path())], libs\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    path = native_solver.library_path()
    assert path.parent == ROOT / "build"
    assert path.name.startswith("libcutsolver_") and path.is_file()
    assert "_native" not in str(path)


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    bad = tmp_path / "cutsolver.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_solver, "SOURCE", bad)
    monkeypatch.setattr(native_solver, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native_solver, "_lib", None)
    with pytest.raises(RuntimeError, match="failed .*\n.*error"):
        native_solver.load()
    # no half-written library is left behind
    assert list((tmp_path / "build").iterdir()) == []


@pytest.mark.parametrize("case", ["default", "exclude", "costs", "gamma",
                                  "empty"])
def test_solve_routes_as_jax(case, monkeypatch):
    """``solve`` takes the native solver unless gamma mode, no vertices,
    excluded plans or a custom cost model ask for the Python search
    (JAX ``cutter/solver.py:344-359``)."""
    calls = []
    for mod, name in ((native_solver, "solve_native"),
                      (solver, "solve_python")):
        monkeypatch.setattr(mod, name, lambda g, c, _n=name:
                            calls.append(_n))
    monkeypatch.setattr(gamma, "solve_gamma",
                        lambda g, c: calls.append("solve_gamma"))
    graph = read_circuit(genCirc("ghz", 6, 1).decompose())
    cfg = solver.SolverConfig(num_partitions=2, caps=[4, 4])
    if case == "exclude":
        cfg.exclude = frozenset({((0,), ())})
    elif case == "costs":
        cfg = solver.SolverConfig(num_partitions=2, caps=[4, 4],
                                  gate_qpd_cost=(9, 0, 0))
    elif case == "gamma":
        cfg.gamma_mode = True
    elif case == "empty":
        graph = read_circuit(genCirc("ghz", 1, 1).decompose())
        assert graph.num_vertices == 0
    solver.solve(graph, cfg)
    assert calls == [{"default": "solve_native", "gamma": "solve_gamma"}
                     .get(case, "solve_python")]
