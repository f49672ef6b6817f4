"""The torch port's heuristic compiler against the JAX package's.

Every case of ``tests/test_compiler.py`` runs through both packages from
the same circuit: the cut circuits are equal instruction for instruction
(names, qubits, params, virtual-gate ops, registers), and the port's knit
meets the uncut oracle.  The two ``standard_pipeline`` compiles of the
card's smoke (sup-20 and ghz-24) are equal with their ``PassLedger``
stages, and the Kernighan-Lin partitions are equal under the same
``random.seed``.  The port runs on ``models/graphs.py`` in place of
networkx; the JAX package's knit is held against the port's on two
cases only (its runs are the slow part).
"""
import random

import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.compiler import (
    compiler as j_compiler,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.compiler import (
    dag as j_dag,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.compiler import (
    partition as j_partition,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.compiler import (
    passes as j_passes,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.compiler import (
    qubit_reuser as j_reuser,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.run import (
    run_virtual_circuit as j_run,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.compiler import (  # noqa: E501
    compiler as t_compiler,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.compiler import (  # noqa: E501
    dag as t_dag,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.compiler import (  # noqa: E501
    partition as t_partition,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.compiler import (  # noqa: E501
    passes as t_passes,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.compiler import (  # noqa: E501
    qubit_reuser as t_reuser,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.compiler.types import (  # noqa: E501
    num_virtual_gates,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_to_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    hellinger_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
    genCirc as t_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    simulate_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from torch_port_common import to_port


def ghz(n):
    c = JCircuit(n, n)
    c.h(0)
    for i in range(n - 1):
        c.cx(i, i + 1)
    for q in range(n):
        c.measure(q, q)
    return c


def linear_cz(n, theta=0.7):
    c = JCircuit(n, n)
    for q in range(n):
        c.h(q)
    for i in range(n - 1):
        c.cz(i, i + 1)
        c.rz(theta, i)
    for q in range(n):
        c.measure(q, q)
    return c


def chain_1q():
    c = JCircuit(3, 3)
    c.h(0)
    c.cx(0, 1)
    c.h(1)
    c.cx(1, 2)
    for q in range(3):
        c.measure(q, q)
    return c


def minimizer_circ():
    c = JCircuit(4, 0)
    c.cx(0, 1)
    c.h(0)
    c.cx(2, 3)
    c.cx(1, 2)
    return c


def _same(a, b) -> bool:
    return circuit_to_instructions(a) == circuit_to_instructions(b)


def _oracle(circ, cut_or_virt, tol=1e-6):
    """The port's knit of a cut circuit (or VirtualCircuit) on the CPU
    against the port's uncut oracle."""
    virt = (cut_or_virt if isinstance(cut_or_virt, TVirtualCircuit)
            else TVirtualCircuit(cut_or_virt))
    knitted, _ = run_virtual_circuit(virt, project=False, device="cpu")
    fid = hellinger_fidelity(simulate_circuit(circ, device="cpu"), knitted)
    assert fid > 1 - tol, fid
    return knitted


# name: (circuit maker, run(passes module, reuser module, circuit))
CASES = {
    "optimal_decomposition": (
        lambda: ghz(6),
        lambda p, r, c: p.OptimalDecompositionPass(3).run(c, budget=5)),
    "bisection": (
        lambda: linear_cz(6),
        lambda p, r, c: p.BisectionPass(3).run(c, budget=5)),
    "optimal_wire_cutter": (
        lambda: ghz(4),
        lambda p, r, c: p.OptimalWireCutter(3).run(c, budget=5)),
    "greedy_dependency_breaker": (
        lambda: ghz(5),
        lambda p, r, c: p.GreedyDependencyBreaker().run(c, budget=2)),
    "qubit_reuse_identity": (
        lambda: ghz(6),
        lambda p, r, c: r.apply_qubit_reuse(
            p.OptimalDecompositionPass(3).run(c, budget=5), size_to_reach=2,
            dynamic=False)),
    "qubit_reuse_dynamic": (
        lambda: ghz(6),
        lambda p, r, c: r.apply_qubit_reuse(
            p.OptimalDecompositionPass(3).run(c, budget=5), size_to_reach=2,
            dynamic=True)),
    "wire_cutter_1q_chains": (
        chain_1q, lambda p, r, c: p.OptimalWireCutter(2).run(c, budget=10)),
    "minimizer": (
        minimizer_circ,
        lambda p, r, c: p.QubitDependencyMinimizer().run(c, budget=1)),
    "recut_keeps_vgates": (
        lambda: ghz(6),
        lambda p, r, c: p.BisectionPass(2).run(
            p.OptimalDecompositionPass(3).run(c, budget=10), budget=10)),
    "circular_dependency_breaker": (
        lambda: linear_cz(5),
        lambda p, r, c: p.CircularDependencyBreaker().run(c, budget=3)),
}
# the cases whose knit is also held to the JAX package's
KNIT_AGAINST_JAX = ("optimal_decomposition", "qubit_reuse_dynamic")


@pytest.mark.parametrize("case", sorted(CASES))
def test_cut_circuits_match_jax(case):
    """Each pass (and the qubit reuser) makes the JAX package's cut
    circuit, instruction for instruction; the port's knit of it meets the
    uncut oracle (and, on two cases, equals JAX's knit within 1e-6)."""
    build, run = CASES[case]
    jcirc = build()
    tcirc = to_port(jcirc)
    random.seed(0)
    jcut = run(j_passes, j_reuser, jcirc)
    random.seed(0)
    tcut = run(t_passes, t_reuser, tcirc)
    assert _same(jcut, tcut)
    if case == "minimizer":
        # one virtualization: the only optimal pick is cx(1, 2)
        assert num_virtual_gates(tcut) == 1
        deps = t_dag.DAG(tcut).qubit_dependencies()
        assert all(len(v) <= 1 for v in deps.values()), deps
        return
    if case == "circular_dependency_breaker":
        # the reference's latent bug, kept by both: nothing virtualized
        assert num_virtual_gates(tcut) == 0
        return
    got = _oracle(tcirc, tcut)
    if case in KNIT_AGAINST_JAX:
        want, _ = j_run(JVirtualCircuit(jcut), project=False)
        assert got.bit_positions == want.bit_positions
        np.testing.assert_allclose(got.values, np.asarray(want.values),
                                   atol=1e-6)


def test_cutter_compiler_end_to_end():
    jcirc = linear_cz(6)
    tcirc = to_port(jcirc)
    jv = j_compiler.CutterCompiler(3).run(jcirc, budget=4)
    tv = t_compiler.CutterCompiler(3).run(tcirc, budget=4)
    assert len(tv.fragments) >= 2
    assert _same(jv._circuit, tv._circuit)
    _oracle(tcirc, tv)


def test_dag_roundtrip_depth_and_dependencies():
    jcirc = ghz(4)
    jd, td = j_dag.DAG(jcirc), t_dag.DAG(to_port(jcirc))
    assert td.to_circuit().count_ops() == jcirc.count_ops()
    assert _same(jd.to_circuit(), td.to_circuit())
    assert td.depth == jd.depth == 4
    assert td.num_dependencies() == jd.num_dependencies() == 9
    assert td.qubit_dependencies() == jd.qubit_dependencies()
    assert list(td.nodes) == list(jd.nodes)
    assert [list(td.successors(n)) for n in td.nodes] == \
        [list(jd.successors(n)) for n in jd.nodes]


def test_depth_counts_condition_clbit():
    circ = JCircuit(2, 2)
    circ.measure(0, 0)
    circ.x(1).condition = (0, 1)
    assert to_port(circ).depth() == circ.depth() == 2


def test_gen_circ_seed_reproducible():
    def stream(circ):
        return [(i.name, tuple(i.qubits), tuple(i.params or ()))
                for i in circ.instructions]

    for name, n, d in [("ran", 6, 3), ("erd", 5, 1), ("hwe", 5, 1)]:
        a = t_gen_circ(name, n, d, seed=42)
        assert stream(a) == stream(t_gen_circ(name, n, d, seed=42)), name
        assert _same(j_gen_circ(name, n, d, seed=42), a), name


# the card smoke's two compiles under random.seed(0) (ghz-24 takes the KL
# bisection, which draws from it): (genCirc args, size, fragment sim widths,
# vgates, ledger vgates a stage) as the JAX package gives them
PIPELINES = {
    "sup20": (("sup", 20, 1, 0), 10, [15, 15], 5, [5, 0]),
    "ghz24": (("ghz", 24, 1, None), 12, [4, 6, 5, 7, 6, 6], 5, [3, 2, 0]),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_standard_pipeline_matches_jax(name):
    """``compile_circuit(standard_pipeline(q), circ, 5)``: the same cut
    circuit, fragments, vgates and ledger stages as the JAX package."""
    (kind, n, depth, seed), size, widths, vgates, added = PIPELINES[name]
    jcirc = j_gen_circ(kind, n, depth, seed=seed)
    tcirc = to_port(jcirc)
    random.seed(0)
    jv, jl = j_compiler.compile_circuit(
        j_compiler.standard_pipeline(size), jcirc, 5)
    random.seed(0)
    tv, tl = t_compiler.compile_circuit(
        t_compiler.standard_pipeline(size), tcirc, 5)
    assert _same(jv._circuit, tv._circuit)
    assert [p.num_sim_qubits for p in tv.programs.values()] == widths
    assert len(tv.vgates) == vgates
    assert [(r.pass_name, r.budget_before, r.vgates_added)
            for r in tl.records] == [
        (r.pass_name, r.budget_before, r.vgates_added) for r in jl.records]
    assert [r.vgates_added for r in tl.records] == added
    assert tl.remaining == jl.remaining


@pytest.mark.parametrize("size", [3, 10])
def test_kl_partitions_match_jax_under_one_seed(size):
    """The recursive KL bisection of sup-20's qubit graph under
    ``random.seed(k)``, k = 0..9: the same sets in the same order.  Size
    3 splits deep enough that a subgraph keeps fewer than half the
    qubits (networkx's set-order branch of ``subgraph``); size 10 splits
    the whole graph once (the graph-order branch)."""
    jcirc = j_gen_circ("sup", 20, 1, seed=0)
    jq = j_dag.dag_to_qcg(j_dag.DAG(jcirc))
    tq = t_dag.dag_to_qcg(t_dag.DAG(to_port(jcirc)))
    assert tq.edges(data=True) == list(jq.edges(data=True))
    for k in range(10):
        random.seed(k)
        want = j_partition._kl_partition(jq, 2, size)
        random.seed(k)
        got = t_partition._kl_partition(tq, 2, size)
        assert got == want, k
        assert [list(s) for s in got] == [list(s) for s in want], k
