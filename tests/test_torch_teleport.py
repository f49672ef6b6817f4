"""Teleport execution in the torch port against the JAX package
(the twin of tests/test_teleport.py).

Each plan is solved by both packages' ``Cutter`` (the native solver in
both); the cut circuits, their teleport expansions
(``virt/teleport.py``) and the distributions of
``run_virtual_circuit(teleport="execute")`` agree: instructions equal,
values within 1e-6.
"""
import math

import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.solver import (  # noqa: E501
    plan_signature as j_plan_signature,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.run import (
    run_virtual_circuit as j_run,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.teleport import (  # noqa: E501
    expand_teleport_cuts as j_expand,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_to_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
    Cutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.solver import (  # noqa: E501
    plan_signature,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    hellinger_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    simulate_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.teleport import (  # noqa: E501
    expand_teleport_cuts,
    has_teleport_cuts,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit,
)
from torch_port_common import to_port


def _differential_circuit():
    """tests/test_teleport.py's 6-qubit circuit with a nontrivial output
    state, a cp across the cut."""
    circ = JCircuit(6, 6)
    for q in range(6):
        circ.h(q)
        circ.rz(0.3 + 0.2 * q, q)
    for q in range(5):
        circ.cx(q, q + 1)
    circ.cp(math.pi / 3, 0, 5)
    for q in range(6):
        circ.measure(q, q)
    return circ


# case: (circuit builder, Cutter keywords) as tests/test_teleport.py sets
# them up
CASES = {
    "ghz8_tele_only": (lambda: j_gen_circ("ghz", 8, 1), dict(
        maxNPartitions=2, maxNQubitsPerPartition=6, maxNQpdCuts=0)),
    "bv6_tele_only": (lambda: j_gen_circ("bv", 6, 1), dict(
        maxNPartitions=2, maxNQubitsPerPartition=5, maxNQpdCuts=0)),
    "mixed_ghz9": (lambda: j_gen_circ("ghz", 9, 1), dict(
        maxNPartitions=3, maxNQubitsPerPartition=4, maxNQpdCuts=1)),
    "wire_teledata": (lambda: j_gen_circ("ghz", 6, 1), dict(
        maxNPartitions=2, maxNQubitsPerPartition=5, maxNQpdCuts=0,
        forceNWireCuts=1, forceNGateCuts=0)),
    "differential": (_differential_circuit, dict(
        maxNPartitions=2, maxNQubitsPerPartition=5, maxNQpdCuts=0)),
}
_SOLVED = {}


def _solved(case):
    """(JAX circuit, port circuit, JAX cutter, port cutter), both solved
    on the same circuit."""
    if case not in _SOLVED:
        build, kw = CASES[case]
        jcirc = build()
        tcirc = to_port(jcirc)
        jcut, tcut = JCutter(jcirc, **kw), Cutter(tcirc, **kw)
        assert jcut.solve() and tcut.solve()
        _SOLVED[case] = (jcirc, tcirc, jcut, tcut)
    return _SOLVED[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_expansion_matches_jax(case):
    """Same plan, same cut circuit, same expanded circuit; the ancilla
    count is 2 a teleported gate cut and 1 a teleported wire cut."""
    _, _, jcut, tcut = _solved(case)
    assert plan_signature(tcut.plan) == j_plan_signature(jcut.plan)
    jc, tc = jcut.getResultCircs()[3], tcut.getResultCircs()[3]
    assert circuit_to_instructions(tc) == circuit_to_instructions(jc)
    assert has_teleport_cuts(tc)
    expanded = expand_teleport_cuts(tc)
    assert circuit_to_instructions(expanded) == \
        circuit_to_instructions(j_expand(jc))
    gate_tele = sum(1 for c in tcut.plan.cuts
                    if c.teleport and c.kind == "gate")
    wire_tele = sum(1 for c in tcut.plan.cuts
                    if c.teleport and c.kind == "wire")
    assert expanded.num_qubits == tc.num_qubits + 2 * gate_tele + wire_tele
    if all(c.teleport for c in tcut.plan.cuts):
        # a plan of teleports only leaves no variant fan-out
        virt = VirtualCircuit(expanded)
        assert virt.total_instantiations() == len(virt.fragments)


@pytest.mark.parametrize("case", sorted(CASES))
def test_execute_matches_jax(case):
    """``teleport="execute"`` gives JAX's distribution within 1e-6 and
    fidelity 1 - 1e-6 to the uncut oracle; the plan's metrics price a
    teleport at S x1 and 10 of latency."""
    jcirc, tcirc, jcut, tcut = _solved(case)
    m = tcut.plan.metrics
    n_tele = sum(1 for c in tcut.plan.cuts if c.teleport)
    assert n_tele >= 1 and m.L == 10 * n_tele
    want, _ = j_run(JVirtualCircuit(jcut.getResultCircs()[3]),
                    teleport="execute")
    got, _ = run_virtual_circuit(VirtualCircuit(tcut.getResultCircs()[3]),
                                 teleport="execute", device="cpu")
    assert got.bit_positions == want.bit_positions
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               atol=1e-6)
    oracle = simulate_circuit(tcirc, device="cpu")
    assert hellinger_fidelity(oracle, got) > 1 - 1e-6


def test_execute_equals_the_qpd_route():
    """The same plan through ``teleport="execute"`` and the QPD route
    gives the same distribution (tests/test_teleport.py's 2e-5)."""
    _, _, _, tcut = _solved("differential")
    virt = VirtualCircuit(tcut.getResultCircs()[3])
    tele, _ = run_virtual_circuit(virt, teleport="execute", device="cpu")
    qpd, _ = run_virtual_circuit(virt, teleport="qpd", device="cpu")
    np.testing.assert_allclose(tele.values, qpd.values, atol=2e-5)


def test_execute_is_a_no_op_without_teleport_cuts():
    circ = to_port(j_gen_circ("ghz", 6, 1))
    cutter = Cutter(circ, maxNPartitions=2, maxNQubitsPerPartition=3,
                    maxNQpdCuts=2, maxNCuts=2)
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    assert not has_teleport_cuts(cut)
    assert expand_teleport_cuts(cut) is cut
    virt = VirtualCircuit(cut)
    got, _ = run_virtual_circuit(virt, teleport="execute", device="cpu")
    want, _ = run_virtual_circuit(virt, device="cpu")
    np.testing.assert_array_equal(got.values, want.values)
    assert hellinger_fidelity(simulate_circuit(circ, device="cpu"),
                              got) > 1 - 1e-6


def test_execute_composes_with_the_sampled_engine():
    """The mixed plan's remaining QPD cut through the sampled engine
    (tests/test_teleport.py's settings), held against the port's exact
    result at 1 - 5e-3."""
    _, _, _, tcut = _solved("mixed_ghz9")
    virt = VirtualCircuit(tcut.getResultCircs()[3])
    exact, _ = run_virtual_circuit(virt, teleport="execute", device="cpu")
    dist, _ = run_virtual_circuit(
        virt, teleport="execute", engine="sampled", shots=20000,
        sample_method="lhs", sample_cv=True, device="cpu")
    assert hellinger_fidelity(exact, dist) > 1 - 5e-3
