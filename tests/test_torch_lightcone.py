"""The port's lightcone oracle (``circuit/lightcone.py``) against the JAX
package's, and BASELINE config #4 (sycamore-32) on the CPU: the knitted
8-clbit marginal of syc-32 (depth 1, P2 Q20: fragments of 18 and 14
qubits, no cut) against the oracle."""
import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.lightcone import (  # noqa: E501
    lightcone_circuit as j_lightcone_circuit,
    lightcone_marginal as j_lightcone_marginal,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.lightcone import (  # noqa: E501
    lightcone_circuit,
    lightcone_marginal,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_to_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    simulate_circuit,
)
from torch_port_common import to_port


def _marginal(values, positions, keep):
    vals = np.asarray(values, dtype=np.float64).reshape(-1)
    idx = np.arange(vals.size)
    key = np.zeros_like(idx)
    for j, p in enumerate(sorted(keep)):
        key |= ((idx >> positions.index(p)) & 1) << j
    return np.bincount(key, weights=vals, minlength=1 << len(keep))


def _ghz(n):
    circ = JCircuit(n, n)
    circ.h(0)
    for i in range(n - 1):
        circ.cx(i, i + 1)
    for q in range(n):
        circ.measure(q, q)
    return circ


@pytest.mark.parametrize("case", ["syc12", "ghz5", "syc32_d1"])
def test_lightcone_matches_jax(case):
    """The same sub-circuit and clbit map as the JAX package, and the
    marginal within 1e-6 of JAX's (syc-12 also of the port's full
    simulation; GHZ's last qubit reaches back through the whole chain)."""
    circ, keep = {
        "syc12": (j_gen_circ("syc", 12, 1), {0, 1}),
        "ghz5": (_ghz(5), {4}),
        "syc32_d1": (j_gen_circ("syc", 32, 1), set(range(8))),
    }[case]
    tcirc = to_port(circ)
    jsub, jmap = j_lightcone_circuit(circ, keep)
    sub, cmap = lightcone_circuit(tcirc, keep)
    assert cmap == jmap
    assert circuit_to_instructions(sub) == circuit_to_instructions(jsub)
    want = j_lightcone_marginal(circ, keep, precomputed=(jsub, jmap))
    got = lightcone_marginal(tcirc, keep, precomputed=(sub, cmap),
                             device="cpu")
    assert got.bit_positions == want.bit_positions == sorted(keep)
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               atol=1e-6)
    if case == "syc12":
        assert sub.num_qubits < tcirc.num_qubits
        full = simulate_circuit(tcirc, device="cpu")
        np.testing.assert_allclose(
            got.values, _marginal(full.values, full.bit_positions, keep),
            atol=1e-6)
    if case == "ghz5":
        assert sub.num_qubits == 5
        np.testing.assert_allclose(got.values, [0.5, 0.5], atol=1e-6)


def test_syc32_marginal_knit_against_lightcone():
    """BASELINE config #4: genCirc("syc", 32, 1) cut by the port's native
    solver at P2 Q20 (no cut: fragments of 18 and 14 qubits), the 8-clbit
    marginal through ``run_virtual_circuit(engine="pallas",
    keep_clbits=...)`` on the CPU (the kernel's plain version) against
    the lightcone oracle, 1e-5 (JAX's own bound)."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
        run_virtual_circuit,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
        VirtualCircuit,
    )

    circ = to_port(j_gen_circ("syc", 32, 1))
    cutter = Cutter(circ, maxNPartitions=2, maxNQubitsPerPartition=20,
                    maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    assert cutter.solve()
    virt = VirtualCircuit(cutter.getResultCircs()[3])
    assert not virt.vgates
    assert sorted(p.num_sim_qubits for p in virt.programs.values()) == \
        [14, 18]
    keep = set(range(8))
    marg, _ = run_virtual_circuit(virt, engine="pallas", keep_clbits=keep,
                                  device="cpu")
    oracle = lightcone_marginal(circ, keep, device="cpu")
    assert marg.bit_positions == oracle.bit_positions
    assert np.abs(marg.values - oracle.values).max() < 1e-5
