"""The port's basis transpiler (``circuit/transpile.py``) against the JAX
package's: the same {cx, rz, sx, x} circuit instruction for instruction,
the same CNOT counts, and the port's oracle on the CPU holds the
transpiled circuit to the original."""
import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.transpile import (  # noqa: E501
    count_cnots as j_count_cnots,
    transpile_to_basis as j_transpile,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.random_circuit import (  # noqa: E501
    random_circuit as j_random_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.transpile import (  # noqa: E501
    BASIS,
    count_cnots,
    transpile_to_basis,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_to_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    hellinger_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    simulate_circuit,
)
from torch_port_common import to_port


def _special(kind):
    c = JCircuit(2, 2)
    if kind == "cz_swap":
        c.h(0)
        c.cz(0, 1)
        c.swap(0, 1)
    elif kind == "h_heavy":
        c.h(0)
        c.h(1)
        c.cx(0, 1)
        c.h(1)
    elif kind == "fsim":
        c.h(0)
        c.ry(0.4, 1)
        c.fsim(1.1, -0.4, 0, 1)
    elif kind == "condition":
        c.h(0)
        c.measure(0, 0)
        c.x(1).condition = (0, 1)
        c.measure(1, 1)
        return c
    c.measure(0, 0)
    c.measure(1, 1)
    return c


CASES = {
    **{f"random{s}": (lambda s=s: j_random_circuit(4, 6, seed=s,
                                                   measure=True))
       for s in range(3)},
    **{k: (lambda k=k: _special(k))
       for k in ("cz_swap", "h_heavy", "fsim", "condition")},
    "syc8": lambda: j_gen_circ("syc", 8, 2, seed=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("optimize", [True, False])
def test_transpile_matches_jax(case, optimize):
    jcirc = CASES[case]()
    tcirc = to_port(jcirc)
    want = j_transpile(jcirc, optimize=optimize)
    got = transpile_to_basis(tcirc, optimize=optimize)
    assert circuit_to_instructions(got) == circuit_to_instructions(want)
    assert count_cnots(got) == j_count_cnots(want)
    for ins in got.instructions:
        assert ins.name in BASIS + ("measure", "barrier", "reset"), ins
    if optimize:
        fid = hellinger_fidelity(simulate_circuit(tcirc, device="cpu"),
                                 simulate_circuit(got, device="cpu"))
        assert fid > 1 - 1e-6, fid
    if case == "cz_swap":
        assert count_cnots(got) == 4
