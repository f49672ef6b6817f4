"""OpenQASM 2.0 in the torch port against the JAX package (the twin of
tests/test_qasm.py's eight tests).

The port's ``circuit/qasm.py`` parses the same text into the same
instructions (``convert.circuit_to_instructions``), writes the same text
character for character, and raises the same errors.
"""
import math

import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit import (
    qasm as j_qasm,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
    Instruction as JInstruction,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit import (  # noqa: E501
    qasm,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
    Circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_to_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
    Cutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
    genCirc,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    simulate_circuit,
)
from torch_port_common import to_port


def _same_parse(text):
    """Both packages' ``from_qasm`` on ``text``: the same instructions;
    returns the port's circuit."""
    got = qasm.from_qasm(text)
    assert circuit_to_instructions(got) == \
        circuit_to_instructions(j_qasm.from_qasm(text))
    return got


def _dist(circ):
    d = simulate_circuit(circ, device="cpu")
    return np.asarray(d.values), list(d.bit_positions)


def _same_error(text, match):
    with pytest.raises(ValueError, match=match) as want:
        j_qasm.from_qasm(text)
    with pytest.raises(ValueError, match=match) as got:
        qasm.from_qasm(text)
    assert str(got.value) == str(want.value)


def test_parse_basics_broadcast_and_defs():
    src = """
    OPENQASM 2.0;
    include "qelib1.inc";
    // a comment; with a semicolon
    gate bell a,b { h a; cx a,b; }
    gate tilt(theta) a { ry(theta/2) a; rz(-theta) a; }
    qreg q[3];
    creg c[3];
    bell q[0],q[1];
    tilt(pi/2) q[2];
    x q;            // broadcast over the whole register
    barrier q;
    measure q -> c;
    """
    circ = _same_parse(src)
    assert [i.name for i in circ.instructions] == [
        "h", "cx", "ry", "rz", "x", "x", "x", "barrier", "measure",
        "measure", "measure"]
    assert circ.instructions[2].params == [pytest.approx(math.pi / 4)]
    assert [i.clbits[0] for i in circ.instructions[-3:]] == [0, 1, 2]


@pytest.mark.parametrize("text,match", [
    ("qreg q[1]; creg c[2]; if (c==1) x q[0];", "single-bit"),
    ("qreg q[2]; mystery q[0],q[1];", "not supported"),
    ("qreg q[1]; opaque magic q;", "opaque"),
])
def test_parse_condition_and_errors(text, match):
    src = """
    OPENQASM 2.0;
    qreg q[2]; creg m[1]; creg c[2];
    h q[0];
    measure q[0] -> m[0];
    if (m==1) x q[1];
    measure q[1] -> c[1];
    """
    circ = _same_parse(src)
    cond = [i for i in circ.instructions if i.condition is not None]
    assert len(cond) == 1 and cond[0].condition == (0, 1)
    _same_error(text, match)


@pytest.mark.parametrize(
    "name,n,depth",
    [("ghz", 5, 1), ("hwe", 4, 1), ("bv", 4, 1), ("qft", 4, 1),
     ("add", 6, 1), ("syc", 4, 1), ("su", 4, 0)],
)
def test_zoo_roundtrip(name, n, depth):
    """The port's zoo circuit written as JAX writes it, read back as JAX
    reads it, with the same distribution within 1e-5."""
    circ = genCirc(name, n, depth, seed=3)
    text = qasm.to_qasm(circ)
    assert text == j_qasm.to_qasm(j_gen_circ(name, n, depth, seed=3))
    back = _same_parse(text)
    assert back.num_qubits == circ.num_qubits
    v0, p0 = _dist(circ)
    v1, p1 = _dist(back)
    assert p0 == p1
    np.testing.assert_allclose(v1, v0, atol=1e-5)


def test_export_defs_roundtrip():
    """sx / sxdg / iswap / fsim export as local definitions, the same
    text as JAX's, and come back with the same distribution."""
    c = JCircuit(2, 2)
    c.ry(0.7, 0)
    c.ry(1.1, 1)
    c.sx(0)
    c.append(JInstruction("sxdg", [1]))
    c.iswap(0, 1)
    c.fsim(0.4, 0.9, 0, 1)
    c.rx(0.3, 0)
    c.measure(0, 0)
    c.measure(1, 1)
    tc = to_port(c)
    text = qasm.to_qasm(tc)
    assert text == j_qasm.to_qasm(c)
    assert "gate fsim" in text and "gate iswap" in text
    v0, _ = _dist(tc)
    v1, _ = _dist(_same_parse(text))
    np.testing.assert_allclose(v1, v0, atol=1e-5)


def test_export_rejects_cut_circuits():
    kw = dict(maxNPartitions=2, maxNQubitsPerPartition=3, maxNQpdCuts=3,
              maxNCuts=3, maxCutsPerPartitions=3)
    jcut, tcut = JCutter(j_gen_circ("ghz", 4, 1), **kw), \
        Cutter(genCirc("ghz", 4, 1), **kw)
    assert jcut.solve() and tcut.solve()
    with pytest.raises(ValueError, match="not representable") as want:
        j_qasm.to_qasm(jcut.getResultCircs()[3])
    with pytest.raises(ValueError, match="not representable") as got:
        qasm.to_qasm(tcut.getResultCircs()[3])
    assert str(got.value) == str(want.value)
    assert qasm.to_qasm(genCirc("ghz", 4, 1)).startswith("OPENQASM 2.0;")


def _u3(t, p, lam):
    c, s = math.cos(t / 2), math.sin(t / 2)
    return np.array([[c, -np.exp(1j * lam) * s],
                     [np.exp(1j * p) * s, np.exp(1j * (p + lam)) * c]])


def _rot(axis, t):
    c, s = math.cos(t / 2), math.sin(t / 2)
    if axis == "x":
        return np.array([[c, -1j * s], [-1j * s, c]])
    return np.array([[c, -s], [s, c]])


def _ctrl(u):
    out = np.eye(4, dtype=complex)
    out[2:, 2:] = u
    return out


def test_qelib1_supplement_gates_exact():
    """ch / crx / cry / csx / cu3 / cu / rxx / ryy expand to the JAX
    package's instructions and to the exact unitaries (the numpy oracle of
    tests/test_qasm.py), cswap included."""
    th, ph, lam, gam = 0.7, 0.4, 1.1, 0.9
    h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    sx = 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]])
    xx = np.kron([[0, 1], [1, 0]], [[0, 1], [1, 0]]).astype(complex)
    yy = np.kron([[0, -1j], [1j, 0]], [[0, -1j], [1j, 0]]).astype(complex)
    eye4 = np.eye(4, dtype=complex)
    two_q = {
        "ch a,b": _ctrl(h),
        f"crx({th}) a,b": _ctrl(_rot("x", th)),
        f"cry({th}) a,b": _ctrl(_rot("y", th)),
        "csx a,b": _ctrl(sx),
        f"cu3({th},{ph},{lam}) a,b": _ctrl(_u3(th, ph, lam)),
        f"cu({th},{ph},{lam},{gam}) a,b":
            _ctrl(np.exp(1j * gam) * _u3(th, ph, lam)),
        f"rxx({th}) a,b": np.cos(th / 2) * eye4 - 1j * np.sin(th / 2) * xx,
        f"ryy({th}) a,b": np.cos(th / 2) * eye4 - 1j * np.sin(th / 2) * yy,
    }
    for stmt, want_u in two_q.items():
        src = ("OPENQASM 2.0;\nqreg q[2];\ncreg c[2];\n"
               "ry(0.9) q[0]; ry(0.4) q[1]; rz(0.5) q[1];\n"
               + stmt.replace("a,b", "q[0],q[1]") + ";\n"
               "ry(1.3) q[0]; rx(0.2) q[1];\nmeasure q -> c;\n")
        got = simulate_circuit(_same_parse(src), device="cpu")
        psi = np.zeros(4, complex)
        psi[0] = 1.0
        psi = np.kron(_rot("y", 0.9), np.eye(2)) @ psi
        psi = np.kron(np.eye(2), _rot("y", 0.4)) @ psi
        psi = np.kron(np.eye(2),
                      np.diag([np.exp(-0.25j), np.exp(0.25j)])) @ psi
        psi = want_u @ psi
        psi = np.kron(_rot("y", 1.3), np.eye(2)) @ psi
        psi = np.kron(np.eye(2), _rot("x", 0.2)) @ psi
        # big-endian oracle -> little-endian Distribution
        probs = (np.abs(psi) ** 2).reshape(2, 2).T.reshape(4)
        np.testing.assert_allclose(np.asarray(got.values), probs,
                                   atol=1e-5, err_msg=stmt)
    src = ("OPENQASM 2.0;\nqreg q[3];\ncreg c[3];\n"
           "x q[0]; x q[1];\ncswap q[0],q[1],q[2];\nmeasure q -> c;\n")
    d = simulate_circuit(_same_parse(src), device="cpu").to_dict()
    assert d.get(5, 0) == pytest.approx(1.0, abs=1e-6)


def test_cref_bounds_checked():
    _same_error("qreg q[1]; creg a[2]; creg b[2]; measure q[0] -> a[3];",
                "clbit index out of range")


def test_circuit_convenience_methods():
    """``Circuit.to_qasm`` / ``Circuit.from_qasm`` call the module, as in
    the JAX package."""
    c = genCirc("ghz", 4, 1)
    text = c.to_qasm()
    assert text == j_gen_circ("ghz", 4, 1).to_qasm()
    back = Circuit.from_qasm(text)
    assert circuit_to_instructions(back) == \
        circuit_to_instructions(JCircuit.from_qasm(text))
    v0, _ = _dist(c)
    v1, _ = _dist(back)
    np.testing.assert_allclose(v1, v0, atol=1e-6)
