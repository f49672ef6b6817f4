"""``convert`` carries a ParamRef's theta reference across packages.

A parameterised circuit built with the JAX package keeps, in the port,
every ``ParamRef``'s ``index``, ``base``, ``scale`` and ``shift`` (gates
and cut gates alike), while plain floats stay plain floats.
"""
import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
    Instruction as JInstruction,
    ParamRef as JParamRef,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_gates import (  # noqa: E501
    VirtualGateOp as JVirtualGateOp,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
    ParamRef,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_from_instructions,
    circuit_to_instructions,
)


def _refs(circ):
    out = []
    for ins in circ.instructions:
        params = ins.op.params if ins.name == "vgate" else ins.params
        out.extend(params)
    return out


def _circuit():
    c = JCircuit(3, 3)
    c.ry(JParamRef(0, 0.8), 0)
    c.rz(JParamRef(3, 0.8).scaled(0.5), 1)
    c.rx(JParamRef(1, -1.3).scaled(-2.0).shifted(np.pi / 4), 2)
    c.u(0.1, JParamRef(2, 0.4), 0.3, 0)
    c.cx(0, 1)
    c.append(JInstruction("vgate", [1, 2], op=JVirtualGateOp(
        "rzz", params=(JParamRef(4, 0.6),))))
    c.append(JInstruction("vgate", [0, 2], op=JVirtualGateOp(
        "cp", params=(0.7,))))
    return c


@pytest.mark.parametrize("hops", [1, 2], ids=["jax_to_port", "round_trip"])
def test_param_refs_cross_with_index_base_scale_shift(hops):
    src = _circuit()
    circ = src
    for _ in range(hops):
        circ = circuit_from_instructions(*circuit_to_instructions(circ))
    want, got = _refs(src), _refs(circ)
    assert len(got) == len(want) == 8
    for w, g in zip(want, got):
        assert float(g) == pytest.approx(float(w), abs=1e-12)
        if isinstance(w, JParamRef):
            assert isinstance(g, ParamRef)
            assert (g.index, g.scale, g.shift) == (w.index, w.scale, w.shift)
            assert g.base == pytest.approx(w.base, abs=1e-12)
        else:
            assert type(g) is float


def test_instruction_data_is_plain():
    """The crossing form holds no ParamRef object: a dict per reference,
    a float otherwise."""
    _, _, _, instrs = circuit_to_instructions(_circuit())
    assert instrs[0]["params"] == [
        {"index": 0, "base": 0.8, "scale": 1.0, "shift": 0.0}]
    assert instrs[3]["params"][0] == 0.1
    assert type(instrs[3]["params"][0]) is float
    assert instrs[5]["op"]["params"][0]["index"] == 4
    assert instrs[6]["op"]["params"] == [0.7]
