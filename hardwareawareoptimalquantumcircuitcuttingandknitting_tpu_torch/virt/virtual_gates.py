"""Virtual-gate / wire-cut instruction payloads.

Replaces the reference's qiskit Instruction subclasses
(third_party/qvm/qvm/virtual_gates.py:9-15,17-55,127-150) with plain payload
objects attached to IR instructions via ``Instruction.op``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .tables import VGateSpec, spec_for


@dataclass
class VirtualGateOp:
    """Payload of an ``Instruction(name="vgate", qubits=[a, b])``."""

    base_name: str               # cx / cy / cz / rzz / cp / move
    params: tuple[float, ...] = ()
    label: str = ""
    teleport: bool = False       # plan-level only, mirroring the " TELE"
                                 # label quirk (Cutter.py:574,587)
    _spec: VGateSpec | None = field(default=None, repr=False)

    @property
    def spec(self) -> VGateSpec:
        if self._spec is None:
            self._spec = spec_for(self.base_name, self.params)
        return self._spec

    @property
    def num_instantiations(self) -> int:
        return self.spec.num_instantiations


@dataclass
class WireCutMark:
    """Payload of an ``Instruction(name="wirecut", qubits=[q])`` marker,
    mirroring the reference's WireCut barrier (virtual_gates.py:9-15)."""

    label: str = ""
    teleport: bool = False
