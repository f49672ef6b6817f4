"""Cut-candidate graph construction.

Mirrors the reference's ``Cutter._readCirc`` (src/HwAwareCutter/Cutter.py:212-273):
every 2-qubit non-barrier gate contributes two vertices (one per operand
qubit); the pair forms a gate-cut candidate edge (G); consecutive uses of the
same qubit form wire-cut candidate edges (W); the first vertex on each qubit
goes into I.  Gates whose type is not virtualizable are kept as *uncuttable*
edges — unlike the reference (which silently omits them from the model,
Cutter.py:351-354), we constrain their endpoints to share a partition so the
solver can never produce an unrunnable split.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..circuit.circuit import Circuit, Instruction
from ..virt.tables import VIRTUAL_GATE_NAMES

WIRE = 0
GATE = 1
GATE_UNCUTTABLE = 2


@dataclass
class DagVertex:
    """Reference: DagVertex (Cutter.py:25-32)."""

    idx: int
    qubit: int
    nth_gate: int
    instr: Instruction
    v0_idx: int
    v1_idx: int


@dataclass
class CutGraph:
    vertices: list[DagVertex] = field(default_factory=list)
    # edges as (u, v, kind); u < v always
    edges: list[tuple[int, int, int]] = field(default_factory=list)
    initial: list[int] = field(default_factory=list)  # I (vertex indices)

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    def wire_edges(self):
        return [e for e in self.edges if e[2] == WIRE]

    def gate_edges(self):
        return [e for e in self.edges if e[2] == GATE]


def read_circuit(circ: Circuit) -> CutGraph:
    g = CutGraph()
    gate_counter: dict[int, int] = {}
    prev_vertex: dict[int, int] = {}

    for ins in circ.instructions:
        if ins.name == "barrier":
            continue
        if len(ins.qubits) > 2:
            # silently skipping would leave the operands unconstrained
            # and let the solver split an unsplittable gate (the rewrite
            # then fails with an opaque cross-fragment error)
            raise ValueError(
                f"{ins.name} acts on {len(ins.qubits)} qubits; decompose "
                "to <= 2-qubit gates before cutting"
            )
        if len(ins.qubits) != 2:
            continue
        if ins.name in ("vgate", "wirecut"):
            continue
        q0, q1 = ins.qubits
        v0_idx = len(g.vertices)
        v1_idx = v0_idx + 1
        if ins.label is None:
            # load-bearing: labels key the rewrite (Cutter.py:243-244)
            ins.label = f"{v0_idx}_{v1_idx}"
        g.vertices.append(
            DagVertex(v0_idx, q0, gate_counter.get(q0, 0), ins, v0_idx, v1_idx)
        )
        g.vertices.append(
            DagVertex(v1_idx, q1, gate_counter.get(q1, 0), ins, v0_idx, v1_idx)
        )
        gate_counter[q0] = gate_counter.get(q0, 0) + 1
        gate_counter[q1] = gate_counter.get(q1, 0) + 1

        kind = GATE if ins.name in VIRTUAL_GATE_NAMES else GATE_UNCUTTABLE
        g.edges.append((v0_idx, v1_idx, kind))

        for q, vi in ((q0, v0_idx), (q1, v1_idx)):
            if q in prev_vertex:
                g.edges.append((prev_vertex[q], vi, WIRE))
            else:
                g.initial.append(vi)
            prev_vertex[q] = vi

    _check_graph(g)
    return g


def _check_graph(g: CutGraph) -> None:
    """Reference: _checkGraph (Cutter.py:277-289)."""
    seen = set()
    for u, v, _ in g.edges:
        assert u < v < g.num_vertices
        seen.add(u)
        seen.add(v)
    assert seen == set(range(g.num_vertices)) or g.num_vertices == 0
    assert set(g.initial) <= set(range(g.num_vertices))
