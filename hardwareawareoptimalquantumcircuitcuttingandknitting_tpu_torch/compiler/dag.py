"""Instruction-level DAG IR for compiler passes.

Port of the JAX package's ``compiler/dag.py`` (a behavioural port of the
vendored qvm DAG, third_party/qvm/qvm/compiler/dag.py): a directed graph
whose nodes are instruction ids and whose edges follow qubit adjacency.
Qubits are flat indices into the circuit's registers.  The graph is
``models/graphs.DiGraph``, networkx's container and algorithms without
networkx, in networkx's node and edge order.
"""
from __future__ import annotations

import itertools
from typing import Iterator

from ..circuit.circuit import Circuit, Instruction, Register
from ..virt.tables import VIRTUAL_GATE_NAMES
from ..models.graphs import (
    DiGraph,
    Graph,
    connected_components,
    dag_longest_path_length,
    topological_sort,
)
from ..virt.virtual_gates import VirtualGateOp


class DAG(DiGraph):
    def __init__(self, circuit: Circuit, copy_circuit: bool = True):
        if copy_circuit:
            circuit = circuit.copy()
        super().__init__()
        instrs = [
            ins for ins in circuit.instructions
        ]
        for i, ins in enumerate(instrs):
            self.add_node(i, instr=ins)
        # edge u -> next op on each of u's qubits (dag.py:26-39)
        for i, ins in enumerate(instrs):
            for qubit in ins.qubits:
                for j in range(i + 1, len(instrs)):
                    if qubit in instrs[j].qubits:
                        self.add_edge(i, j)
                        break
        self._qregs: list[Register] = list(circuit.qregs)
        self._cregs: list[Register] = list(circuit.cregs)

    # ------------------------------------------------------------------
    @property
    def qubits(self) -> list[int]:
        return list(range(sum(r.size for r in self._qregs)))

    @property
    def qregs(self) -> list[Register]:
        return self._qregs

    @property
    def depth(self) -> int:
        return dag_longest_path_length(self)

    def add_qreg(self, reg: Register) -> None:
        if any(r.name == reg.name for r in self._qregs):
            raise ValueError(f"Quantum register {reg.name} already exists")
        self._qregs.append(reg)

    def get_node_instr(self, node: int) -> Instruction:
        return self.nodes[node]["instr"]

    def add_instr_node(self, instr: Instruction) -> int:
        new_id = max(self.nodes) + 1 if len(self.nodes) > 0 else 0
        self.add_node(new_id, instr=instr)
        return new_id

    def virtualize_node(self, node: int) -> None:
        """Swap a 2q gate for its virtual version (dag.py:84-86)."""
        ins = self.get_node_instr(node)
        if ins.name not in VIRTUAL_GATE_NAMES:
            raise ValueError(f"gate {ins.name} is not virtualizable")
        ins.op = VirtualGateOp(ins.name, tuple(ins.params), ins.label or "")
        ins.name = "vgate"

    def remove_1q_gates(self) -> None:
        for node in list(self.nodes):
            ins = self.get_node_instr(node)
            if len(ins.qubits) == 1:
                pred = next(self.predecessors(node), None)
                succ = next(self.successors(node), None)
                if pred is not None and succ is not None:
                    self.add_edge(pred, succ)
                self.remove_node(node)

    def remove_nodes_of_name(self, name: str) -> None:
        for node in list(self.nodes):
            if self.get_node_instr(node).name != name:
                continue
            preds = list(self.predecessors(node))
            succs = list(self.successors(node))
            for p, s in itertools.product(preds, succs):
                if set(self.get_node_instr(p).qubits) & set(
                    self.get_node_instr(s).qubits
                ):
                    self.add_edge(p, s)
            self.remove_node(node)

    def to_circuit(self) -> Circuit:
        circuit = Circuit(list(self._qregs), list(self._cregs))
        for i in topological_sort(self):
            circuit.instructions.append(self.get_node_instr(i))
        return circuit

    def copy(self) -> "DAG":
        return DAG(self.to_circuit())

    # ------------------------------------------------------------------
    def nodes_on_qubit(self, qubit: int) -> Iterator[int]:
        for node in topological_sort(self):
            if qubit in self.get_node_instr(node).qubits:
                yield node

    def instructions_on_qubit(self, qubit: int) -> Iterator[Instruction]:
        for node in self.nodes_on_qubit(qubit):
            yield self.get_node_instr(node)

    def qubit_dependencies(self) -> dict[int, set[int]]:
        """qubit -> set of qubits it (transitively) depends on
        (dag.py:97-118)."""
        depends_on: dict[int, set[int]] = {q: set() for q in self.qubits}
        for node in topological_sort(self):
            ins = self.get_node_instr(node)
            qs = ins.qubits
            # virtualized gates create no dependencies (the reference's
            # virtual gates are Barrier subclasses and fall to the
            # isinstance(Barrier) skip at dag.py:103)
            if len(qs) == 1 or ins.name in ("barrier", "vgate"):
                continue
            if len(qs) == 2:
                q1, q2 = qs
                add1 = depends_on[q2] | {q2}
                add2 = depends_on[q1] | {q1}
                depends_on[q1] |= add1
                depends_on[q2] |= add2
            else:
                raise ValueError("More than 2 qubits in instruction")
        for q in self.qubits:
            depends_on[q].discard(q)
        return depends_on

    def num_dependencies(self) -> int:
        return sum(len(d) for d in self.qubit_dependencies().values())

    def compact(self) -> None:
        """Drop idle qubits (dag.py:155-171)."""
        used: set[int] = set()
        for node in self.nodes:
            used.update(self.get_node_instr(node).qubits)
        mapping = {q: i for i, q in enumerate(sorted(used))}
        for node in self.nodes:
            ins = self.get_node_instr(node)
            ins.qubits = [mapping[q] for q in ins.qubits]
        self._qregs = [Register("q", len(used))]

    def fragment(self, fragments: list[set[int]] | None = None):
        """Regroup qubits into frag{i} registers (dag.py:185-203)."""
        if fragments is None:
            fragments = [
                set(c) for c in connected_components(dag_to_qcg(self))
            ]
        regs, mapping, off = [], {}, 0
        for i, qubits in enumerate(fragments):
            regs.append(Register(f"frag{i}", len(qubits)))
            for j, q in enumerate(sorted(qubits)):
                mapping[q] = off + j
            off += len(qubits)
        for node in self.nodes:
            ins = self.get_node_instr(node)
            ins.qubits = [mapping[q] for q in ins.qubits]
        self._qregs = regs
        return mapping


def dag_to_qcg(dag: DAG, use_qubit_idx: bool = False) -> Graph:
    """Qubit connectivity graph with 2q-gate-count edge weights
    (dag.py:206-228)."""
    graph = Graph()
    graph.add_nodes_from(dag.qubits)
    for node in dag.nodes:
        ins = dag.get_node_instr(node)
        # virtual gates and wire-cut marks are Barrier subclasses in the
        # reference and thus invisible to the QCG (dag.py:218-219) — that is
        # what lets fragment() split on connected components after cutting
        if ins.name in ("barrier", "vgate", "wirecut"):
            continue
        if len(ins.qubits) >= 2:
            for q1, q2 in itertools.combinations(ins.qubits, 2):
                if not graph.has_edge(q1, q2):
                    graph.add_edge(q1, q2, weight=0)
                graph[q1][q2]["weight"] += 1
    return graph
