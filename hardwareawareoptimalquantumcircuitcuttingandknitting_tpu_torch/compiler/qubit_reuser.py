"""Qubit-reuse distributed transpiler.

Behavioral port of qvm/compiler/distr_transpiler/qubit_reuser.py: shrink
fragments by resetting measured qubits and reusing them (optionally as a
dynamic measure + conditional-X), enabled by the engine's reset/c_if support.
"""
from __future__ import annotations

from itertools import permutations
from typing import Iterator

from ..circuit.circuit import Instruction
from ..models.graphs import has_path
from ..virt.virtual_circuit import VirtualCircuit
from .dag import DAG
from .types import DistributedTranspilerPass


class QubitReuser(DistributedTranspilerPass):
    """Deviation from the reference (qubit_reuser.py:13-26): our
    VirtualCircuit compiles fragment programs eagerly, so reuse runs on the
    *cut circuit* (restricted to pairs within one fragment register, with
    dependency checks on the full DAG) before VirtualCircuit construction.
    Use ``run_on_circuit``; ``run`` mirrors the reference signature by
    rebuilding the VirtualCircuit in place."""

    def __init__(self, size_to_reach: int, dynamic: bool = True) -> None:
        self._size_to_reach = size_to_reach
        self._dynamic = dynamic

    def run_on_circuit(self, cut_circuit):
        return apply_qubit_reuse(
            cut_circuit, self._size_to_reach, self._dynamic
        )

    def run(self, virt: VirtualCircuit) -> None:
        new_circ = self.run_on_circuit(virt._circuit)
        backends = dict(virt._backends)
        virt.__init__(new_circ)
        # fragment registers keep their names across reuse — restore the
        # user's backend mapping instead of silently resetting it (which
        # would make a later noisy run fall back to the ideal engine)
        for name, backend in backends.items():
            if backend is not None and name in virt._programs:
                virt.set_backend(name, backend)


def apply_qubit_reuse(circ, size_to_reach: int, dynamic: bool = True):
    """Per-fragment-register qubit reuse on a cut circuit."""
    dag = DAG(circ)
    offset = 0
    for reg in list(dag.qregs):
        reg_qubits = set(range(offset, offset + reg.size))
        offset += reg.size
        active = [
            q for q in reg_qubits
            if next(dag.nodes_on_qubit(q), None) is not None
        ]
        while len(active) > size_to_reach:
            pair = None
            for q, rq in permutations(active, 2):
                if not is_dependent_qubit(dag, rq, q):
                    pair = (q, rq)
                    break
            if pair is None:
                break
            reuse(dag, *pair)
            active.remove(pair[0])
    if dynamic:
        dynamic_measure_and_reset(dag)
    # rebuild shrunk fragment registers: keep only qubits still referenced
    used: set[int] = set()
    for node in dag.nodes:
        used.update(dag.get_node_instr(node).qubits)
    fragments = []
    offset = 0
    for reg in dag.qregs:
        frag = {q for q in range(offset, offset + reg.size) if q in used}
        offset += reg.size
        if frag:
            fragments.append(frag)
    dag.fragment(fragments)
    return dag.to_circuit()


def dynamic_measure_and_reset(dag: DAG) -> None:
    """measure;reset -> measure;X.c_if(clbit) (qubit_reuser.py:29-52)."""
    for node in list(dag.nodes):
        ins = dag.get_node_instr(node)
        if ins.name != "measure":
            continue
        clbit = ins.clbits[0]
        nxt = next(dag.successors(node), None)
        if nxt is None:
            continue
        nins = dag.get_node_instr(nxt)
        if nins.name != "reset":
            continue
        nins.name = "x"
        nins.condition = (clbit, 1)


def random_qubit_reuse(dag: DAG, size_to_reach: int = 1) -> None:
    """qubit_reuser.py:55-64."""
    num_qubits = len(dag.qubits)
    while num_qubits > size_to_reach:
        pair = next(find_valid_reuse_pairs(dag), None)
        if pair is None:
            break
        reuse(dag, *pair)
        dag.compact()
        num_qubits -= 1


def reuse(dag: DAG, qubit: int, reused_qubit: int) -> None:
    """qubit_reuser.py:67-94: append reset on ``reused_qubit`` after the last
    op of ``qubit``; rename ``qubit`` -> ``reused_qubit`` everywhere."""
    first_node = next(dag.nodes_on_qubit(reused_qubit))
    last_node = list(dag.nodes_on_qubit(qubit))[-1]
    reset_node = dag.add_instr_node(Instruction("reset", [reused_qubit]))
    dag.add_edge(last_node, reset_node)
    dag.add_edge(reset_node, first_node)
    for node in dag.nodes:
        ins = dag.get_node_instr(node)
        ins.qubits = [
            reused_qubit if q == qubit else q for q in ins.qubits
        ]


def is_dependent_qubit(dag: DAG, u_qubit: int, v_qubit: int) -> bool:
    """qubit_reuser.py:97-113."""
    u_node = next(dag.nodes_on_qubit(u_qubit))
    v_node = list(dag.nodes_on_qubit(v_qubit))[-1]
    return has_path(dag, u_node, v_node)


def find_valid_reuse_pairs(dag: DAG) -> Iterator[tuple[int, int]]:
    """qubit_reuser.py:116-126 (O(n^2))."""
    for qubit, reused_qubit in permutations(dag.qubits, 2):
        try:
            if not is_dependent_qubit(dag, reused_qubit, qubit):
                yield qubit, reused_qubit
        except (StopIteration, IndexError):
            # either qubit is idle (no ops on it): StopIteration from
            # next() on the first operand, IndexError from [-1] on the
            # second — both mean the pair cannot constrain a reuse
            continue
