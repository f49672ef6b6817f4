"""Virtualization passes.

Behavioral ports of the vendored qvm compiler passes:
  * BisectionPass / OptimalDecompositionPass — gate virtualization via qubit
    partitioning (qvm/compiler/virtualization/gate_decomp.py:10-130); the
    ASP model is replaced by the exact optimiser in partition.py
  * OptimalWireCutter — wire cutting via gate-node partitioning
    (wire_decomp.py:12-133)
  * CircularDependencyBreaker / GreedyDependencyBreaker /
    QubitDependencyMinimizer — dependency reduction for qubit reuse
    (reduce_deps.py:24-167)
"""
from __future__ import annotations

import itertools

from ..circuit.circuit import Circuit, Instruction, Register
from ..models.graphs import topological_sort
from ..virt.tables import VIRTUAL_GATE_NAMES
from ..virt.virtual_gates import VirtualGateOp, WireCutMark
from .dag import DAG, dag_to_qcg
from .partition import (
    _kl_partition,
    optimal_gate_partition,
    optimal_qubit_partition,
)
from .types import VirtualizationPass, num_virtual_gates


def _decompose_qubit_sets(dag: DAG, qubit_sets: list[set]) -> int:
    """Virtualize every gate crossing the qubit partition
    (gate_decomp.py:118-130)."""
    vgates = 0
    for node in list(dag.nodes):
        ins = dag.get_node_instr(node)
        qubits = ins.qubits
        n_frags = sum(1 for s in qubit_sets if set(qubits) & s)
        if n_frags == 0:
            raise ValueError(f"No fragment found for qubits {qubits}.")
        # skip already-virtualized gates too: the reference's virtual gates
        # are Barrier subclasses, so its name check passes them over
        # (gate_decomp.py:128) — re-cutting a cut circuit must not crash
        if n_frags > 1 and ins.name not in ("barrier", "vgate"):
            dag.virtualize_node(node)
            vgates += 1
    return vgates


class BisectionPass(VirtualizationPass):
    """Recursive Kernighan–Lin bisection (gate_decomp.py:10-41)."""

    def __init__(self, size_to_reach: int) -> None:
        self._size_to_reach = size_to_reach

    def _partitions(self, dag: DAG) -> list[set]:
        qcg = dag_to_qcg(dag)
        return _kl_partition(qcg, 2, self._size_to_reach)

    def run(self, circuit: Circuit, budget: int) -> Circuit:
        dag = DAG(circuit)
        _decompose_qubit_sets(dag, self._partitions(dag))
        dag.fragment()
        v_circuit = dag.to_circuit()
        if num_virtual_gates(v_circuit) > budget:
            return circuit.copy()
        return v_circuit

    def get_budget(self, circuit: Circuit) -> int:
        dag = DAG(circuit.copy())
        _decompose_qubit_sets(dag, self._partitions(dag))
        dag.fragment()
        return num_virtual_gates(dag.to_circuit())


class OptimalDecompositionPass(VirtualizationPass):
    """Optimal qubit partition minimising (#vgates, imbalance)
    lexicographically (gate_decomp.py:44-116)."""

    def __init__(self, size_to_reach: int) -> None:
        self._size_to_reach = size_to_reach

    def _partitions(self, dag: DAG) -> list[set]:
        qcg = dag_to_qcg(dag)
        n = qcg.number_of_nodes()
        num_partitions = n // self._size_to_reach + (
            n % self._size_to_reach != 0
        )
        num_partitions = max(2, num_partitions)
        return optimal_qubit_partition(
            qcg, num_partitions, self._size_to_reach
        )

    def run(self, circuit: Circuit, budget: int) -> Circuit:
        dag = DAG(circuit)
        _decompose_qubit_sets(dag, self._partitions(dag))
        dag.fragment()
        v_circuit = dag.to_circuit()
        if num_virtual_gates(v_circuit) > budget:
            return circuit.copy()
        return v_circuit

    def get_budget(self, circuit: Circuit) -> int:
        dag = DAG(circuit.copy())
        _decompose_qubit_sets(dag, self._partitions(dag))
        dag.fragment()
        return num_virtual_gates(dag.to_circuit())


class OptimalWireCutter(VirtualizationPass):
    """Optimal wire cutting over gate-node partitions
    (wire_decomp.py:12-133)."""

    def __init__(self, size_to_reach: int) -> None:
        self._size_to_reach = size_to_reach

    def run(self, circuit: Circuit, budget: int) -> Circuit:
        dag = DAG(circuit)
        num_cuts = self._cut_wires(dag)
        self._wire_cuts_to_moves(dag, num_cuts)
        dag.fragment()
        new_circuit = dag.to_circuit()
        n_cuts = num_virtual_gates(new_circuit)
        if n_cuts > budget:
            raise ValueError(
                f"optimal wire cutting to <={self._size_to_reach}-qubit "
                f"fragments needs {n_cuts} cuts, over the budget of {budget}"
            )
        return new_circuit

    def _cut_wires(self, dag: DAG) -> int:
        min_frags = max(len(dag.qubits) // self._size_to_reach, 2)
        partitions = None
        while partitions is None:
            if min_frags > len(dag.qubits):
                raise ValueError("Could not find a solution (internal error)")
            partitions = self._find_optimal_partitions(dag, min_frags)
            min_frags += 1
        # cut along each qubit's chain of ops: the optimiser's wires are
        # (consecutive 2q gates on a qubit, SKIPPING 1q nodes) — the cut
        # must be inserted just before the later gate even when 1q gates
        # sit in between (the pre-r3 version only cut direct DAG edges,
        # silently no-opping on any realistic circuit)
        vgates = 0
        for qubit in dag.qubits:
            prev_gate = None
            prev_any = None
            for node in list(dag.nodes_on_qubit(qubit)):
                in_part = partitions.get(node) is not None
                if (
                    in_part and prev_gate is not None
                    and partitions[prev_gate] != partitions[node]
                ):
                    if dag.has_edge(prev_any, node):
                        dag.remove_edge(prev_any, node)
                    w = dag.add_instr_node(
                        Instruction("wirecut", [qubit], op=WireCutMark())
                    )
                    dag.add_edge(prev_any, w)
                    dag.add_edge(w, node)
                    prev_any = w
                    vgates += 1
                if in_part:
                    prev_gate = node
                if node in dag:
                    prev_any = node
        return vgates

    def _wire_cuts_to_moves(self, dag: DAG, num_wire_cuts: int) -> None:
        if num_wire_cuts == 0:
            return
        move_reg = Register("vmove", num_wire_cuts)
        offset = sum(r.size for r in dag.qregs)
        dag.add_qreg(move_reg)
        mapping: dict[int, int] = {}

        def find(q: int) -> int:
            while q in mapping:
                q = mapping[q]
            return q

        ctr = 0
        for node in topological_sort(dag):
            ins = dag.get_node_instr(node)
            ins.qubits = [find(q) for q in ins.qubits]
            if ins.name == "wirecut":
                dst = offset + ctr
                ins.name = "vgate"
                ins.op = VirtualGateOp("move")
                ins.qubits.append(dst)
                mapping[ins.qubits[0]] = dst
                ctr += 1

    def _find_optimal_partitions(self, dag: DAG, num_fragments: int):
        # gate nodes = 2q instructions; wires between consecutive gates on a
        # qubit (asp.py:10-29)
        gate_nodes = [
            n for n in dag.nodes
            if len(dag.get_node_instr(n).qubits) == 2
            and dag.get_node_instr(n).name != "barrier"
        ]
        node_qubits = {
            n: tuple(dag.get_node_instr(n).qubits) for n in gate_nodes
        }
        gate_set = set(gate_nodes)
        wires = []
        for qubit in dag.qubits:
            prev = None
            for node in dag.nodes_on_qubit(qubit):
                if node not in gate_set:
                    continue
                if prev is not None:
                    wires.append((prev, node))
                prev = node
        return optimal_gate_partition(
            gate_nodes, node_qubits, wires, num_fragments,
            self._size_to_reach,
        )

    def get_budget(self, circuit: Circuit) -> int:
        dag = DAG(circuit.copy())
        num_cuts = self._cut_wires(dag)
        self._wire_cuts_to_moves(dag, num_cuts)
        dag.fragment()
        return num_virtual_gates(dag.to_circuit())


class QubitDependencyReducer(VirtualizationPass):
    def run(self, circuit: Circuit, budget: int) -> Circuit:
        dag = DAG(circuit)
        dag.compact()
        self._pass(dag, budget)
        dag.fragment()
        return dag.to_circuit()

    def _pass(self, dag: DAG, budget: int) -> None:
        raise NotImplementedError


class CircularDependencyBreaker(QubitDependencyReducer):
    """reduce_deps.py:24-58.

    NOTE (preserved reference quirk): the guard below requires the two
    qubits NOT to share a QCG edge, but the QCG is built from the same DAG
    that contains the very 2q gate under test, so the edge always exists
    and the pass never virtualizes anything.  The reference's
    reduce_deps.py:42-44 has the identical latent bug; ported as-is for
    behavioral parity (use GreedyDependencyBreaker or
    QubitDependencyMinimizer for effective dependency breaking)."""

    def _pass(self, dag: DAG, budget: int) -> None:
        depends: dict[int, set[int]] = {q: set() for q in dag.qubits}
        qcg = dag_to_qcg(dag)
        for node in topological_sort(dag):
            if budget <= 0:
                return
            ins = dag.get_node_instr(node)
            qs = ins.qubits
            if len(qs) == 1 or ins.name in ("barrier", "vgate"):
                continue
            if len(qs) == 2:
                q1, q2 = qs
                if (q1 in depends[q2] or q2 in depends[q1]) and not (
                    qcg.has_edge(q1, q2) or qcg.has_edge(q2, q1)
                ):
                    if ins.name in VIRTUAL_GATE_NAMES:
                        dag.virtualize_node(node)
                        budget -= 1
                        continue
                add1 = depends[q2] | {q2}
                add2 = depends[q1] | {q1}
                depends[q1] |= add1
                depends[q2] |= add2
            else:
                raise ValueError("Cannot convert dag to qdg, too many qubits")


class GreedyDependencyBreaker(VirtualizationPass):
    """Virtualizes the gate maximising dependencies x influence
    (reduce_deps.py:61-127)."""

    def run(self, circuit: Circuit, budget: int) -> Circuit:
        dag = DAG(circuit)
        for _ in range(budget):
            self._pass(dag)
        dag.fragment()
        return dag.to_circuit()

    def _pass(self, dag: DAG) -> None:
        node_depends: dict[int, set[int]] = {}
        previous: dict[int, int] = {q: -1 for q in dag.qubits}
        nodes_2q = set()
        for node in topological_sort(dag):
            ins = dag.get_node_instr(node)
            qs = ins.qubits
            # already-virtualized gates create no qubit dependencies (the
            # reference skips Barrier subclasses, reduce_deps.py:85) —
            # counting them would re-score structure prior virtualizations
            # already removed
            if len(qs) == 1 or ins.name in ("barrier", "vgate"):
                continue
            if len(qs) == 2:
                if ins.name in VIRTUAL_GATE_NAMES:
                    nodes_2q.add(node)
                q1, q2 = qs
                node_depends[node] = set()
                for prev in (previous[q1], previous[q2]):
                    if prev > -1:
                        node_depends[node].add(prev)
                        node_depends[node].update(
                            node_depends.get(prev, set())
                        )
                previous[q1] = node
                previous[q2] = node
            else:
                raise ValueError("Cannot handle more than 2 qubits")
        if not nodes_2q:
            return
        influences = {
            n: {m for m, deps in node_depends.items() if n in deps}
            for n in nodes_2q
        }
        target = min(
            nodes_2q,
            key=lambda x: (-len(node_depends[x]) * len(influences[x]), x),
        )
        dag.virtualize_node(target)


class QubitDependencyMinimizer(QubitDependencyReducer):
    """Choose exactly ``budget`` gates to virtualize minimising the
    qubit-dependency count (reduce_deps.py:130-167).  Exact enumeration for
    small instances, greedy otherwise (the reference grounds an ASP model)."""

    def _pass(self, dag: DAG, budget: int) -> None:
        candidates = [
            n for n in dag.nodes
            if len(dag.get_node_instr(n).qubits) == 2
            and dag.get_node_instr(n).name in VIRTUAL_GATE_NAMES
        ]
        if budget <= 0 or not candidates:
            return
        # more budget than candidates: virtualize them all (min() over an
        # empty combinations iterator would crash otherwise)
        budget = min(budget, len(candidates))
        import math

        def deps_after(virt_set):
            # count dependencies with the chosen nodes (and all existing
            # vgates) excluded, walking THIS dag directly — DAG.copy()
            # renumbers nodes topologically, so virtualizing the original
            # node ids on a copy would hit the wrong instructions
            skip = set(virt_set)
            depends_on: dict[int, set[int]] = {q: set() for q in dag.qubits}
            for node in topological_sort(dag):
                if node in skip:
                    continue
                ins = dag.get_node_instr(node)
                qs = ins.qubits
                if len(qs) == 1 or ins.name in ("barrier", "vgate"):
                    continue
                if len(qs) != 2:
                    raise ValueError("More than 2 qubits in instruction")
                q1, q2 = qs
                add1 = depends_on[q2] | {q2}
                add2 = depends_on[q1] | {q1}
                depends_on[q1] |= add1
                depends_on[q2] |= add2
            return sum(len(v - {q}) for q, v in depends_on.items())

        if math.comb(len(candidates), budget) <= 2000:
            best = min(
                itertools.combinations(candidates, budget), key=deps_after
            )
        else:
            best = []
            pool = list(candidates)
            for _ in range(budget):
                pick = min(pool, key=lambda n: deps_after(best + [n]))
                best.append(pick)
                pool.remove(pick)
        for n in best:
            dag.virtualize_node(n)
