"""Circuit rewrite: apply a CutPlan to a circuit.

Mirrors the reference pipeline (src/HwAwareCutter/Cutter.py:575-700):
gate cuts become virtual gates; wire cuts become WireCut markers, then
VirtualMove gates with fresh ``vmove`` ancilla qubits and downstream qubit
forwarding; qubits are grouped into per-partition fragment registers with
leftover (gate-less) qubits packed into remaining capacity.
"""
from __future__ import annotations

from ..circuit.circuit import Circuit, Instruction, Register
from ..utils.logger import get_logger
from ..virt.virtual_gates import VirtualGateOp, WireCutMark
from .graph import CutGraph
from .plan import CutPlan


def apply_gate_cuts_and_mark_wire_cuts(
    circ: Circuit, graph: CutGraph, plan: CutPlan
) -> Circuit:
    """Reference: _repaceGateCutsAndMarkWireCuts (Cutter.py:575-611).
    Operates in place on a copy of ``circ`` whose instructions are the same
    objects referenced by ``graph.vertices`` (caller passes the circuit that
    was read into the graph)."""
    log = get_logger(__name__)
    # instruction -> list of markers to insert after it (qubit, label, tele)
    markers: dict[int, list[tuple[int, str, bool]]] = {}
    replace: dict[int, Instruction] = {}

    for cut in plan.cuts:
        u_idx, v_idx = cut.edge
        u = graph.vertices[u_idx]
        v = graph.vertices[v_idx]
        if cut.kind == "gate":
            ins = u.instr
            gate_name = f"{ins.name} {ins.label}"
            if cut.teleport:
                gate_name += " TELE"
            replace[id(ins)] = Instruction(
                "vgate",
                list(ins.qubits),
                params=list(ins.params),
                label=gate_name,
                op=VirtualGateOp(
                    ins.name, tuple(ins.params), gate_name, cut.teleport
                ),
            )
            log.info("GateCut %s is replaced.", gate_name)
        else:
            label = f"{u_idx}_{v_idx}"
            if cut.teleport:
                label += " TELE"
            markers.setdefault(id(u.instr), []).append(
                (u.qubit, label, cut.teleport)
            )
            log.info("WireCut %s is marked.", label)

    out = Circuit(list(circ.qregs), list(circ.cregs), circ.name)
    for ins in circ.instructions:
        out.instructions.append(replace.get(id(ins), ins))
        for qubit, label, tele in markers.get(id(ins), []):
            out.instructions.append(
                Instruction(
                    "wirecut", [qubit], label=f"WC {label}",
                    op=WireCutMark(label, tele),
                )
            )
    return out


def replace_wire_cut_marks_with_moves(
    circ: Circuit,
) -> tuple[Circuit, list[int], list[int]]:
    """Reference: _replaceWireCutMarkWithVirtualMoveGates (Cutter.py:614-645).

    Returns (circuit, vmove_to_vidx, move_qubits): per wire cut, the graph
    vertex index on the cut's right side (whose partition the vmove qubit
    joins) and the vmove qubit's flat index in the new circuit.
    """
    n_wire_cuts = sum(1 for i in circ.instructions if i.name == "wirecut")
    if n_wire_cuts == 0:
        return circ, [], []

    out = Circuit(
        list(circ.qregs) + [Register("vmove", n_wire_cuts)],
        list(circ.cregs),
        circ.name,
    )
    move_offset = circ.num_qubits
    forward: dict[int, int] = {}

    def find(q: int) -> int:
        while q in forward:
            q = forward[q]
        return q

    vmove_to_vidx: list[int] = []
    move_qubits: list[int] = []
    ctr = 0
    for ins in circ.instructions:
        qubits = [find(q) for q in ins.qubits]
        if ins.name == "wirecut":
            mark: WireCutMark = ins.op
            src = qubits[0]
            dst = move_offset + ctr
            forward[src] = dst
            v_idx = int(mark.label.split()[0].split("_")[-1])
            vmove_to_vidx.append(v_idx)
            move_qubits.append(dst)
            ctr += 1
            out.instructions.append(
                Instruction(
                    "vgate", [src, dst],
                    label=f"VirtualMove {mark.label}",
                    op=VirtualGateOp(
                        "move", (), f"VirtualMove {mark.label}", mark.teleport
                    ),
                )
            )
            continue
        new = ins.copy()
        new.qubits = qubits
        out.instructions.append(new)
    return out, vmove_to_vidx, move_qubits


def compute_fragments(
    circ: Circuit,
    graph: CutGraph,
    plan: CutPlan,
    caps: list[int],
    vmove_to_vidx: list[int],
    move_qubits: list[int],
) -> list[list[int]]:
    """Reference: _getFragments (Cutter.py:648-700).  Returns per-partition
    qubit lists (flat indices into ``circ``)."""
    log = get_logger(__name__)
    results: list[list[int]] = [[] for _ in range(plan.num_partitions)]
    visited: set[int] = set()

    for v_idx, p_idx in enumerate(plan.assignment):
        q = graph.vertices[v_idx].qubit
        if q in visited or q in move_qubits:
            continue
        visited.add(q)
        results[p_idx].append(q)

    for move_i, v_idx in enumerate(vmove_to_vidx):
        mq = move_qubits[move_i]
        results[plan.assignment[v_idx]].append(mq)
        visited.add(mq)

    leftover = [q for q in range(circ.num_qubits) if q not in visited]
    available = sum(
        caps[p] - len(results[p]) for p in range(plan.num_partitions)
    )
    if available < len(leftover):
        raise RuntimeError("not enough available spots")
    for p in range(plan.num_partitions):
        free = caps[p] - len(results[p])
        take, leftover = leftover[:free], leftover[free:]
        if take:
            log.info(
                f"added {len(take)} left over qubits {take} to partition {p}"
            )
            results[p].extend(take)
    return results


def fragment_circuit(
    circ: Circuit, fragments: list[list[int]]
) -> tuple[Circuit, dict[int, int]]:
    """Reference: qvm DAG.fragment (third_party/qvm/qvm/compiler/dag.py:185-203):
    regroup qubits into ``frag{i}`` registers and remap instructions."""
    qubit_map: dict[int, int] = {}
    regs = []
    offset = 0
    for i, qubits in enumerate(fragments):
        regs.append(Register(f"frag{i}", len(qubits)))
        for j, q in enumerate(sorted(qubits)):
            qubit_map[q] = offset + j
        offset += len(qubits)

    out = Circuit(regs, list(circ.cregs), circ.name)
    for ins in circ.instructions:
        new = ins.copy()
        new.qubits = [qubit_map[q] for q in ins.qubits]
        out.instructions.append(new)
    return out, qubit_map
