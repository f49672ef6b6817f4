"""Real teleportation execution for teleport-flagged cuts.

Port of the JAX package's ``virt/teleport.py`` (host only, the same
circuits).  The reference treats teleport cuts as cost-model-only: the
optimiser prices them (S*=1, +2 ancilla, +10 latency — the reference's
src/HwAwareCutter/Cutter.py:452-471) and the rewrite labels them
" TELE", but execution falls through to the QPD route (Cutter.py:574
FIXME).  This module implements the actual protocol so a teleport-cut
plan can be EXECUTED as planned:

* **Gate teleportation (telegate)** for teleport gate cuts: the standard
  EPR-mediated non-local controlled gate (Eisert-Jacobs-Papadopoulos-
  Plenio 2000; Gottesman-Chuang) with measurements deferred into
  controlled corrections, so the gadget is purely unitary and the exact
  engine's clbit marginalisation reproduces the measured protocol
  exactly:

      h(eA); cx(eA, eB)        # EPR pair, one half per partition
      cx(a, eA)                # control-value copy (partition A, local)
      cx(eA, eB)               # deferred X-correction  (classical bit 1)
      G(eB, b)                 # the cut gate, control moved to eB (local
                               #   in partition B)
      h(eB)
      cz(eB, a)                # deferred Z-correction  (classical bit 2)

  Valid for every VIRTUAL_GATE_NAMES member — each is diagonal in
  operand 0's computational basis (cx/cy control, cz/cp/rzz symmetric-
  diagonal).  Exactly 2 ancillas (the cost table's +2) and 2 classical
  messages (the +10 latency).

* **State teleportation (teledata)** for teleport wire cuts: the vmove
  destination qubit doubles as the EPR's receiving half, so one fresh
  ancilla eA completes the pair:

      h(eA); cx(eA, dst)       # EPR
      cx(src, eA); h(src)      # Bell measurement (deferred)
      cx(eA, dst)              # X-correction
      cz(src, dst)             # Z-correction

Teleportation entangles the two partitions through a real quantum
channel, so teleport-connected fragments cannot be simulated as
independent tensor factors: :func:`expand_teleport_cuts` MERGES them
into one register (the simulator stands in for the quantum channel,
exactly as the per-register fragments stand in for separate devices).
Remaining QPD vgates knit as usual on the merged fragments.
"""
from __future__ import annotations

from ..circuit.circuit import Circuit, Instruction, Register
from .virtual_gates import VirtualGateOp


def has_teleport_cuts(circ: Circuit) -> bool:
    return any(
        ins.name == "vgate" and ins.op.teleport
        for ins in circ.instructions
    )


def expand_teleport_cuts(circ: Circuit) -> Circuit:
    """Replace teleport-flagged vgates with executable gadgets.

    Returns a new circuit in which teleport-connected fragment registers
    are merged (``telegroup{k}``) with the gadget ancillas appended to
    the merged register, teleport vgates are expanded to the unitary
    protocol above, and QPD vgates/plain instructions are preserved
    (remapped).  Feed the result to ``VirtualCircuit`` /
    ``run_virtual_circuit`` — or use
    ``run_virtual_circuit(..., teleport="execute")``.
    """
    tele_gates = [
        ins for ins in circ.instructions
        if ins.name == "vgate" and ins.op.teleport
    ]
    if not tele_gates:
        return circ

    # -- union-find over registers touched by teleport cuts -------------
    reg_of_qubit: dict[int, int] = {}
    off = 0
    for ri, reg in enumerate(circ.qregs):
        for j in range(reg.size):
            reg_of_qubit[off + j] = ri
        off += reg.size
    parent = list(range(len(circ.qregs)))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    anc_per_reg = [0] * len(circ.qregs)
    for ins in tele_gates:
        ra = find(reg_of_qubit[ins.qubits[0]])
        rb = find(reg_of_qubit[ins.qubits[1]])
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
        # telegate needs 2 fresh ancillas; teledata (move) needs 1 (the
        # vmove destination qubit is the EPR's receiving half)
        anc_per_reg[find(reg_of_qubit[ins.qubits[0]])] += (
            1 if ins.op.base_name == "move" else 2
        )

    # -- merged register layout -----------------------------------------
    groups: dict[int, list[int]] = {}
    for ri in range(len(circ.qregs)):
        groups.setdefault(find(ri), []).append(ri)
    new_regs: list[Register] = []
    qubit_map: dict[int, int] = {}
    anc_next: dict[int, int] = {}  # group root -> next free flat ancilla
    new_off = 0
    for root in sorted(groups):
        members = groups[root]
        size = sum(circ.qregs[ri].size for ri in members)
        extra = sum(anc_per_reg[ri] for ri in members)
        merged = len(members) > 1 or extra > 0
        name = (
            f"telegroup{root}" if merged and len(members) > 1
            else circ.qregs[members[0]].name
        )
        new_regs.append(Register(name, size + extra))
        pos = new_off
        for ri in members:
            base = sum(circ.qregs[k].size for k in range(ri))
            for j in range(circ.qregs[ri].size):
                qubit_map[base + j] = pos
                pos += 1
        anc_next[root] = pos
        new_off += size + extra

    out = Circuit(new_regs, list(circ.cregs), circ.name)

    def _app(name, qubits, params=()):
        out.instructions.append(
            Instruction(name, list(qubits), params=list(params))
        )

    for ins in circ.instructions:
        if ins.name == "vgate" and ins.op.teleport:
            op: VirtualGateOp = ins.op
            root = find(reg_of_qubit[ins.qubits[0]])
            if op.base_name == "move":
                src = qubit_map[ins.qubits[0]]
                dst = qubit_map[ins.qubits[1]]
                e_a = anc_next[root]
                anc_next[root] += 1
                _app("h", [e_a])
                _app("cx", [e_a, dst])          # EPR (e_a, dst)
                _app("cx", [src, e_a])          # Bell measurement,
                _app("h", [src])                # deferred
                _app("cx", [e_a, dst])          # X-correction
                _app("cz", [src, dst])          # Z-correction
            else:
                a = qubit_map[ins.qubits[0]]
                b = qubit_map[ins.qubits[1]]
                e_a = anc_next[root]
                e_b = e_a + 1
                anc_next[root] += 2
                _app("h", [e_a])
                _app("cx", [e_a, e_b])          # EPR
                _app("cx", [a, e_a])            # control copy
                _app("cx", [e_a, e_b])          # X-correction (deferred)
                _app(op.base_name, [e_b, b], op.params)  # local gate
                _app("h", [e_b])
                _app("cz", [e_b, a])            # Z-correction (deferred)
            continue
        new = ins.copy()
        new.qubits = [qubit_map[q] for q in ins.qubits]
        out.instructions.append(new)
    return out
