"""Fragment container: splits a cut circuit into per-fragment programs.

First-party, tensor-oriented analog of the reference's ``VirtualCircuit``
(third_party/qvm/qvm/virtual_circuit.py:20-163).  Key differences by design:

* instantiations are never materialised as circuits; each fragment compiles
  once into a static program whose virtual-gate endpoints are parameterised
  *slots* (pre/measure/post), so the whole variant fan-out is a single
  batched (vmapped) execution — the TPU analog of Aer's
  ``backend.run(instantiations)`` (qvm/run.py:36-42);
* mid-circuit measurements are deferred onto per-vgate ancilla qubits, so
  every variant is purely unitary and shape-uniform.

Clbit layout matches the reference exactly: original clbits 0..C-1, then one
clbit per vgate at C+g (``vgate_c`` register, virtual_circuit.py:202,
knit clbit indexing at :60).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..circuit.circuit import Circuit, Register
from .virtual_gates import VirtualGateOp


@dataclass
class Slot:
    """One virtual-gate endpoint inside a fragment program."""

    vgate_idx: int      # global vgate index
    side: int           # endpoint 0/1 of the vgate
    qubit: int          # fragment-local qubit
    ancilla: int | None  # fragment-local ancilla qubit (None if this side
                         # never measures in any variant)


@dataclass
class FragmentProgram:
    """Static, variant-uniform execution plan for one fragment."""

    name: str
    num_data_qubits: int
    num_sim_qubits: int
    ops: list = field(default_factory=list)
    # ops entries: ("u"|"u_aux", np.ndarray, axes) |
    #   ("slot_pre"|"slot_meas"|"slot_post",
    # "u_aux" marks bookkeeping ops (measurement deferral CX / reset SWAP /
    # classical-feedback CX) that physical noise must not touch.
    #              slot_index, axes)
    slots: list[Slot] = field(default_factory=list)
    touching: list[int] = field(default_factory=list)  # global vgate indices
    clbit_sources: dict[int, int] = field(default_factory=dict)
    # global clbit -> fragment-local sim qubit holding its value
    source: list = field(default_factory=list)
    # pre-compilation fragment instruction stream: ("slot", (g, side, lq)) or
    # ("ins", Instruction-with-local-qubits) — used for artifact rendering
    op_instrs: dict[int, object] = field(default_factory=dict)
    # op index -> source Instruction for "u" ops (the differentiable sweep
    # uses this to rebuild parameterised matrices from theta)


class VirtualCircuit:
    """Splits a cut circuit (one register per fragment) into programs."""

    def __init__(self, circuit: Circuit) -> None:
        self._circuit = circuit
        self.vgate_instrs = [
            ins for ins in circuit.instructions if ins.name == "vgate"
        ]
        self._vgate_index = {id(ins): g for g, ins in enumerate(self.vgate_instrs)}
        self.vgates: list[VirtualGateOp] = [i.op for i in self.vgate_instrs]
        self.num_clbits = circuit.num_clbits
        self.fragments: list[Register] = list(circuit.qregs)
        self._programs: dict[str, FragmentProgram] = {}
        self._backends: dict[str, object] = {}
        for reg in self.fragments:
            self._programs[reg.name] = self._compile_fragment(reg)

    # ------------------------------------------------------------------
    @property
    def programs(self) -> dict[str, FragmentProgram]:
        return self._programs

    def vgate_clbit(self, vgate_idx: int) -> int:
        return self.num_clbits + vgate_idx

    # -- per-fragment backend mapping (reference virtual_circuit.py:82-95):
    # a "backend" here is a NoiseModel (ops/noise.py) or None for the exact
    # ideal engine; the noisy runtime consults this mapping by default.
    def get_backend(self, frag_name: str):
        return self._backends.get(frag_name)

    def set_backend(self, frag_name: str, backend) -> None:
        if frag_name not in self._programs:
            raise KeyError(f"unknown fragment {frag_name!r}")
        if backend is not None and getattr(backend, "num_qubits", None):
            need = self._programs[frag_name].num_data_qubits
            if need > backend.num_qubits:  # user-facing: survive python -O
                raise ValueError(
                    f"fragment {frag_name} needs {need} qubits, backend "
                    f"{getattr(backend, 'name', backend)} has "
                    f"{backend.num_qubits}"
                )
        self._backends[frag_name] = backend

    def set_backend_for_all(self, backend) -> None:
        for reg in self.fragments:
            self.set_backend(reg.name, backend)

    def num_instantiations(self, frag_name: str) -> int:
        prog = self._programs[frag_name]
        n = 1
        for g in prog.touching:
            n *= self.vgates[g].num_instantiations
        return n

    def total_instantiations(self) -> int:
        """Total instance count across fragments — the quantity the reference
        logs as 'Running N instances' (qvm/run.py:45)."""
        return sum(self.num_instantiations(r.name) for r in self.fragments)

    def get_instance_labels(self, frag_name: str) -> list[tuple[int, ...]]:
        """Reference-compatible label enumeration
        (virtual_circuit.py:39-48): cartesian product over all vgates with
        ``(-1)`` for vgates not touching the fragment."""
        import itertools

        prog = self._programs[frag_name]
        ranges = [
            range(self.vgates[g].num_instantiations)
            if g in prog.touching
            else (-1,)
            for g in range(len(self.vgates))
        ]
        return list(itertools.product(*ranges))

    # ------------------------------------------------------------------
    def _compile_fragment(self, reg: Register) -> FragmentProgram:
        circ = self._circuit
        offset = circ.qreg_offset(reg.name)
        in_frag = lambda q: offset <= q < offset + reg.size
        loc = lambda q: q - offset

        prog = FragmentProgram(reg.name, reg.size, reg.size)

        # pass 1: find fragment instructions; which vgates touch; which sides
        frag_instrs: list[tuple[str, object]] = []  # (kind, payload)
        for ins in circ.instructions:
            if ins.name == "barrier":
                continue
            if ins.name == "vgate":
                op: VirtualGateOp = ins.op
                g = self._vgate_index[id(ins)]
                for side, q in enumerate(ins.qubits):
                    if in_frag(q):
                        frag_instrs.append(("slot", (g, side, loc(q))))
                continue
            if all(in_frag(q) for q in ins.qubits):
                frag_instrs.append(("ins", ins))
            elif any(in_frag(q) for q in ins.qubits):
                raise ValueError(
                    f"instruction {ins} crosses fragment {reg.name}"
                )

        # pass 2: allocate vgate ancillas (only for sides that measure in at
        # least one variant) and build ops with terminal-measure deferral
        from ..circuit.gates import CX, SWAP

        next_anc = reg.size
        # find last touch per local data qubit for terminal-measure detection
        last_touch: dict[int, int] = {}
        for idx, (kind, payload) in enumerate(frag_instrs):
            if kind == "slot":
                last_touch[payload[2]] = idx
            else:
                for q in payload.qubits:
                    last_touch[loc(q)] = idx

        slot_index: dict[tuple[int, int], int] = {}
        for idx, (kind, payload) in enumerate(frag_instrs):
            if kind == "slot":
                g, side, lq = payload
                spec = self.vgates[g].spec
                measures = any(
                    pair[side].measure for pair in spec.endpoints
                )
                anc = None
                if measures:
                    # one shared ancilla per (fragment, vgate): if both
                    # endpoints land in this fragment, at most one side
                    # measures per variant, so CXs onto a shared ancilla
                    # implement the reference's shared vgate clbit exactly
                    # (virtual_circuit.py:202,211).
                    cg = self.vgate_clbit(g)
                    if cg in prog.clbit_sources:
                        anc = prog.clbit_sources[cg]
                    else:
                        anc = next_anc
                        next_anc += 1
                        prog.clbit_sources[cg] = anc
                s = Slot(g, side, lq, anc)
                sid = len(prog.slots)
                prog.slots.append(s)
                slot_index[(g, side)] = sid
                if g not in prog.touching:
                    prog.touching.append(g)
                prog.ops.append(("slot_pre", sid, (lq,)))
                if anc is not None:
                    prog.ops.append(("slot_meas", sid, (lq, anc)))
                prog.ops.append(("slot_post", sid, (lq,)))
                continue

            ins = payload
            lqs = tuple(loc(q) for q in ins.qubits)
            if ins.name == "measure":
                (lq,), (c,) = lqs, ins.clbits
                if c in prog.clbit_sources:
                    raise ValueError(f"clbit {c} measured twice")
                if last_touch.get(lq) == idx:
                    prog.clbit_sources[c] = lq
                else:
                    anc = next_anc
                    next_anc += 1
                    prog.ops.append(("u_aux", CX, (lq, anc)))
                    prog.clbit_sources[c] = anc
                continue
            if ins.name == "reset":
                (lq,) = lqs
                if last_touch.get(lq) == idx:
                    continue
                anc = next_anc
                next_anc += 1
                prog.ops.append(("u_aux", SWAP, (lq, anc)))
                continue
            if ins.condition is not None:
                cbit, val = ins.condition
                src = prog.clbit_sources.get(cbit)
                if src is None:
                    raise ValueError(f"condition on unwritten clbit {cbit}")
                if ins.name == "x" and val == 1:
                    prog.ops.append(("u_aux", CX, (src, lqs[0])))
                    continue
                raise NotImplementedError(f"conditioned {ins.name}")
            prog.op_instrs[len(prog.ops)] = ins
            prog.ops.append(("u", ins.matrix(), lqs))

        prog.touching.sort()
        prog.num_sim_qubits = next_anc
        for kind, payload in frag_instrs:
            if kind == "slot":
                prog.source.append(("slot", payload))
            else:
                local = payload.copy()
                local.qubits = [loc(q) for q in payload.qubits]
                prog.source.append(("ins", local))
        return prog
