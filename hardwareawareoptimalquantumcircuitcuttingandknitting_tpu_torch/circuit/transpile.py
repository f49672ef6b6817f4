"""Basis transpiler-lite.

Plays the role qiskit's ``transpile`` has in the reference's CNOT/depth
benchmark (benchmarks/benchmark_number_of_cnots_and_depth.py:62-96): rewrite
to the IBM-style basis {cx, rz, sx, x} with 1q-run merging, so CNOT counts
and depths are comparable.
"""
from __future__ import annotations

import cmath
import math

import numpy as np

from .circuit import Circuit, Instruction
from .gates import gate_matrix

BASIS = ("cx", "rz", "sx", "x")


def _zyz_angles(u: np.ndarray) -> tuple[float, float, float, float]:
    """U = e^{i a} Rz(b) Ry(c) Rz(d)."""
    u = np.asarray(u, dtype=complex)
    det = np.linalg.det(u)
    alpha = cmath.phase(det) / 2
    su = u / cmath.exp(1j * alpha)
    c = 2 * math.atan2(abs(su[1, 0]), abs(su[0, 0]))
    if abs(su[0, 0]) > 1e-12 and abs(su[1, 0]) > 1e-12:
        bpd = -2 * cmath.phase(su[0, 0])
        bmd = 2 * cmath.phase(su[1, 0])
        b = (bpd + bmd) / 2
        d = (bpd - bmd) / 2
    elif abs(su[1, 0]) <= 1e-12:
        b = -2 * cmath.phase(su[0, 0])
        d = 0.0
    else:
        b = 2 * cmath.phase(su[1, 0])
        d = 0.0
    return alpha, b, c, d


def _emit_1q(u: np.ndarray, q: int) -> list[Instruction]:
    """Emit a 1q unitary as rz/sx gates via the ZSX identity (qiskit's
    OneQubitEulerDecomposer basis): up to global phase,

        Rz(b) Ry(c) Rz(d)  =  Rz(b + pi) . SX . Rz(c + pi) . SX . Rz(d)

    (application order: Rz(d) first)."""
    _, b, c, d = _zyz_angles(u)
    out: list[Instruction] = []

    def rz(theta):
        theta = float((theta + math.pi) % (2 * math.pi) - math.pi)
        if abs(theta) > 1e-9:
            out.append(Instruction("rz", [q], params=[theta]))

    if abs(c) < 1e-9:
        rz(b + d)
        return out
    rz(d)
    out.append(Instruction("sx", [q]))
    rz(c + math.pi)
    out.append(Instruction("sx", [q]))
    rz(b + math.pi)
    return out


def _decompose_2q(ins: Instruction) -> list[Instruction]:
    a, b = ins.qubits
    th = ins.params[0] if ins.params else 0.0

    def g(name, qubits, params=()):
        return Instruction(name, list(qubits), params=list(params))

    H = gate_matrix("h")
    if ins.name == "cx":
        return [ins.copy()]
    if ins.name == "cz":
        return [*_emit_1q(H, b), g("cx", [a, b]), *_emit_1q(H, b)]
    if ins.name == "cy":
        return [
            g("rz", [b], [-math.pi / 2]), g("cx", [a, b]),
            g("rz", [b], [math.pi / 2]),
        ]
    if ins.name in ("cp", "cu1"):
        return [
            g("rz", [a], [th / 2]), g("rz", [b], [th / 2]),
            g("cx", [a, b]), g("rz", [b], [-th / 2]), g("cx", [a, b]),
        ]
    if ins.name == "crz":
        return [
            g("rz", [b], [th / 2]), g("cx", [a, b]),
            g("rz", [b], [-th / 2]), g("cx", [a, b]),
        ]
    if ins.name == "rzz":
        return [g("cx", [a, b]), g("rz", [b], [th]), g("cx", [a, b])]
    if ins.name == "swap":
        return [g("cx", [a, b]), g("cx", [b, a]), g("cx", [a, b])]
    if ins.name == "iswap":
        # iswap = (S x S) . H_a . cx(a,b) . cx(b,a) . H_b
        return [
            g("rz", [a], [math.pi / 2]), g("rz", [b], [math.pi / 2]),
            *_emit_1q(H, a), g("cx", [a, b]), g("cx", [b, a]),
            *_emit_1q(H, b),
        ]
    if ins.name == "fsim":
        # exact identity (verified numerically, no global phase):
        #   fsim(th, ph) = cp(-ph) . exp(-i th/2 (XX + YY))
        # with the XX leg = (HxH) rzz(th) (HxH) and the YY leg =
        # (Rx(pi/2)^x2) rzz(th) (Rx(-pi/2)^x2); all factors commute.
        ph = ins.params[1] if len(ins.params) > 1 else 0.0
        rxp = gate_matrix("rx", [math.pi / 2])
        rxm = gate_matrix("rx", [-math.pi / 2])
        out: list[Instruction] = []
        # YY leg (applied first)
        out += [*_emit_1q(rxm, a), *_emit_1q(rxm, b)]
        out += [g("cx", [a, b]), g("rz", [b], [th]), g("cx", [a, b])]
        out += [*_emit_1q(rxp, a), *_emit_1q(rxp, b)]
        # XX leg
        out += [*_emit_1q(H, a), *_emit_1q(H, b)]
        out += [g("cx", [a, b]), g("rz", [b], [th]), g("cx", [a, b])]
        out += [*_emit_1q(H, a), *_emit_1q(H, b)]
        # |11> phase
        out += _decompose_2q(g("cp", [a, b], [-ph]))
        return out
    raise NotImplementedError(f"2q gate {ins.name}")


def transpile_to_basis(circ: Circuit, optimize: bool = True) -> Circuit:
    """Rewrite to {cx, rz, sx, x}; merge 1q runs when ``optimize``."""
    circ = circ.decompose()
    out = Circuit(list(circ.qregs), list(circ.cregs), circ.name)
    pending: dict[int, np.ndarray] = {}

    def flush(q: int):
        u = pending.pop(q, None)
        if u is not None:
            for gate in _emit_1q(u, q):
                out.append(gate)

    def flush_all():
        for q in list(pending):
            flush(q)

    for ins in circ.instructions:
        if ins.name == "barrier":
            flush_all()
            out.append(ins.copy())
            continue
        if ins.name in ("measure", "reset"):
            flush(ins.qubits[0])
            out.append(ins.copy())
            continue
        cond = getattr(ins, "condition", None)
        if len(ins.qubits) == 1:
            u = (
                np.asarray(ins.op)
                if ins.name == "unitary"
                else ins.matrix()
            )
            if cond is not None:
                # classical control distributes over the decomposition
                # product (all-or-nothing).  A conditioned gate already
                # in the basis passes through UNCHANGED — the engine's
                # c_if support covers exactly the reference's dynamic-
                # reuse shape (x.c_if, qubit_reuser.py:29-52)
                flush(ins.qubits[0])
                if ins.name in BASIS:
                    out.append(ins.copy())
                    continue
                for gate in _emit_1q(u, ins.qubits[0]):
                    gate.condition = cond
                    out.append(gate)
            elif optimize:
                prev = pending.get(ins.qubits[0])
                pending[ins.qubits[0]] = u if prev is None else u @ prev
            else:
                for gate in _emit_1q(u, ins.qubits[0]):
                    out.append(gate)
            continue
        for q in ins.qubits:
            flush(q)
        for gate in _decompose_2q(ins):
            if cond is not None:
                gate.condition = cond
            out.append(gate)
    flush_all()
    return out


def count_cnots(circ: Circuit) -> int:
    return circ.count_ops().get("cx", 0)
