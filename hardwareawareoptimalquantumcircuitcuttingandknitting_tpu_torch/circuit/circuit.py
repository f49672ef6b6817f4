"""Minimal typed circuit IR.

First-party replacement for qiskit's ``QuantumCircuit`` in the roles the
reference uses it for (construction, decompose, fragment relabeling —
reference: src/HwAwareCutter/Cutter.py:84,128-160 and
third_party/qvm/qvm/virtual_circuit.py).  Instructions address qubits/clbits
by *flat index* into the concatenation of the circuit's registers; register
structure is metadata used for display and for fragment grouping.
"""
from __future__ import annotations

import copy as _copy
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

import numpy as np

from .gates import GATE_ARITY, NON_UNITARY, gate_matrix


class ParamRef(float):
    """A gate parameter that additionally names a position in an external
    theta vector (for differentiable / re-bindable serving).

    Behaves as its concrete float value everywhere in the host pipeline
    (cutting, rewriting, gate-matrix tables), so any circuit built with
    ParamRefs runs unchanged; the differentiable sweep
    (ops/sweep.make_differentiable_sweep) detects the marker and rebuilds
    the op's matrix from ``scale * theta[index] + shift`` inside the
    traced program.

    Affine derivations are supported through :meth:`scaled` /
    :meth:`shifted` (QAOA's ``gamma/2`` / ``-2*beta`` gate angles share
    one theta entry).  Plain Python arithmetic on a ParamRef still
    returns a float — the reference is lost deliberately, since silent
    propagation through arbitrary expressions could not be traced.
    """

    __slots__ = ("index", "scale", "shift")

    def __new__(cls, index: int, value: float = 0.0, scale: float = 1.0,
                shift: float = 0.0) -> "ParamRef":
        if scale == 0.0:
            raise ValueError("ParamRef scale must be non-zero")
        obj = super().__new__(cls, scale * float(value) + shift)
        obj.index = int(index)
        obj.scale = float(scale)
        obj.shift = float(shift)
        return obj

    @property
    def base(self) -> float:
        """The underlying theta-entry value this ref was built with."""
        return (float(self) - self.shift) / self.scale

    def scaled(self, k: float) -> "ParamRef":
        """Derived parameter ``k * self`` referencing the same theta entry."""
        return ParamRef(self.index, self.base, k * self.scale, k * self.shift)

    def shifted(self, d: float) -> "ParamRef":
        """Derived parameter ``self + d`` referencing the same theta entry."""
        return ParamRef(self.index, self.base, self.scale, self.shift + d)

    def __getnewargs__(self):  # copy/deepcopy/pickle keep the derivation
        return (self.index, self.base, self.scale, self.shift)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"ParamRef({self.index}, {self.base:g}"
            + (f", scale={self.scale:g}" if self.scale != 1.0 else "")
            + (f", shift={self.shift:g}" if self.shift != 0.0 else "")
            + ")"
        )


@dataclass(frozen=True)
class Register:
    name: str
    size: int

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.name}[{self.size}]"


@dataclass
class Instruction:
    """One operation. ``op`` optionally carries a rich payload object
    (virtual gate / wire-cut marker), mirroring how the reference attaches
    qiskit ``Instruction`` subclasses (qvm/virtual_gates.py)."""

    name: str
    qubits: list[int]
    clbits: list[int] = field(default_factory=list)
    params: list[float] = field(default_factory=list)
    label: str | None = None
    op: Any = None  # payload: VirtualGate, WireCutMark, composite definition...
    condition: tuple[int, int] | None = None  # (clbit, value) for c_if

    def copy(self) -> "Instruction":
        new = Instruction(
            self.name,
            list(self.qubits),
            list(self.clbits),
            list(self.params),
            self.label,
            self.op,
            self.condition,
        )
        return new

    @property
    def num_qubits(self) -> int:
        return len(self.qubits)

    def matrix(self) -> np.ndarray:
        return gate_matrix(self.name, self.params)

    def __repr__(self) -> str:  # pragma: no cover
        p = f"({', '.join(f'{x:.4g}' for x in self.params)})" if self.params else ""
        c = f" -> c{self.clbits}" if self.clbits else ""
        return f"{self.name}{p} q{self.qubits}{c}"


class Circuit:
    """Append-only circuit over flat qubit/clbit indices."""

    def __init__(
        self,
        qubits: int | Sequence[Register] = 0,
        clbits: int | Sequence[Register] = 0,
        name: str = "circuit",
    ) -> None:
        if isinstance(qubits, int):
            self.qregs: list[Register] = [Register("q", qubits)] if qubits else []
        else:
            self.qregs = list(qubits)
        if isinstance(clbits, int):
            self.cregs: list[Register] = [Register("c", clbits)] if clbits else []
        else:
            self.cregs = list(clbits)
        self.instructions: list[Instruction] = []
        self.name = name

    # ------------------------------------------------------------- structure
    @property
    def num_qubits(self) -> int:
        return sum(r.size for r in self.qregs)

    @property
    def num_clbits(self) -> int:
        return sum(r.size for r in self.cregs)

    def add_qreg(self, reg: Register) -> None:
        if any(r.name == reg.name for r in self.qregs):
            raise ValueError(f"duplicate quantum register {reg.name}")
        self.qregs.append(reg)

    def add_creg(self, reg: Register) -> None:
        if any(r.name == reg.name for r in self.cregs):
            raise ValueError(f"duplicate classical register {reg.name}")
        self.cregs.append(reg)

    def qubit_info(self, flat: int) -> tuple[str, int]:
        off = 0
        for r in self.qregs:
            if flat < off + r.size:
                return (r.name, flat - off)
            off += r.size
        raise IndexError(flat)

    def qreg_offset(self, name: str) -> int:
        off = 0
        for r in self.qregs:
            if r.name == name:
                return off
            off += r.size
        raise KeyError(name)

    def qubits_of_reg(self, name: str) -> list[int]:
        off = self.qreg_offset(name)
        size = next(r.size for r in self.qregs if r.name == name)
        return list(range(off, off + size))

    # ---------------------------------------------------------------- build
    def append(self, instr: Instruction) -> Instruction:
        arity = GATE_ARITY.get(instr.name)
        if arity is not None and instr.name not in NON_UNITARY:
            if len(instr.qubits) != arity:
                raise ValueError(
                    f"{instr.name} expects {arity} qubits, got {instr.qubits}"
                )
        for q in instr.qubits:
            if not (0 <= q < self.num_qubits):
                raise IndexError(f"qubit {q} out of range for {self.num_qubits}")
        for c in instr.clbits:
            if not (0 <= c < self.num_clbits):
                raise IndexError(f"clbit {c} out of range for {self.num_clbits}")
        self.instructions.append(instr)
        return instr

    def _g(self, name: str, qubits: Iterable[int], params=(), label=None):
        return self.append(
            Instruction(
                name, list(qubits), [],
                [p if isinstance(p, ParamRef) else float(p) for p in params],
                label,
            )
        )

    # 1q
    def id(self, q):        return self._g("id", [q])
    def h(self, q):         return self._g("h", [q])
    def x(self, q):         return self._g("x", [q])
    def y(self, q):         return self._g("y", [q])
    def z(self, q):         return self._g("z", [q])
    def s(self, q):         return self._g("s", [q])
    def sdg(self, q):       return self._g("sdg", [q])
    def t(self, q):         return self._g("t", [q])
    def tdg(self, q):       return self._g("tdg", [q])
    def sx(self, q):        return self._g("sx", [q])
    def rx(self, th, q):    return self._g("rx", [q], [th])
    def ry(self, th, q):    return self._g("ry", [q], [th])
    def rz(self, th, q):    return self._g("rz", [q], [th])
    def p(self, th, q):     return self._g("p", [q], [th])
    def u1(self, th, q):    return self._g("u1", [q], [th])
    def u2(self, a, b, q):  return self._g("u2", [q], [a, b])
    def u3(self, a, b, c, q): return self._g("u3", [q], [a, b, c])
    def u(self, a, b, c, q):  return self._g("u", [q], [a, b, c])
    # 2q
    def cx(self, a, b):     return self._g("cx", [a, b])
    def cy(self, a, b):     return self._g("cy", [a, b])
    def cz(self, a, b):     return self._g("cz", [a, b])
    def swap(self, a, b):   return self._g("swap", [a, b])
    def iswap(self, a, b):  return self._g("iswap", [a, b])
    def rzz(self, th, a, b): return self._g("rzz", [a, b], [th])
    def cp(self, th, a, b):  return self._g("cp", [a, b], [th])
    def cu1(self, th, a, b): return self._g("cu1", [a, b], [th])
    def crz(self, th, a, b): return self._g("crz", [a, b], [th])
    def fsim(self, th, ph, a, b): return self._g("fsim", [a, b], [th, ph])
    # 3q
    def ccx(self, a, b, c): return self._g("ccx", [a, b, c])
    # non-unitary
    def barrier(self, *qubits):
        qs = list(qubits) if qubits else list(range(self.num_qubits))
        return self.append(Instruction("barrier", qs))

    def measure(self, q, c):
        return self.append(Instruction("measure", [q], [c]))

    def reset(self, q):
        return self.append(Instruction("reset", [q]))

    def measure_all(self) -> None:
        """Adds a ``meas`` register + barrier + per-qubit measures, mirroring
        qiskit's measure_all used by every reference generator
        (benchmarks/helper_functions.py:135-203)."""
        base = self.num_clbits
        self.add_creg(Register("meas", self.num_qubits))
        self.barrier()
        for q in range(self.num_qubits):
            self.measure(q, base + q)

    # ------------------------------------------------------------ interchange
    @classmethod
    def from_qasm(cls, text: str) -> "Circuit":
        """Parse OpenQASM 2.0 (see :mod:`..circuit.qasm` for the subset)."""
        from .qasm import from_qasm

        return from_qasm(text)

    def to_qasm(self) -> str:
        """Serialize to OpenQASM 2.0 (uncut circuits only)."""
        from .qasm import to_qasm

        return to_qasm(self)

    # ------------------------------------------------------------ transforms
    def copy(self) -> "Circuit":
        new = Circuit(list(self.qregs), list(self.cregs), self.name)
        new.instructions = [i.copy() for i in self.instructions]
        return new

    def decompose(self) -> "Circuit":
        """One level of decomposition of composite ops (reference:
        Cutter.py:84 calls inputCirc.decompose()).  Primitive gates pass
        through; ``ccx`` expands to the standard 1q/2q decomposition; ops
        whose payload defines ``definition(qubits, clbits)`` expand to it."""
        new = Circuit(list(self.qregs), list(self.cregs), self.name)
        for ins in self.instructions:
            if ins.op is not None and hasattr(ins.op, "definition"):
                for sub in ins.op.definition(ins.qubits, ins.clbits):
                    new.append(sub)
            elif ins.name == "ccx":
                a, b, c = ins.qubits
                for sub in _ccx_definition(a, b, c):
                    new.append(sub)
            else:
                new.append(ins.copy())
        return new

    # -------------------------------------------------------------- queries
    def count_ops(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for i in self.instructions:
            out[i.name] = out.get(i.name, 0) + 1
        return out

    def depth(self) -> int:
        """Circuit depth over non-barrier ops (qiskit-compatible: measures
        count, barriers don't)."""
        level = [0] * (self.num_qubits + self.num_clbits)
        d = 0
        for ins in self.instructions:
            if ins.name == "barrier":
                continue
            bits = list(ins.qubits) + [self.num_qubits + c for c in ins.clbits]
            cond = getattr(ins, "condition", None)
            if cond is not None:
                bits.append(self.num_qubits + cond[0])
            lv = max(level[b] for b in bits) + 1
            for b in bits:
                level[b] = lv
            d = max(d, lv)
        return d

    def num_tensor_factors(self) -> int:
        """Number of connected components of the qubit-interaction graph
        (used by generate_circ's connectivity check,
        benchmarks/helper_functions.py:119)."""
        parent = list(range(self.num_qubits))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for ins in self.instructions:
            if ins.name == "barrier" or len(ins.qubits) < 2:
                continue
            qs = ins.qubits
            for q in qs[1:]:
                ra, rb = find(qs[0]), find(q)
                if ra != rb:
                    parent[ra] = rb
        return len({find(q) for q in range(self.num_qubits)})

    def two_qubit_ops(self) -> list[Instruction]:
        return [
            i for i in self.instructions
            if len(i.qubits) == 2 and i.name not in ("barrier",)
        ]

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Circuit(name={self.name!r}, q={self.num_qubits}, c={self.num_clbits},"
            f" ops={len(self.instructions)})"
        )

    def draw(self) -> str:
        """Text rendering (one op per line)."""
        lines = [repr(self)]
        for ins in self.instructions:
            lines.append(f"  {ins!r}")
        return "\n".join(lines)


def _ccx_definition(a: int, b: int, c: int) -> list[Instruction]:
    """Standard Toffoli decomposition into {h, t, tdg, cx}."""
    seq = [
        ("h", [c]), ("cx", [b, c]), ("tdg", [c]), ("cx", [a, c]),
        ("t", [c]), ("cx", [b, c]), ("tdg", [c]), ("cx", [a, c]),
        ("t", [b]), ("t", [c]), ("h", [c]), ("cx", [a, b]),
        ("t", [a]), ("tdg", [b]), ("cx", [a, b]),
    ]
    return [Instruction(n, q) for n, q in seq]
