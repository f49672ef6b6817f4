"""OpenQASM 2.0 import/export — the migration bridge for reference users.

Port of the JAX package's ``circuit/qasm.py``: the same parser, the same
text out, the same errors.

The reference consumes qiskit ``QuantumCircuit``s everywhere (SURVEY §2.4
"qiskit role"); a migrating user's circuits already exist as qiskit objects
and ``QuantumCircuit.qasm()`` (qiskit 0.44, the reference's pin) is the
natural interchange.  :func:`from_qasm` parses the pragmatic OpenQASM 2.0
subset qiskit emits — qreg/creg declarations, qelib1 gate applications
(including register broadcast), file-local ``gate`` definitions (expanded
recursively with parameter-expression evaluation), ``measure``/``reset``/
``barrier``, and single-bit ``if (c==v)`` conditions — into the first-party
:class:`Circuit` IR.  :func:`to_qasm` goes the other way for uncut circuits
(virtual-gate payloads are not representable in QASM 2 and raise).

Parameter expressions (``pi/2``, ``-3*pi/4``, ``theta/2`` inside gate
bodies) are evaluated with a restricted AST walker — no ``eval``.
"""
from __future__ import annotations

import ast
import math
import re

from .circuit import Circuit, Instruction, Register
from .gates import GATE_ARITY, NON_UNITARY

# QASM 2 unary functions (spec table) — ln spelled log for python math
_FUNCS = {
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "exp": math.exp, "ln": math.log, "sqrt": math.sqrt,
    "asin": math.asin, "acos": math.acos, "atan": math.atan,
}


def _eval_expr(expr: str, env: dict) -> float:
    """Evaluate a QASM parameter expression on a restricted AST."""
    import keyword

    # QASM identifiers may be Python keywords (qelib1 uses `lambda`) —
    # alias them before handing the expression to ast.parse
    renames = {
        k: f"_{k}_" for k in list(env) if keyword.iskeyword(k)
    }
    for old, new in renames.items():
        expr = re.sub(rf"\b{old}\b", new, expr)
    if renames:
        env = {renames.get(k, k): v for k, v in env.items()}
    node = ast.parse(expr.strip(), mode="eval").body

    def ev(n):
        if isinstance(n, ast.Constant) and isinstance(n.value, (int, float)):
            return float(n.value)
        if isinstance(n, ast.Name):
            if n.id == "pi":
                return math.pi
            if n.id in env:
                return float(env[n.id])
            raise ValueError(f"unknown identifier {n.id!r} in expression")
        if isinstance(n, ast.UnaryOp):
            v = ev(n.operand)
            if isinstance(n.op, ast.USub):
                return -v
            if isinstance(n.op, ast.UAdd):
                return v
        if isinstance(n, ast.BinOp):
            a, b = ev(n.left), ev(n.right)
            if isinstance(n.op, ast.Add):
                return a + b
            if isinstance(n.op, ast.Sub):
                return a - b
            if isinstance(n.op, ast.Mult):
                return a * b
            if isinstance(n.op, ast.Div):
                return a / b
            if isinstance(n.op, (ast.Pow, ast.BitXor)):  # QASM ^ is power
                return a ** b
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            fn = _FUNCS.get(n.func.id)
            if fn is not None and len(n.args) == 1:
                return fn(ev(n.args[0]))
        raise ValueError(f"unsupported expression: {expr!r}")

    return ev(node)


_GATE_DEF = re.compile(
    r"gate\s+(?P<name>[a-zA-Z_]\w*)\s*"
    r"(?:\(\s*(?P<params>[^)]*)\)\s*)?"
    r"(?P<args>[^{]*?)\s*\{(?P<body>[^}]*)\}",
    re.S,
)
_APP = re.compile(
    r"^(?P<name>[a-zA-Z_]\w*)\s*"
    r"(?:\(\s*(?P<params>.*)\)\s*)?"
    r"(?P<args>[^()]*)$",
    re.S,
)
_REF = re.compile(r"^(?P<reg>[a-zA-Z_]\w*)\s*(?:\[\s*(?P<idx>\d+)\s*\])?$")


def _split_top(s: str) -> list[str]:
    """Split on commas not nested inside parentheses."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur))
    return [x.strip() for x in out]


class _GateDef:
    def __init__(self, params: list[str], args: list[str], body: str):
        self.params = params
        self.args = args
        self.body = body


# qelib1.inc gates with no native matrix here, expanded like file-local
# definitions (the parser skips `include`, so these supply the bodies a
# qiskit 0.44 dump relies on; decompositions are exact, verified by
# round-trip tests against numpy-built controlled unitaries)
_QELIB1_SUPPLEMENT = """
gate ch a,b { ry(pi/4) b; cx a,b; ry(-pi/4) b; }
gate crx(theta) a,b { h b; crz(theta) a,b; h b; }
gate cry(theta) a,b { ry(theta/2) b; cx a,b; ry(-theta/2) b; cx a,b; }
gate csx a,b { h b; cu1(pi/2) a,b; h b; }
gate cswap a,b,c { cx c,b; ccx a,b,c; cx c,b; }
gate rxx(theta) a,b { h a; h b; cx a,b; rz(theta) b; cx a,b; h a; h b; }
gate ryy(theta) a,b { sdg a; sdg b; h a; h b; cx a,b; rz(theta) b; cx a,b; h a; h b; s a; s b; }
gate cu3(theta,phi,lambda) c,t { u1((lambda+phi)/2) c; u1((lambda-phi)/2) t; cx c,t; u3(-theta/2,0,-(phi+lambda)/2) t; cx c,t; u3(theta/2,phi,0) t; }
gate cu(theta,phi,lambda,gamma) c,t { u1(gamma) c; cu3(theta,phi,lambda) c,t; }
"""


def _supplement_defs() -> dict:
    out: dict[str, _GateDef] = {}
    for m in _GATE_DEF.finditer(_QELIB1_SUPPLEMENT):
        out[m.group("name")] = _GateDef(
            _split_top(m.group("params") or ""),
            _split_top(m.group("args") or ""),
            m.group("body"),
        )
    return out


def from_qasm(text: str) -> Circuit:
    """Parse OpenQASM 2.0 source into a :class:`Circuit`."""
    text = re.sub(r"//[^\n]*", "", text)

    gate_defs: dict[str, _GateDef] = _supplement_defs()

    def grab(m: re.Match) -> str:
        params = _split_top(m.group("params") or "")
        args = _split_top(m.group("args") or "")
        gate_defs[m.group("name")] = _GateDef(params, args, m.group("body"))
        return ""

    text = _GATE_DEF.sub(grab, text)

    qregs: list[Register] = []
    cregs: list[Register] = []
    qbase: dict[str, int] = {}
    cbase: dict[str, int] = {}
    instrs: list[Instruction] = []

    def qref(tok: str) -> list[int]:
        m = _REF.match(tok.strip())
        if not m or m.group("reg") not in qbase:
            raise ValueError(f"unknown qubit reference {tok!r}")
        reg = m.group("reg")
        size = next(r.size for r in qregs if r.name == reg)
        if m.group("idx") is None:
            return [qbase[reg] + i for i in range(size)]
        i = int(m.group("idx"))
        if i >= size:
            raise ValueError(f"qubit index out of range: {tok!r}")
        return [qbase[reg] + i]

    def cref(tok: str) -> list[int]:
        m = _REF.match(tok.strip())
        if not m or m.group("reg") not in cbase:
            raise ValueError(f"unknown clbit reference {tok!r}")
        reg = m.group("reg")
        size = next(r.size for r in cregs if r.name == reg)
        if m.group("idx") is None:
            return [cbase[reg] + i for i in range(size)]
        i = int(m.group("idx"))
        if i >= size:
            raise ValueError(f"clbit index out of range: {tok!r}")
        return [cbase[reg] + i]

    def broadcast(groups: list[list[int]]) -> list[tuple[int, ...]]:
        n = max(len(g) for g in groups)
        if any(len(g) not in (1, n) for g in groups):
            raise ValueError("mismatched register sizes in broadcast")
        return [
            tuple(g[0] if len(g) == 1 else g[i] for g in groups)
            for i in range(n)
        ]

    def apply(name: str, params: list[float], qubits: list[int],
              condition=None, depth: int = 0) -> None:
        if depth > 32:
            raise ValueError("gate definition recursion too deep")
        if name in gate_defs:
            d = gate_defs[name]
            if len(d.params) != len(params) or len(d.args) != len(qubits):
                raise ValueError(f"arity mismatch expanding gate {name!r}")
            env = dict(zip(d.params, params))
            binding = dict(zip(d.args, qubits))
            for stmt in d.body.split(";"):
                stmt = stmt.strip()
                if not stmt or stmt.startswith("barrier"):
                    continue
                m = _APP.match(stmt)
                if not m:
                    raise ValueError(f"bad statement in gate body: {stmt!r}")
                sub_params = [
                    _eval_expr(p, env)
                    for p in _split_top(m.group("params") or "")
                ]
                sub_qubits = [
                    binding[a.strip()]
                    for a in _split_top(m.group("args") or "")
                ]
                apply(m.group("name"), sub_params, sub_qubits,
                      condition, depth + 1)
            return
        if name in ("id", "u0"):
            return
        if name == "CX":
            name = "cx"
        arity = GATE_ARITY.get(name)
        if arity is None or name in NON_UNITARY:
            raise ValueError(
                f"gate {name!r} is not supported and has no definition "
                "in this file"
            )
        if arity != len(qubits):
            raise ValueError(f"{name} expects {arity} qubits, got {qubits}")
        instrs.append(
            Instruction(name, list(qubits), params=params,
                        condition=condition)
        )

    for raw in text.split(";"):
        stmt = " ".join(raw.split())
        if not stmt:
            continue
        if stmt.startswith("OPENQASM") or stmt.startswith("include"):
            continue
        if stmt.startswith("opaque"):
            raise ValueError(f"opaque gates unsupported: {stmt!r}")

        condition = None
        m = re.match(r"^if\s*\(\s*(\w+)\s*==\s*(\d+)\s*\)\s*(.*)$", stmt)
        if m:
            reg, val, stmt = m.group(1), int(m.group(2)), m.group(3)
            size = next((r.size for r in cregs if r.name == reg), None)
            if size is None:
                raise ValueError(f"condition on unknown creg {reg!r}")
            if size != 1:
                raise ValueError(
                    "only single-bit creg conditions are supported "
                    f"(creg {reg} has {size} bits) — the IR's c_if is "
                    "one clbit, like the reference's qubit-reuse usage"
                )
            condition = (cbase[reg], val)

        m = re.match(r"^(qreg|creg)\s+([a-zA-Z_]\w*)\s*\[\s*(\d+)\s*\]$",
                     stmt)
        if m:
            kind, name, size = m.group(1), m.group(2), int(m.group(3))
            reg = Register(name, size)
            if kind == "qreg":
                qbase[name] = sum(r.size for r in qregs)
                qregs.append(reg)
            else:
                cbase[name] = sum(r.size for r in cregs)
                cregs.append(reg)
            continue

        m = re.match(r"^measure\s+(.*?)\s*->\s*(.*)$", stmt)
        if m:
            for q, c in broadcast([qref(m.group(1)), cref(m.group(2))]):
                instrs.append(
                    Instruction("measure", [q], clbits=[c],
                                condition=condition)
                )
            continue

        m = re.match(r"^reset\s+(.*)$", stmt)
        if m:
            for (q,) in broadcast([qref(m.group(1))]):
                instrs.append(Instruction("reset", [q], condition=condition))
            continue

        if stmt.startswith("barrier"):
            qs = [
                q for tok in _split_top(stmt[len("barrier"):])
                for q in qref(tok)
            ]
            instrs.append(Instruction("barrier", qs))
            continue

        m = _APP.match(stmt)
        if not m:
            raise ValueError(f"unparseable statement: {stmt!r}")
        params = [
            _eval_expr(p, {}) for p in _split_top(m.group("params") or "")
        ]
        arg_groups = [qref(tok) for tok in _split_top(m.group("args") or "")]
        if not arg_groups:
            raise ValueError(f"gate application without qubits: {stmt!r}")
        for qubits in broadcast(arg_groups):
            apply(m.group("name"), params, list(qubits), condition)

    circ = Circuit(qregs or 0, cregs or 0, name="qasm")
    for ins in instrs:
        circ.append(ins)
    return circ


def from_qasm_file(path) -> Circuit:
    with open(path) as f:
        return from_qasm(f.read())


# names qiskit's qelib1-era parsers accept directly (qiskit >= 0.45's
# qasm2 loader with LEGACY_CUSTOM_INSTRUCTIONS also takes sx/p/cp/rzz)
_EXPORT_RENAME = {"p": "u1", "cp": "cu1"}
# gates with no qelib1 spelling: emit a local definition
_EXPORT_DEFS = {
    "sxdg": "gate sxdg a { s a; h a; s a; }",
    "sx": "gate sx a { sdg a; h a; sdg a; }",
    "iswap": "gate iswap a,b { s a; s b; h a; cx a,b; cx b,a; h b; }",
    "fsim": (
        "gate fsim(theta,phi) a,b { rxx(theta) a,b; ryy(theta) a,b; "
        "cu1(-phi) a,b; }"
    ),
    "rxx": (
        "gate rxx(theta) a,b { h a; h b; cx a,b; rz(theta) b; cx a,b; "
        "h a; h b; }"
    ),
    "ryy": (
        "gate ryy(theta) a,b { sdg a; sdg b; h a; h b; cx a,b; "
        "rz(theta) b; cx a,b; h a; h b; s a; s b; }"
    ),
}
_FSIM_NEEDS = ("rxx", "ryy")


def to_qasm(circ: Circuit) -> str:
    """Serialize an (uncut) circuit to OpenQASM 2.0.

    Virtual-gate / wire-cut payload instructions are not representable in
    QASM 2 and raise — export the original circuit, or the per-fragment
    instantiations (which are plain circuits), not the marked cut circuit.
    """
    qname = {}
    cname = {}
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";']
    used = {ins.name for ins in circ.instructions}
    defs = []
    for g in sorted(used & set(_EXPORT_DEFS)):
        if g == "fsim":
            defs.extend(_EXPORT_DEFS[d] for d in _FSIM_NEEDS
                        if d not in used)
        defs.append(_EXPORT_DEFS[g])
    # dedupe, preserving order
    seen = set()
    for d in defs:
        if d not in seen:
            seen.add(d)
            lines.append(d)

    for reg in circ.qregs:
        base = len(qname)
        for i in range(reg.size):
            qname[base + i] = f"{reg.name}[{i}]"
        lines.append(f"qreg {reg.name}[{reg.size}];")
    for reg in circ.cregs:
        base = len(cname)
        for i in range(reg.size):
            cname[base + i] = (reg.name, i, reg.size)
        lines.append(f"creg {reg.name}[{reg.size}];")

    for ins in circ.instructions:
        prefix = ""
        if ins.condition is not None:
            reg, idx, size = cname[ins.condition[0]]
            if size != 1:
                raise ValueError(
                    "c_if on a clbit inside a multi-bit creg has no exact "
                    "QASM 2 spelling; re-register the condition bit in its "
                    "own creg"
                )
            prefix = f"if ({reg}=={ins.condition[1]}) "
        if ins.name == "barrier":
            qs = ins.qubits or list(range(circ.num_qubits))
            lines.append("barrier " + ",".join(qname[q] for q in qs) + ";")
            continue
        if ins.name == "measure":
            reg, idx, _ = cname[ins.clbits[0]]
            lines.append(
                f"{prefix}measure {qname[ins.qubits[0]]} -> {reg}[{idx}];"
            )
            continue
        if ins.name == "reset":
            lines.append(f"{prefix}reset {qname[ins.qubits[0]]};")
            continue
        if ins.name not in GATE_ARITY or ins.op is not None:
            raise ValueError(
                f"instruction {ins.name!r} (op={type(ins.op).__name__}) "
                "is not representable in OpenQASM 2"
            )
        name = _EXPORT_RENAME.get(ins.name, ins.name)
        params = ""
        if ins.params:
            params = "(" + ",".join(repr(float(p)) for p in ins.params) + ")"
        args = ",".join(qname[q] for q in ins.qubits)
        lines.append(f"{prefix}{name}{params} {args};")
    return "\n".join(lines) + "\n"
