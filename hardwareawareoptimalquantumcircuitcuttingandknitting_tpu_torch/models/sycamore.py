"""Google 2019 Sycamore-style grid circuits.

Behavioral port of benchmarks/qcg/Supremacy/{Qgrid_Sycamore,
ABCD_layer_generation,Qbit_Sycamore}.py: ABCDCDAB layer order, per-qubit
non-repeating random {sqrt-X, sqrt-Y, W(=Z here, as in the reference)} gates,
CZ entanglers (the reference also substitutes CZ for fSim, Qgrid_Sycamore.py:166).
"""
from __future__ import annotations

import math
import random as rand

from ..circuit.circuit import Circuit, Register


def _pattern(n, m, horizontal: bool, even_start: int):
    out = []
    if horizontal:
        for row in range(n):
            start = even_start if row % 2 == 0 else 1 - even_start
            for col in range(start, m, 2):
                if col != m - 1:
                    out.append(([row, col], [row, col + 1]))
    else:
        for col in range(m):
            start = even_start if col % 2 == 0 else 1 - even_start
            for row in range(start, n, 2):
                if row != n - 1:
                    out.append(([row, col], [row + 1, col]))
    return out


def _get_layers(n, m):
    return [
        _pattern(n, m, True, 0),   # A
        _pattern(n, m, True, 1),   # B
        _pattern(n, m, False, 0),  # C
        _pattern(n, m, False, 1),  # D
    ]


_GATE_NEXT = {"X": ("Y", "W"), "Y": ("X", "W"), "W": ("X", "Y")}


def gen_sycamore(
    height: int,
    width: int,
    depth: int,
    order=None,
    singlegates: bool = True,
    barriers: bool = False,
    measure: bool = False,
    regname: str | None = None,
) -> Circuit:
    n, m = height, width
    nq = n * m
    circ = Circuit([Register(regname or "q", nq)], 0, name="sycamore")
    if measure:
        circ.cregs = [Register(("c" + regname) if regname else "c", nq)]

    layers = _get_layers(n, m)
    order = [0, 1, 2, 3, 2, 3, 0, 1] if order is None else [int(c) for c in order]
    idx = lambda loc: loc[0] * m + loc[1]
    prev_gate = [None] * nq

    for i in range(depth):
        for q in range(nq):
            if prev_gate[q] is None:
                g = ["X", "Y", "W"][rand.randint(0, 2)]
            else:
                g = _GATE_NEXT[prev_gate[q]][rand.randint(0, 1)]
            prev_gate[q] = g
            if g == "X":
                circ.rx(math.pi / 2, q)
            elif g == "Y":
                circ.ry(math.pi / 2, q)
            else:  # "W" — the reference applies Z here (Qgrid_Sycamore.py:146)
                circ.z(q)
        for a, b in layers[order[i % len(order)]]:
            circ.cz(idx(a), idx(b))
        if barriers:
            circ.barrier()

    if measure:
        circ.barrier()
        for q in range(nq):
            circ.measure(q, q)
    return circ
