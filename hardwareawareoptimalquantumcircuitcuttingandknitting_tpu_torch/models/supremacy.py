"""Google 2018 quantum-supremacy grid circuits.

Behavioral port of benchmarks/qcg/Supremacy/{Qgrid_original,cz_layer_generation,
Qbit_original}.py — same CZ layer patterns, Google gate order, and
T / sqrt-X / sqrt-Y single-qubit gate placement rules.
"""
from __future__ import annotations

import math
import random as rand

from ..circuit.circuit import Circuit, Register


def _cz_layer(nrow: int, ncol: int, s: int):
    out = []
    if s in (0, 1):
        for row in range(0, nrow, 2):
            for col in range(0, ncol, 4):
                if col + s + 1 < ncol:
                    out.append(([row, col + s], [row, col + s + 1]))
                if col + s + 3 < ncol and row + 1 < nrow:
                    out.append(([row + 1, col + s + 2], [row + 1, col + s + 3]))
    elif s in (2, 3):
        for row in range(0, nrow, 2):
            for col in range(0, ncol, 4):
                if col + s - 1 < ncol and row + 1 < nrow:
                    out.append(([row + 1, col + s - 2], [row + 1, col + s - 1]))
                if col + s + 1 < ncol:
                    out.append(([row, col + s], [row, col + s + 1]))
    elif s in (4, 5):
        for col in range(0, ncol, 2):
            for row in range(0, nrow, 4):
                if row + s - 3 < nrow:
                    out.append(([row + s - 4, col], [row + s - 3, col]))
                if row + s - 1 < nrow and col + 1 < ncol:
                    out.append(([row + s - 2, col + 1], [row + s - 1, col + 1]))
    elif s in (6, 7):
        for col in range(0, ncol, 2):
            for row in range(0, nrow, 4):
                if row + s - 5 < nrow and col + 1 < ncol:
                    out.append(([row + s - 6, col + 1], [row + s - 5, col + 1]))
                if row + s - 3 < nrow:
                    out.append(([row + s - 4, col], [row + s - 3, col]))
    return out


def _get_layers(n: int, m: int):
    return [_cz_layer(n, m, i) for i in range(8)]


def gen_supremacy(
    height: int,
    width: int,
    depth: int,
    order=None,
    singlegates: bool = True,
    mirror: bool = False,
    barriers: bool = False,
    measure: bool = False,
    regname: str | None = None,
) -> Circuit:
    n, m = height, width
    nq = n * m
    circ = Circuit([Register(regname or "q", nq)], 0, name="supremacy")
    if measure:
        circ.cregs = [Register(("c" + regname) if regname else "c", nq)]

    cz_list = _get_layers(n, m)
    order = [0, 5, 1, 4, 2, 7, 3, 6] if order is None else [int(c) for c in order]
    idx = lambda loc: loc[0] * m + loc[1]

    for q in range(nq):
        circ.h(q)

    cz_idx = -1
    nlayer = len(cz_list)
    prev_nondiag: list = []
    for i in range(depth):
        prev_idx = cz_idx
        if mirror:
            if (i // nlayer) % 2 == 0:
                cz_idx = order[i % nlayer]
            else:
                cz_idx = order[::-1][i % nlayer]
        else:
            cz_idx = order[i % nlayer]

        cur = cz_list[cz_idx]
        pre = cz_list[prev_idx]
        reserved: list[int] = []
        for a, b in cur:
            reserved += [idx(a), idx(b)]
            circ.cz(idx(a), idx(b))

        if i == 0 and singlegates:
            for r in range(n):
                for c in range(m):
                    if idx([r, c]) not in reserved:
                        circ.t(idx([r, c]))
        if i > 1 and singlegates:
            for loc in prev_nondiag:
                if idx(loc) not in reserved:
                    circ.t(idx(loc))
        if i > 0 and singlegates:
            prev_nondiag = []
            for cz_pair in pre:
                for loc in cz_pair:
                    if idx(loc) not in reserved:
                        # random sqrt-X / sqrt-Y (Qbit_original.random_gate)
                        if rand.randint(0, 1) == 0:
                            circ.rx(math.pi / 2, idx(loc))
                        else:
                            circ.ry(math.pi / 2, idx(loc))
                        prev_nondiag.append(loc)
        if barriers:
            circ.barrier()

    for q in range(nq):
        circ.h(q)
    if measure:
        circ.barrier()
        for q in range(nq):
            circ.measure(q, q)
    return circ
