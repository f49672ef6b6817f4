"""Benchmark circuit zoo facade: the supremacy, Sycamore, hardware-
efficient-ansatz, QFT / AQFT and GHZ generators.

Behavioral port of benchmarks/helper_functions.py's ``generate_circ``
(supremacy, sycamore, hwea, qft and aqft branches, with the connectivity
retry loop) and ``genCirc`` (short names ``sup``, ``syc``, ``hwe``,
``qft``, ``aqft`` and ``ghz``).  The other generators are not ported yet
(ROADMAP H100 port, queue A, "other zoo generators"); this module imports
no graph library, so it loads where ``networkx`` is absent.
"""
from __future__ import annotations

import math
import random

import numpy as np

from ..circuit.circuit import Circuit
from ..utils.logger import get_logger
from .hwea import gen_hwea
from .qft import library_qft
from .supremacy import gen_supremacy
from .sycamore import gen_sycamore

_NOT_PORTED = (
    "is not ported to the torch package yet: ROADMAP H100 port, queue A, "
    "'other zoo generators'"
)


def factor_int(n: int):
    nsqrt = math.ceil(math.sqrt(n))
    val = nsqrt
    while True:
        co_val = int(n / val)
        if val * co_val == n:
            return val, co_val
        val -= 1


def generate_circ(
    num_qubits: int,
    depth: int,
    circuit_type: str,
    reg_name: str = "q",
    connected_only: bool = False,
    seed=None,
) -> Circuit | None:
    """helper_functions.generate_circ parity (66-127): the supremacy,
    sycamore, hwea, qft and aqft branches."""
    if circuit_type not in ("supremacy", "sycamore", "hwea", "qft", "aqft"):
        raise NotImplementedError(f"circuit type {circuit_type!r} {_NOT_PORTED}")
    random.seed(seed)
    if seed is not None:
        np.random.seed(seed)
    full_circ = None
    num_trials = 100
    while num_trials:
        if circuit_type == "supremacy":
            i, j = factor_int(num_qubits)
            if abs(i - j) <= 2:
                full_circ = gen_supremacy(i, j, depth * 8, regname=reg_name)
        elif circuit_type == "sycamore":
            i, j = factor_int(num_qubits)
            full_circ = gen_sycamore(i, j, depth, regname=reg_name)
        elif circuit_type == "hwea":
            full_circ = gen_hwea(num_qubits, depth, regname=reg_name)
        elif circuit_type == "qft":
            full_circ = library_qft(
                num_qubits, approximation_degree=0, do_swaps=False
            )
        else:
            approximation_degree = int(math.log(num_qubits, 2) + 2)
            full_circ = library_qft(
                num_qubits,
                approximation_degree=num_qubits - approximation_degree,
                do_swaps=False,
            )

        if full_circ is not None and full_circ.num_tensor_factors() == 1:
            break
        elif full_circ is not None and not connected_only:
            break
        else:
            full_circ = None
            num_trials -= 1
    assert full_circ is None or full_circ.num_qubits == num_qubits
    return full_circ


def generate_ghz(n_qubits: int) -> Circuit:
    """helper_functions.generateGhz (154-161): note the reference creates
    QuantumCircuit(n, n) then measure_all(), yielding 2n clbits."""
    circ = Circuit(n_qubits, n_qubits)
    circ.h(0)
    for i in range(1, n_qubits):
        circ.cx(i - 1, i)
    circ.measure_all()
    return circ


def genCirc(circ_name: str, n_qubits: int, depth: int,
            seed=None) -> Circuit:
    """Reference benchmark.py's genCirc dispatch for ``sup``, ``syc``,
    ``hwe``, ``qft``, ``aqft`` and ``ghz``.  ``seed`` pins the generator RNG for reproducible
    instances."""
    log = get_logger(__name__)
    if seed is not None:
        random.seed(seed)
    kinds = {"sup": "supremacy", "syc": "sycamore", "hwe": "hwea",
             "qft": "qft", "aqft": "aqft"}
    if circ_name in kinds:
        kind = kinds[circ_name]
        circ = generate_circ(n_qubits, depth, kind, seed=seed)
        if circ is None:
            raise ValueError(
                f"{kind} generator cannot realize n_qubits={n_qubits} "
                f"depth={depth}"
            )
        circ.measure_all()
    elif circ_name == "ghz":
        return generate_ghz(n_qubits)
    else:
        raise NotImplementedError(f"circName {circ_name!r} {_NOT_PORTED}")
    log.info(
        f"{circ_name} circuit with {n_qubits} qubits & depth {depth} generated"
    )
    return circ
