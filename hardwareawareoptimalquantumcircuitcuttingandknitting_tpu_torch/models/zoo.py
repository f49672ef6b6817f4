"""Benchmark circuit zoo facade.

Behavioral port of benchmarks/helper_functions.py: ``generate_circ`` (typed
dispatch with connectivity retry loop) and ``genCirc`` (short-name dispatch
ran/sup/su/ghz/syc/hwe/bv/qft/aqft/add/erd used by the benchmark CLI,
helper_functions.py:206-234).

Port of the JAX package's ``models/zoo.py``, whole.  The ``regular`` and
``erdos`` graphs are drawn by ``models/graphs.py`` (networkx's draws,
without networkx, which the card's machine lacks).
"""
from __future__ import annotations

import math
import random

import numpy as np

from ..circuit.circuit import Circuit
from ..utils.logger import get_logger
from . import graphs
from .adder import gen_adder
from .bv import gen_BV
from .hwea import gen_hwea
from .qaoa import construct_qaoa_plus
from .qft import library_qft
from .random_circuit import random_circuit
from .su2 import efficient_su2
from .supremacy import gen_supremacy
from .sycamore import gen_sycamore


def factor_int(n: int):
    nsqrt = math.ceil(math.sqrt(n))
    val = nsqrt
    while True:
        co_val = int(n / val)
        if val * co_val == n:
            return val, co_val
        val -= 1


def gen_secret(num_qubit: int) -> str:
    num_digit = num_qubit - 1
    num = bin(2**num_digit - 1)[2:]
    return str(num).zfill(num_digit)


def generate_circ(
    num_qubits: int,
    depth: int,
    circuit_type: str,
    reg_name: str = "q",
    connected_only: bool = False,
    seed=None,
) -> Circuit | None:
    """helper_functions.generate_circ parity (66-127)."""
    random.seed(seed)
    if seed is not None:
        # the QAOA branches draw from numpy's global RNG and the graph
        # generators (models/graphs.py), neither of which random.seed pins
        np.random.seed(seed)
    full_circ = None
    num_trials = 100
    density = 0.001
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
        elif circuit_type == "bv":
            full_circ = gen_BV(
                gen_secret(num_qubits), barriers=False, regname=reg_name
            )
        elif circuit_type == "qft":
            full_circ = library_qft(
                num_qubits, approximation_degree=0, do_swaps=False
            )
        elif circuit_type == "aqft":
            approximation_degree = int(math.log(num_qubits, 2) + 2)
            full_circ = library_qft(
                num_qubits,
                approximation_degree=num_qubits - approximation_degree,
                do_swaps=False,
            )
        elif circuit_type == "adder":
            full_circ = gen_adder(
                nbits=int((num_qubits - 2) / 2), barriers=False,
                regname=reg_name,
            )
        elif circuit_type == "regular":
            if 3 * num_qubits % 2 == 0:
                # vary the seed per retry, else connected_only would redraw
                # the identical (possibly disconnected) graph 100 times
                trial_seed = None if seed is None else seed + (100 - num_trials)
                graph = graphs.random_regular_graph(3, num_qubits,
                                                    seed=trial_seed)
                full_circ = construct_qaoa_plus(
                    P=depth, G=graph,
                    params=[
                        np.random.uniform(-np.pi, np.pi)
                        for _ in range(2 * depth)
                    ],
                    reg_name=reg_name,
                )
        elif circuit_type == "erdos":
            trial_seed = None if seed is None else seed + (100 - num_trials)
            graph = graphs.gnp_random_graph(num_qubits, density,
                                            seed=trial_seed)
            full_circ = construct_qaoa_plus(
                P=depth, G=graph,
                params=[
                    np.random.uniform(-np.pi, np.pi) for _ in range(2 * depth)
                ],
                reg_name=reg_name,
            )
            density += 0.001
        else:
            raise Exception("Illegal circuit type:", circuit_type)

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


def _gen_or_raise(n_qubits: int, depth: int, kind: str, seed) -> Circuit:
    """generate_circ keeps the reference's None-on-unrealizable contract
    (helper_functions.py:66-127); the CLI/genCirc path turns that into a
    clear error instead of the reference's AttributeError crash."""
    circ = generate_circ(n_qubits, depth, kind, seed=seed)
    if circ is None:
        raise ValueError(
            f"{kind} generator cannot realize n_qubits={n_qubits} "
            f"depth={depth}"
        )
    return circ


def genCirc(circ_name: str, n_qubits: int, depth: int,
            seed=None) -> Circuit:
    """Reference benchmark.py's genCirc dispatch.  ``seed`` (ours only) pins
    the generator RNG for reproducible instances — the reference draws a
    fresh random instance per call (helper_functions.py:67 with
    seed=None) and averages runs instead."""
    log = get_logger(__name__)
    if seed is not None:
        random.seed(seed)
    if circ_name == "ran":
        circ = random_circuit(n_qubits, depth, seed=seed)
        circ.measure_all()
    elif circ_name == "sup":
        circ = _gen_or_raise(n_qubits, depth, "supremacy", seed=seed)
        circ.measure_all()
    elif circ_name == "su":
        if seed is not None:
            # efficient_su2 draws its parameters from numpy's global RNG,
            # which random.seed above does not pin
            np.random.seed(seed)
        circ = efficient_su2(n_qubits, "linear", reps=2)
        circ.measure_all()
    elif circ_name == "ghz":
        return generate_ghz(n_qubits)
    elif circ_name == "syc":
        circ = _gen_or_raise(n_qubits, depth, "sycamore", seed=seed)
        circ.measure_all()
    elif circ_name == "hwe":
        circ = _gen_or_raise(n_qubits, depth, "hwea", seed=seed)
        circ.measure_all()
    elif circ_name == "bv":
        circ = _gen_or_raise(n_qubits, depth, "bv", seed=seed)
        circ.measure_all()
    elif circ_name == "qft":
        circ = _gen_or_raise(n_qubits, depth, "qft", seed=seed)
        circ.measure_all()
    elif circ_name == "aqft":
        circ = _gen_or_raise(n_qubits, depth, "aqft", seed=seed)
        circ.measure_all()
    elif circ_name == "add":
        circ = _gen_or_raise(n_qubits, depth, "adder", seed=seed)
        circ.measure_all()
    elif circ_name == "erd":
        circ = _gen_or_raise(n_qubits, depth, "erdos", seed=seed)
        circ.measure_all()
    elif circ_name == "reg":
        circ = _gen_or_raise(n_qubits, depth, "regular", seed=seed)
        circ.measure_all()
    else:
        raise RuntimeError(f"circName {circ_name} is not supported")
    log.info(
        f"{circ_name} circuit with {n_qubits} qubits & depth {depth} generated"
    )
    return circ
