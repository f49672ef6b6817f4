"""Causal-lightcone extraction: the exact marginal of a shallow circuit.

For a kept set of measured qubits, only gates in their backward lightcone
affect the marginal distribution; everything else traces out to identity.
For depth-d circuits on bounded-degree connectivity the cone has O(keep *
degree^d) qubits, so 30+ qubit shallow circuits get *exact* marginal
oracles from a small statevector simulation — the validation counterpart
to the marginal knit (ops/knit.py keep_clbits).

Port of the JAX package's ``circuit/lightcone.py``: the cone is found on
the host, its statevector runs on ``device`` (None = the card) through
``ops/statevector.simulate_circuit``, and the marginal's numpy tail is
the JAX package's.
"""
from __future__ import annotations

from .circuit import Circuit, Register


def lightcone_circuit(
    circ: Circuit, keep_clbits: set[int]
) -> tuple[Circuit, dict[int, int]]:
    """Extract the sub-circuit causally relevant to ``keep_clbits``.

    Returns (subcircuit, clbit_map) where clbit_map maps original kept
    clbit -> subcircuit clbit.  The subcircuit measures exactly the kept
    clbits (compacted), on compacted qubits.
    """
    # find the measuring instruction per kept clbit
    keep_qubits: set[int] = set()
    for ins in circ.instructions:
        if ins.name == "measure" and ins.clbits[0] in keep_clbits:
            keep_qubits.add(ins.qubits[0])

    # backward pass: grow the support set.  Mid-circuit measurements of
    # NON-kept clbits must be retained when their qubit is in the support:
    # the measurement dephases the qubit, which changes kept marginals.
    # (Terminal measures of non-kept clbits commute out and are dropped.)
    support = set(keep_qubits)
    touched_after: set[int] = set()  # qubits with later retained ops
    kept_instrs: list = []
    extra_clbits: set[int] = set()
    for ins in reversed(circ.instructions):
        if ins.name in ("barrier",):
            continue
        if ins.name == "measure":
            if ins.clbits[0] in keep_clbits:
                kept_instrs.append(ins)
                touched_after.add(ins.qubits[0])
            elif ins.qubits[0] in support and ins.qubits[0] in touched_after:
                kept_instrs.append(ins)
                extra_clbits.add(ins.clbits[0])
            continue
        if ins.condition is not None:
            raise NotImplementedError("lightcone over classical feedback")
        if any(q in support for q in ins.qubits):
            support.update(ins.qubits)
            touched_after.update(ins.qubits)
            kept_instrs.append(ins)
    kept_instrs.reverse()

    qubit_map = {q: i for i, q in enumerate(sorted(support))}
    clbit_map = {
        c: i for i, c in enumerate(sorted(keep_clbits | extra_clbits))
    }
    sub = Circuit(
        [Register("q", len(qubit_map))], len(clbit_map), name="lightcone"
    )
    for ins in kept_instrs:
        local = ins.copy()
        local.qubits = [qubit_map[q] for q in ins.qubits]
        if ins.name == "measure":
            local.clbits = [clbit_map[ins.clbits[0]]]
        sub.append(local)
    return sub, clbit_map


def lightcone_marginal(circ: Circuit, keep_clbits: set[int], precomputed=None,
                       device=None):
    """Exact marginal distribution over ``keep_clbits`` via the lightcone
    subcircuit (Distribution with bit_positions = sorted kept clbits).

    ``precomputed``: optional ``(sub, clbit_map)`` from a prior
    :func:`lightcone_circuit` call, to avoid re-walking the circuit.
    ``device``: where the sub-circuit's statevector runs (None = "cuda",
    raises without a card; "cpu" runs the plain PyTorch simulator)."""
    import numpy as np

    from ..ops.statevector import Distribution, simulate_circuit

    sub, clbit_map = (
        precomputed if precomputed is not None
        else lightcone_circuit(circ, keep_clbits)
    )
    dist = simulate_circuit(sub, device=device)
    # sum out retained-for-dephasing clbits (non-kept mid-circuit measures)
    keep_local = sorted(clbit_map[c] for c in keep_clbits)
    # a kept clbit that is never measured reads as the implicit constant 0
    # of the Distribution convention (same as the knit path's keep_clbits)
    present = [c for c in keep_local if c in dist.bit_positions]
    if dist.bit_positions != present:
        k = len(dist.bit_positions)
        vals = np.asarray(dist.values, dtype=np.float64)
        # bit j (LSB) of the flat index carries bit_positions[j]: in the
        # (2,)*k C-order view axis t is bit k-1-t
        arr = vals.reshape((2,) * k)
        keep_idx = [dist.bit_positions.index(c) for c in present]
        drop_axes = tuple(
            k - 1 - j for j in range(k) if j not in keep_idx
        )
        arr = arr.sum(axis=drop_axes)
        # remaining axes keep their relative order (descending bit index),
        # so the C-order flatten already has present[0] as the LSB
        values = arr.reshape(-1).astype(np.float32)
    else:
        values = dist.values
    if present != keep_local:
        # expand to the full kept set: never-measured bits pinned to 0
        m = len(keep_local)
        full = np.zeros(1 << m, dtype=np.float32)
        pos_in_full = [keep_local.index(c) for c in present]
        idx = np.arange(len(values))
        full_idx = np.zeros_like(idx)
        for j, pj in enumerate(pos_in_full):
            full_idx |= ((idx >> j) & 1) << pj
        full[full_idx] = values
        values = full
    return Distribution(values, sorted(keep_clbits), circ.num_clbits)
