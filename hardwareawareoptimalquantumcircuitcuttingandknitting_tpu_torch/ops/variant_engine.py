"""Host helpers of the variant engine: per-slot tables and the label ->
variant-index convention.

Port of the JAX package's ``ops/variant_engine.py`` helpers that the
kernel-backed engines need (``_slot_tables``, ``label_strides``,
``variant_index_table``, ``label_weight_bounds``, ``_fuse_slot_ops``) and
of the host side of collapse mode (:func:`collapse_stream`: what
``make_sim_fn(collapse=True, fuse_qubits=2)`` plans there, at full width
and without a simulation closure).  Pure numpy.  The batched default
engine (``make_sim_fn``, ``run_all_fragments``) is not ported yet (ROADMAP
H100 port, queue A, "other engines").
"""
from __future__ import annotations

import numpy as np

from ..circuit.gates import COMPLEX, CX
from ..virt.tables import VGateSpec
from ..virt.virtual_circuit import FragmentProgram
from .statevector import to_real_block

_I4 = np.eye(4, dtype=COMPLEX)


def _stack_blocks(mats: np.ndarray) -> np.ndarray:
    """[V, m, m] complex -> [V, 2, m, 2, m] real blocks."""
    return np.stack([to_real_block(m) for m in mats])


def _slot_tables(
    prog: FragmentProgram, specs: list[VGateSpec], fused: bool = False,
) -> list[tuple[np.ndarray, ...]]:
    """Per-slot (pre[nI,...], meas4[nI,...], post[nI,...]) real-block
    variant tables — one row per instantiation of the slot's vgate.

    These are the *un-gathered* building blocks: the streamed path keeps
    them as small device tables and gathers them by per-label variant
    indices on the device (host->device traffic and host memory then
    scale with #labels x #vgates x 4 bytes instead of #labels x #slots x
    ~384 bytes).

    ``fused=True``: ONE composed block per slot — ``(post x I) @ meas4 @
    (pre x I)`` on (endpoint qubit, deferral ancilla) for measuring
    slots, ``post @ pre`` otherwise — returned as 1-tuples.  Matches the
    single "slot" plan step :func:`make_sim_fn` emits with
    ``fused_slots=True``: 3 HBM passes per slot become 1 (slot passes
    carry 20-91% of per-variant traffic on the baseline configs)."""
    out = []
    for slot in prog.slots:
        spec = specs[slot.vgate_idx]
        pres = np.stack([p[slot.side].pre for p in spec.endpoints])
        posts = np.stack([p[slot.side].post for p in spec.endpoints])
        meas = np.array(
            [p[slot.side].measure for p in spec.endpoints], dtype=np.float32
        )
        m4 = (
            meas[:, None, None] * CX[None]
            + (1.0 - meas[:, None, None]) * _I4[None]
        ).astype(COMPLEX)
        if fused:
            if slot.ancilla is not None:
                i2 = np.eye(2, dtype=COMPLEX)
                comp = np.stack([
                    np.kron(posts[i], i2) @ m4[i] @ np.kron(pres[i], i2)
                    for i in range(len(pres))
                ])
            else:
                comp = np.stack([
                    posts[i] @ pres[i] for i in range(len(pres))
                ])
            out.append((_stack_blocks(comp),))
            continue
        out.append(
            (_stack_blocks(pres), _stack_blocks(m4), _stack_blocks(posts))
        )
    return out


def label_strides(
    specs, touching,
) -> tuple[dict[int, int], dict[int, int], int]:
    """(strides, n_inst, flat_count) for a fragment's touching vgates:
    last-vgate-fastest label order (reference qvm/virtual_circuit.py:
    133-137).

    The single implementation of the label->variant-index stride
    convention in this package (the streamed scan and the kernel's
    label blocks call it); the convention must never fork across
    engines."""
    n_inst = {g: specs[g].num_instantiations for g in touching}
    strides: dict[int, int] = {}
    flat_count = 1
    for g in reversed(list(touching)):
        strides[g] = flat_count
        flat_count *= n_inst[g]
    return strides, n_inst, flat_count


def variant_index_table(
    order, strides: dict[int, int], n_inst: dict[int, int],
    padded: int, clamp_to: int | None = None,
    labels: np.ndarray | None = None,
) -> np.ndarray:
    """[padded, max(1, len(order))] int32 per-label variant indices:
    column i holds ``(label // strides[order[i]]) % n_inst[order[i]]``.

    The ONE place that pins the label->variant-index convention
    (last-vgate-fastest strides, reference order qvm/virtual_circuit.py:
    133-137) for every engine that gathers slot tables on device.  ``clamp_to``
    clamps padding labels to the last real one (equivalent to repeating
    the final variant row).  ``labels``: explicit label ids instead of
    ``arange(padded)`` — the truncated-label path (rows beyond its
    length repeat the last id; masked by the caller's validity).  Host
    arithmetic runs in int64, the stored column is a small int32."""
    if labels is None:
        labels = np.arange(padded)
    else:
        labels = np.asarray(labels, dtype=np.int64)
        if len(labels) < padded:
            pad_val = labels[-1] if len(labels) else 0
            labels = np.concatenate(
                [labels, np.full(padded - len(labels), pad_val)]
            )
    if clamp_to is not None:
        labels = np.minimum(labels, clamp_to - 1)
    order = list(order)
    out = np.zeros((padded, max(1, len(order))), np.int32)
    for i, g in enumerate(order):
        out[:, i] = labels // strides[g] % n_inst[g]
    return out


def label_weight_bounds(specs, gstride: dict, n_inst: dict,
                        total: int) -> np.ndarray:
    """[total] certified per-label contribution bounds: the L1 change of
    the knitted distribution from dropping label ``l`` is at most
    ``prod_g max_b |coef_g[v_g(l), b]|`` — each fragment's conditional
    rows carry unit mass, so the per-vgate fold is bounded by its
    largest-|coefficient| outcome.  The stratified sampler ranks labels
    by it (ops/qpd_sampling.stratified_split)."""
    w = np.ones(total, dtype=np.float64)
    lab = np.arange(total, dtype=np.int64)
    for g, spec in enumerate(specs):
        wg = np.max(np.abs(np.asarray(spec.coef, np.float64)), axis=1)
        w *= wg[(lab // gstride[g]) % n_inst[g]]
    return w


def collapse_stream(virt, frag_name: str):
    """Host side of collapse mode for one fragment: ``(prefix_ops,
    suffix_steps, active, positions, sources)``.

    Every ``slot_meas`` (the CX onto the slot's deferral ancilla) becomes
    ``("collapse", slot_id, (qubit,))``: the vgate measurement collapses
    in the simulation instead, so no ancilla ever appears in an op and
    the state stays at the qubits that do (``active``, ascending; the
    state width is ``len(active)``).  Fixed-gate runs between the
    structural ops fuse to 1q/2q blocks.  The stream splits at the first
    structural op: ``prefix_ops`` are ``("u", complex mat, axes)`` shared
    by every label; ``suffix_steps`` mix those with ``("slot_pre" |
    "slot_post" | "collapse", slot_id, axes)``.  Axes are fragment
    qubits.  ``positions`` are the DATA clbits the fragment writes,
    ascending (the vgate clbits are contracted at the collapse sites),
    ``sources`` their qubits; a source outside ``active`` saw no op and
    reads as a deterministic 0."""
    from .fusion import fused_stream

    prog = virt.programs[frag_name]
    source_ops = [
        ("collapse", op[1], (op[2][0],)) if op[0] == "slot_meas" else op
        for op in prog.ops
    ]
    skeleton, mats = fused_stream(source_ops, max_qubits=2)
    ops = []
    bi = 0
    for op in skeleton:
        if op[0] == "u":
            ops.append(("u", np.asarray(mats[bi], complex), op[1]))
            bi += 1
        else:
            ops.append(op)
    active = sorted({q for op in ops for q in op[2]})
    clbit_sources = {
        c: q for c, q in prog.clbit_sources.items() if c < virt.num_clbits
    }
    positions = sorted(clbit_sources)
    sources = [clbit_sources[c] for c in positions]
    first = next((i for i, op in enumerate(ops) if op[0] != "u"), len(ops))
    return ops[:first], ops[first:], active, positions, sources


def _fuse_slot_ops(prog_ops: list) -> list:
    """Rewrite each slot's contiguous (slot_pre[, slot_meas], slot_post)
    triple into ONE ("slot", sid, axes) op — matched by the composed
    per-slot table of ``_slot_tables(fused=True)``.  axes = (qubit,
    ancilla) when the slot measures, else (qubit,)."""
    out = []
    i = 0
    while i < len(prog_ops):
        op = prog_ops[i]
        if op[0] != "slot_pre":
            out.append(op)
            i += 1
            continue
        sid = op[1]
        axes = op[2]
        j = i + 1
        if (
            j < len(prog_ops)
            and prog_ops[j][0] == "slot_meas"
            and prog_ops[j][1] == sid
        ):
            axes = prog_ops[j][2]
            j += 1
        assert (
            j < len(prog_ops)
            and prog_ops[j][0] == "slot_post"
            and prog_ops[j][1] == sid
        ), f"non-contiguous slot {sid} ops"
        out.append(("slot", sid, axes))
        i = j + 1
    return out
