"""Batched execution of all QPD variants of a fragment, and the host
helpers every engine shares.

Port of the JAX package's ``ops/variant_engine.py``.  The batched engine
(:func:`make_sim_fn`, :func:`run_fragment`, :func:`run_all_fragments`)
runs a fragment's static program for every variant at once: the state is
``[V, 2, 2^m]`` (a leading variant axis written out where the JAX package
``vmap``s), per-variant endpoint behaviour enters as per-variant gate
coefficients, and large fan-outs run in chunks capped by bytes.  The
per-variant program is the JAX package's lazy plan: qubits are introduced
at the start of the slot-delimited segment of their first op, the
variant-independent prefix runs once on the host, fixed-gate runs are
fused (ops/fusion.py).  Exact, noise-free, float32 only: ``noise``, a
``dtype`` other than float32 and ``collapse=True`` raise
``NotImplementedError`` naming their ROADMAP item.

The host helpers (``_slot_tables``, ``label_strides``,
``variant_index_table``, ``label_weight_bounds``, ``_fuse_slot_ops``,
:func:`collapse_stream`) are numpy, as in the JAX package.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np
import torch

from ..circuit.gates import COMPLEX, CX
from ..convert import resolve_device, to_device
from ..virt.tables import VGateSpec
from ..virt.virtual_circuit import FragmentProgram, VirtualCircuit
from .statevector import (
    apply_matrix_host,
    apply_slices,
    marginalize_flat,
    to_real_block,
)

_ITEM = "ROADMAP H100 port, queue A, 'other engines'"
# one chunk's [chunk, 2, 2^n] float32 states stay within this many bytes
_CHUNK_STATE_BYTES = 256 * 1024 * 1024

_I4 = np.eye(4, dtype=COMPLEX)


def chunk_cap(num_sim_qubits: int) -> int:
    """Per-chunk variant cap of the batched engine: one chunk's ``[chunk,
    2, 2^n]`` float32 states stay within 256 MiB, whatever the device (a
    gate application holds a few such buffers at once)."""
    return max(1, _CHUNK_STATE_BYTES // (8 << num_sim_qubits))


@dataclass
class FragmentResult:
    name: str
    values: torch.Tensor         # [num_variants, 2^k] float32, on a device
    bit_positions: list[int]     # global clbit per local bit (ascending)
    touching: list[int]          # global vgate indices (variant axes, last
                                 # fastest — reference label order)


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


def _slot_matrices(
    prog: FragmentProgram, specs: list[VGateSpec], flat_count: int,
    strides: dict[int, int], n_inst: dict[int, int], fused: bool = False,
) -> list[tuple[np.ndarray, ...]]:
    """Per-slot (pre[V,2,2], meas4[V,4,4], post[V,2,2]) real blocks
    gathered per flat variant index (1-tuples of composed blocks with
    ``fused=True``)."""
    out = []
    flat = np.arange(flat_count)
    tables = _slot_tables(prog, specs, fused=fused)
    for slot, tabs in zip(prog.slots, tables):
        v_idx = (flat // strides[slot.vgate_idx]) % n_inst[slot.vgate_idx]
        out.append(tuple(t[v_idx] for t in tabs))
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


# ---------------------------------------------------------------------------
# The batched engine: every variant of a fragment at once
# ---------------------------------------------------------------------------

def splice_zero_bits(rows: torch.Tensor, present) -> torch.Tensor:
    """Rows over the bits with ``present[j]`` true (little-endian, in
    order) widened to all ``len(present)`` bits: an absent bit is a
    deterministic 0, so its half of the row is zero (the JAX package's
    ``finish_row`` zero-bit rule)."""
    c = rows.shape[0]
    for j, ok in enumerate(present):
        if not ok:
            r = rows.reshape(c, -1, 1 << j)
            rows = torch.stack([r, torch.zeros_like(r)], dim=2).reshape(c, -1)
    return rows


def _block_coefs(blk, mask=None):
    """``(ur, ui)`` entry functions for :func:`apply_slices` from a real
    block: a host ``[2, m, 2, m]`` array (Python floats, zeros skipped) or
    a per-variant ``[V, 2, m, 2, m]`` tensor (``[V]`` coefficient vectors;
    entries outside ``mask``, the block's host-known nonzero pattern, are
    skipped as zeros)."""
    if isinstance(blk, np.ndarray):
        return (lambda r, c: float(blk[0, r, 0, c]),
                lambda r, c: float(blk[1, r, 0, c]))

    def entry(comp):
        def get(r, c):
            if mask is not None and not mask[comp, r, 0, c]:
                return 0.0
            return blk[:, comp, r, 0, c]
        return get

    return entry(0), entry(1)


def exec_plan_steps(state, m, steps, slot_mats, slot_masks=None):
    """Run a slice of a fragment's lazy execution plan (the step list
    built by :func:`make_sim_fn`) on flat real-rep states ``[V, 2, 2^m]``,
    one per variant.  ``slot_mats`` maps slot id -> (pre, m4, post) real
    blocks ``[V, 2, k, 2, k]`` (a 1-tuple of composed blocks for a fused
    ``"slot"`` step).  ``slot_masks`` (slot id -> union nonzero pattern of
    the slot's fused table) lets a fused slot block skip its structurally
    zero entries.  Returns ``(state, m)``."""
    v = state.shape[0]
    for stp in steps:
        kind = stp[0]
        if kind == "ins":
            pos = stp[1]
            r = state.reshape(v, 2, 1 << pos, 1 << (m - pos))
            state = torch.stack([r, torch.zeros_like(r)], dim=3).reshape(
                v, 2, 1 << (m + 1)
            )
            m += 1
            continue
        if kind == "u":
            ur, ui = _block_coefs(stp[1])
        elif kind == "slot":
            ur, ui = _block_coefs(
                slot_mats[stp[1]][0],
                None if slot_masks is None else slot_masks.get(stp[1]),
            )
        elif kind in ("slot_pre", "slot_meas", "slot_post"):
            pre, m4, post = slot_mats[stp[1]]
            ur, ui = _block_coefs(
                pre if kind == "slot_pre"
                else m4 if kind == "slot_meas" else post
            )
        else:
            raise NotImplementedError(
                f"plan step {kind!r} is not ported to the torch package "
                f"yet: {_ITEM}"
            )
        state = apply_slices(state, ur, ui, stp[2], m)
    return state, m


def finish_row(state, m, active_final, sources):
    """``|psi|^2`` + marginalisation onto the written clbits, for states
    ``[V, 2, 2^m]``.  Marginalises over the ACTIVE qubits; a source qubit
    that never saw an op is deterministically |0>: its bit is spliced in
    as a zero-bit after the reduction."""
    p = (state * state).sum(dim=1)
    act_sources = [q for q in sources if q in active_final]
    rows = marginalize_flat(
        p, m, [active_final.index(q) for q in act_sources]
    )
    return splice_zero_bits(rows, [q in active_final for q in sources])


def make_sim_fn(virt: VirtualCircuit, frag_name: str, noise=None,
                build_matrices: bool = True, fuse_qubits: int = 3,
                fused_slots: bool = False, dtype=None,
                collapse: bool = False):
    """Build the batched simulation closure for a fragment.

    ``fused_slots``: collapse each slot's (pre, meas, post) steps into
    ONE composed block step ("slot" kind, tables from
    ``_slot_tables(fused=True)``).  Callers that gather slot tables
    themselves must pass the same flag to :func:`_slot_tables`.

    Returns (sim_fn, slot_mats, positions, flat_count).  ``sim_fn`` maps
    the slot matrices of ``V`` variants (per slot a tuple of ``[V, ...]``
    tensors on one device) to their probability rows ``[V, 2^k]``; with an
    empty list it returns the single row ``[1, 2^k]`` of a fragment
    without slots, on its second argument ``device`` (default the CPU;
    slot matrices bring their own device).  ``slot_mats`` is the
    list of per-slot stacked numpy blocks over all ``flat_count`` variants
    — or ``None`` with ``build_matrices=False``.

    ``sim_fn.run_plan`` (the per-variant steps after the shared host
    prefix), ``prefix_width``, ``prefix_state``, ``active_final``,
    ``sources`` and ``slot_masks`` are the JAX closure's attributes.

    ``noise`` (trajectory noise), ``dtype`` other than float32 (the bf16
    serving mode) and ``collapse=True`` (sampled measurement: the sampled
    engine's collapse kernel serves it, ops/collapse_kernel.py) are not
    ported to this function and raise ``NotImplementedError``."""
    for what, on in (("noise=", noise is not None),
                     ("dtype= other than float32",
                      dtype is not None and dtype != torch.float32),
                     ("collapse=True", collapse)):
        if on:
            raise NotImplementedError(
                f"make_sim_fn({what}) is not ported to the torch package "
                f"yet: {_ITEM} (the batched engine is exact, noise-free, "
                "float32)"
            )
    from .fusion import fused_stream

    prog = virt.programs[frag_name]
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, flat_count = label_strides(specs, prog.touching)
    clbit_sources = prog.clbit_sources

    # fuse contiguous fixed-gate runs between slots into blocks of up to
    # ``fuse_qubits`` qubits
    source_ops = _fuse_slot_ops(prog.ops) if fused_slots else prog.ops
    skeleton, mats = fused_stream(source_ops, max_qubits=fuse_qubits)
    prog_ops = []
    bi = 0
    for op in skeleton:
        if op[0] == "u":
            prog_ops.append(("u", mats[bi], op[1]))
            bi += 1
        else:
            prog_ops.append(op)

    positions = sorted(clbit_sources)
    sources = [clbit_sources[c] for c in positions]

    # Lazy qubit introduction: a sim qubit's state bit exists only from
    # the start of the slot-delimited SEGMENT of its first op ("ins" grows
    # the state by a |0> bit at the qubit's sorted position).  Deferral
    # ancillas, allocated up front by FragmentProgram but untouched until
    # their slot's measure op, then cost nothing until mid-circuit.
    # Introductions are coalesced at segment boundaries; plan steps carry
    # axes TRANSLATED to positions within the active set at that point.
    op_seg = []
    seg = 0
    for op in prog_ops:
        if op[0] not in ("u", "u_aux"):
            seg += 1
        op_seg.append(seg)
    first_seg: dict[int, int] = {}
    for op, sgi in zip(prog_ops, op_seg):
        for q in op[2]:
            first_seg.setdefault(q, sgi)

    active: list[int] = []
    plan: list[tuple] = []
    cur_seg = -1
    for op_i, op in enumerate(prog_ops):
        if op_seg[op_i] > cur_seg:
            for s in range(cur_seg + 1, op_seg[op_i] + 1):
                for q in sorted(
                    q for q, fs in first_seg.items() if fs == s
                ):
                    pos = bisect.bisect_left(active, q)
                    plan.append(("ins", pos, None))
                    active.insert(pos, q)
            cur_seg = op_seg[op_i]
        kind, axes = op[0], op[2]
        tr = tuple(active.index(q) for q in axes)
        if kind in ("u", "u_aux"):
            plan.append(("u", to_real_block(op[1]), tr))
        else:
            plan.append((kind, op[1], tr))  # payload = slot id
    active_final = list(active)

    # Prefix sharing: every plan step before the first slot step is
    # identical across the whole fan-out: run it ONCE on the host; each
    # variant starts from the resulting constant state.
    first_var = next(
        (i for i, stp in enumerate(plan) if stp[0] not in ("ins", "u")),
        len(plan),
    )
    st = np.zeros((2, 1), np.float32)
    st[0, 0] = 1.0
    m0 = 0
    for stp in plan[:first_var]:
        if stp[0] == "ins":
            pos = stp[1]
            r = st.reshape(2, 1 << pos, 1 << (m0 - pos))
            st = np.stack(
                [r, np.zeros_like(r)], axis=2
            ).reshape(2, 1 << (m0 + 1))
            m0 += 1
        else:
            st = apply_matrix_host(st, stp[1], stp[2], m0)
    prefix_state, run_plan = st, plan[first_var:]

    # union nonzero pattern of each fused slot table: a host-known static
    # superset of every gathered block's support
    slot_masks = None
    if fused_slots and prog.slots:
        slot_masks = {
            sid: np.any(np.asarray(tabs[0]) != 0, axis=0)
            for sid, tabs in enumerate(_slot_tables(prog, specs, fused=True))
        }

    def sim_fn(slot_mats, device=None):
        # the slot blocks' device; without a slot, ``device`` (None = "cuda")
        if slot_mats:
            first = slot_mats[0][0]
            v, dev = first.shape[0], first.device
        else:
            v, dev = 1, resolve_device(device)
        state = to_device(prefix_state, dev).expand(v, 2, 1 << m0)
        state, m = exec_plan_steps(state, m0, run_plan, slot_mats,
                                   slot_masks=slot_masks)
        return finish_row(state, m, active_final, sources)

    sim_fn.slot_masks = slot_masks
    sim_fn.run_plan = run_plan
    sim_fn.prefix_width = m0
    sim_fn.prefix_state = prefix_state
    sim_fn.active_final = active_final
    sim_fn.sources = sources
    all_mats = (
        _slot_matrices(
            prog, specs, flat_count, strides, n_inst, fused=fused_slots
        )
        if build_matrices else None
    )
    return sim_fn, all_mats, positions, flat_count


def scan_variant_rows(sim_fn, all_mats, total: int, chunk: int, device):
    """``sim_fn`` over every variant row, ``chunk`` variants at a time:
    ``all_mats`` (per slot a tuple of numpy blocks with leading dim
    ``total``) is moved to ``device`` chunk by chunk, the rows ``[total,
    width]`` stay there.  A plain loop: each step is device work of one
    chunk, and nothing is fetched in between."""
    dev = torch.device(device)
    out = None
    for c0 in range(0, total, chunk):
        mats = [tuple(to_device(t[c0:c0 + chunk], dev) for t in tabs)
                for tabs in all_mats]
        rows = sim_fn(mats)
        if out is None:
            out = torch.empty((total, rows.shape[1]), dtype=torch.float32,
                              device=dev)
        out[c0:c0 + chunk] = rows
    return out


def run_fragment(
    virt: VirtualCircuit,
    frag_name: str,
    chunk_size: int = 1024,
    device=None,
) -> FragmentResult:
    """Exact probability rows for every variant of one fragment, as a
    tensor on ``device`` (None = "cuda")."""
    dev = resolve_device(device)
    prog = virt.programs[frag_name]
    sim_fn, all_mats, positions, flat_count = make_sim_fn(
        virt, frag_name, fused_slots=True
    )

    if not prog.slots:
        values = sim_fn([], dev).expand(flat_count, -1).contiguous()
        return FragmentResult(frag_name, values, positions,
                              list(prog.touching))

    chunk = min(chunk_size, flat_count, chunk_cap(prog.num_sim_qubits))
    values = scan_variant_rows(sim_fn, all_mats, flat_count, chunk, dev)
    return FragmentResult(frag_name, values, positions, list(prog.touching))


def run_all_fragments(
    virt: VirtualCircuit, chunk_size: int = 1024, device=None,
) -> list[FragmentResult]:
    return [
        run_fragment(virt, reg.name, chunk_size, device)
        for reg in virt.fragments
    ]
