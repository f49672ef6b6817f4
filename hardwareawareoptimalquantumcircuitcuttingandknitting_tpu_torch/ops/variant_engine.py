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
fused (ops/fusion.py).  Exact, in float32 or (``dtype=
torch.bfloat16``, the serving mode) bf16 states with float32 rows; or,
with ``noise`` (a NoiseModel, ops/noise.py), the unfused op stream
(routed onto the model's coupling map) with trajectory noise sites as
plan steps, each row applying its own gathered Kraus block; or, with
``collapse=True`` (the sampled engine's rows without a kernel), every
vgate measurement collapsed in the simulation (:func:`collapse_qubit`)
at a per-row uniform draw, the rows weighted by the sampled fold
coefficients.

The shared-prefix planners of the streamed scan (:func:`split_plan`,
:func:`suffix_stages`, :func:`ideal_stage_align`, :func:`make_prefix_fn`)
and the certified truncation (:func:`truncate_labels`) are host logic
over that plan, as in the JAX package.

The host helpers (``_slot_tables``, ``label_strides``,
``variant_index_table``, ``label_weight_bounds``, ``truncate_labels``,
``_fuse_slot_ops``, :func:`collapse_stream`) are numpy, as in the JAX
package.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np
import torch

from ..circuit.gates import COMPLEX, CX
from ..convert import resolve_device, to_device
from ..utils.profiling import span
from ..virt.tables import VGateSpec
from ..virt.virtual_circuit import FragmentProgram, VirtualCircuit
from .statevector import (
    apply_block_einsum,
    apply_matrix_host,
    apply_slices,
    marginalize_flat,
    to_real_block,
)

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


def truncate_labels(specs, gstride: dict, n_inst: dict, total: int,
                    eps: float) -> tuple[np.ndarray, float]:
    """(kept label ids ascending, certified dropped L1 mass): drop the
    smallest-bound labels while their cumulative bound stays <= eps.
    At least one label is always kept (the JAX package's certified
    truncation, arXiv:2212.01270 role)."""
    w = label_weight_bounds(specs, gstride, n_inst, total)
    order = np.argsort(w, kind="stable")
    csum = np.cumsum(w[order])
    n_drop = int(np.searchsorted(csum, eps, side="right"))
    n_drop = min(n_drop, total - 1)
    kept = np.sort(order[n_drop:])
    dropped = float(csum[n_drop - 1]) if n_drop else 0.0
    return kept, dropped


def _collapse_ops(virt, prog):
    """Collapse mode's source ops and written clbits for one fragment:
    every ``slot_meas`` (the CX onto the slot's deferral ancilla) becomes
    ``("collapse", slot_id, (qubit,))``, so no ancilla appears in an op,
    and only the DATA clbits stay (the vgate clbits are contracted at the
    collapse sites).  Returns ``(ops, clbit_sources)``."""
    ops = [
        ("collapse", op[1], (op[2][0],)) if op[0] == "slot_meas" else op
        for op in prog.ops
    ]
    clbit_sources = {
        c: q for c, q in prog.clbit_sources.items() if c < virt.num_clbits
    }
    return ops, clbit_sources


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

    source_ops, clbit_sources = _collapse_ops(virt, virt.programs[frag_name])
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


def _round_block(blk: np.ndarray, dtype) -> np.ndarray:
    """A host block rounded to the state's ``dtype`` (kept as float32
    numbers): a bf16 state meets bf16 gate constants, the JAX package's
    rule that constants follow the state's dtype."""
    return torch.as_tensor(blk).to(dtype).to(torch.float32).numpy()


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


def _apply_block(state, blk, axes, m, mask=None):
    """One plan step's block on ``state [V, 2, 2^m]``: a slice
    combination up to 3 qubits, one einsum above (the JAX package's
    ``apply_matrix`` routes: fused blocks of 4-5 qubits would cost 4^k
    slice multiply-adds), and one einsum for a per-row block without a
    known nonzero pattern (the noise path's unfused slot blocks and
    sampled sites: a slice combination would multiply every entry, each
    a pass).  A bf16 state is combined in float32 with its bf16
    constants and stored back once: one rounding a pass, as a fused pass
    would round, not one per multiply-add."""
    dtype = state.dtype
    if dtype != torch.float32:
        return _apply_block(state.to(torch.float32), blk if isinstance(
            blk, torch.Tensor) else _round_block(blk, dtype), axes, m,
            mask).to(dtype)
    if len(axes) > 3 or (isinstance(blk, torch.Tensor) and mask is None):
        return apply_block_einsum(state, blk, axes, m)
    ur, ui = _block_coefs(blk, mask)
    return apply_slices(state, ur, ui, axes, m)


def collapse_qubit(state, q: int, m: int, u, mflag, w0, w1, picks=None):
    """Mid-circuit measure-and-collapse of qubit ``q`` on flat real-rep
    states ``[V, 2, 2^m]``, one measurement a row: ``u``, ``mflag``,
    ``w0``, ``w1`` are ``[V]`` float32 (uniform draw, measure flag, fold
    weights of the row's variant).  The branch is picked at its Born
    probability (``u * tot >= p0``, the probabilities summed in float32
    as the JAX package sums them), the kept branch projected and
    rescaled by ``sqrt(tot / p_b)``, and the row's weight is ``w0 + b (w1
    - w0)``, so ``E[w_b |psi_b|^2] = sum_b w_b |P_b psi|^2`` exactly.  A
    row with ``mflag == 0`` passes through with weight 1.  A bf16 state
    is projected in float32 (its scale rounded to bf16, the constant
    following the state's dtype) and stored back once.  Returns
    ``(states, weight [V])``; ``picks``, a list, gets ``(b, u * tot -
    p0, tot, mflag)`` of this site appended (:func:`picked_bits`)."""
    v = state.shape[0]
    st = state.to(torch.float32).reshape(v, 2, 1 << q, 2, 1 << (m - 1 - q))
    sq = st * st
    p0 = sq[:, :, :, 0, :].sum(dim=(1, 2, 3))
    p1 = sq[:, :, :, 1, :].sum(dim=(1, 2, 3))
    tot = p0 + p1
    d = u * tot - p0
    b = (d >= 0).to(torch.float32)  # u * tot >= p0, exactly
    pb = p0 + b * (p1 - p0)
    scale = torch.sqrt(tot / torch.clamp(pb, min=1e-30)).to(
        state.dtype).to(torch.float32)
    on = mflag > 0
    keep = torch.stack([1.0 - b, b], dim=1) * scale[:, None]
    fac = torch.where(on[:, None], keep, torch.ones_like(keep))
    out = (st * fac[:, None, None, :, None]).reshape(v, 2, 1 << m)
    weight = torch.where(on, w0 + b * (w1 - w0), torch.ones_like(w0))
    if picks is not None:
        picks.append((b, d, tot, mflag))
    return out.to(state.dtype), weight


def picked_bits(picks):
    """``(bits [V, n_sites] int32, margins [V, n_sites] float32)`` from
    the ``picks`` of :func:`collapse_qubit`, in site order: the picked
    branch, -1 where the row does not measure there, and the distance
    ``|u * tot - p0| / tot`` of the pick from its threshold
    (``ops/collapse_kernel.plain_collapse_rows``' layout, for
    ``compare_picks``)."""
    bits = torch.stack([
        torch.where(mf > 0, b.to(torch.int32), torch.full_like(
            b, -1, dtype=torch.int32)) for b, _, _, mf in picks], dim=1)
    margins = torch.stack([
        d.abs() / torch.clamp(tot, min=1e-30) for _, d, tot, _ in picks],
        dim=1)
    return bits, margins


def exec_plan_steps(state, m, steps, slot_mats, slot_masks=None,
                    pauli_mats=None, collapse_args=None, picks=None):
    """Run a slice of a fragment's lazy execution plan (the step list
    built by :func:`make_sim_fn`) on flat real-rep states ``[V, 2, 2^m]``,
    one per variant, in the states' dtype.  ``slot_mats`` maps slot id ->
    (pre, m4, post) real blocks ``[V, 2, k, 2, k]`` (a 1-tuple of
    composed blocks for a fused ``"slot"`` step; a list or a dict keyed
    by slot id).  ``slot_masks`` (slot id -> union nonzero pattern of the
    slot's fused table) lets a fused slot block skip its structurally
    zero entries.  ``pauli_mats`` maps noise-site id -> the sampled
    branch block of every row ``[V, 2, k, 2, k]`` (one contraction a
    site; k = 2 for a lone site, the gate's width where the site's bank
    carries its gate, see :func:`make_sim_fn`); without it the noise
    steps are skipped.  Returns ``(state, m)`` — or ``(state, m,
    weight [V])`` when ``collapse_args`` is given (slot id -> (u, mflag,
    w0, w1) per-row scalars for the plan's ``"collapse"`` steps, see
    :func:`collapse_qubit`; ``picks`` collects their picks)."""
    v = state.shape[0]
    weight = None
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
        if kind == "collapse":
            state, w_step = collapse_qubit(state, stp[2][0], m,
                                           *collapse_args[stp[1]],
                                           picks=picks)
            weight = w_step if weight is None else weight * w_step
            continue
        mask = None
        if kind == "pauli":
            if pauli_mats is not None:
                blk = pauli_mats[stp[1]]
            elif len(stp) > 3:
                blk = stp[3]  # noise-free: the gate the site carries
            else:
                continue
        elif kind == "u":
            blk = stp[1]
        elif kind == "slot":
            blk = slot_mats[stp[1]][0]
            mask = None if slot_masks is None else slot_masks.get(stp[1])
        elif kind in ("slot_pre", "slot_meas", "slot_post"):
            pre, m4, post = slot_mats[stp[1]]
            blk = (pre if kind == "slot_pre"
                   else m4 if kind == "slot_meas" else post)
        else:
            raise ValueError(f"unknown plan step {kind!r}")
        state = _apply_block(state, blk, stp[2], m, mask)
    if collapse_args is None:
        return state, m
    if weight is None:
        weight = torch.ones(v, dtype=torch.float32, device=state.device)
    return state, m, weight


def finish_row(state, m, active_final, sources):
    """``|psi|^2`` + marginalisation onto the written clbits, for states
    ``[V, 2, 2^m]``.  Marginalises over the ACTIVE qubits; a source qubit
    that never saw an op is deterministically |0>: its bit is spliced in
    as a zero-bit after the reduction.  Squares in float32 whatever the
    state's dtype (a bf16 serving state's rows are f32)."""
    s32 = state.to(torch.float32)
    p = (s32 * s32).sum(dim=1)
    act_sources = [q for q in sources if q in active_final]
    rows = marginalize_flat(
        p, m, [active_final.index(q) for q in act_sources]
    )
    return splice_zero_bits(rows, [q in active_final for q in sources])


# ---------------------------------------------------------------------------
# Shared-prefix splits and staged suffixes (the streamed scan's planners)
# ---------------------------------------------------------------------------

def _steps_hbm_bytes(steps, m: int) -> tuple[int, int]:
    """Minimal device-memory bytes to execute ``steps`` from width ``m``
    (the JAX package's counting rules: an "ins" reads 2^m and writes
    2^(m+1) complex64, a gate reads and writes the state once).  Returns
    (bytes, m)."""
    b = 0
    for stp in steps:
        if stp[0] == "ins":
            b += (1 << m) * 8 + (1 << (m + 1)) * 8
            m += 1
        elif stp[0] == "pauli":
            continue
        else:
            b += 2 * (1 << m) * 8
    return b, m


@dataclass
class SplitPlan:
    """A shared-prefix split of one fragment's per-variant plan.

    Labels whose variant indices agree on the ``shared`` vgates run the
    plan's prefix identically, so the prefix runs once per *ancestor*
    (one combination of the shared vgates' variants, ``n_anc`` in all)
    into a bank of ``[n_anc, 2, 2^m_split]`` states, and the per-label
    scan gathers its ancestor state and runs only the suffix.
    """

    shared: list            # vgate indices (fragment slot-stream order)
    astrides: dict          # vgate -> ancestor-index stride (last fastest)
    n_anc: int
    split_idx: int          # plan step index where the suffix starts
    m_split: int            # state width at the split
    prefix_steps: list
    suffix_steps: list
    bank_bytes: int         # n_anc * 2^(m_split+1) * state_bytes
    est_bytes: int          # modelled bytes with this split
    est_flat_bytes: int     # modelled bytes without sharing
    build_bytes: int = 0    # one-time bank-build bytes (prefix + write)


def split_plan(sim_fn, prog, specs, global_labels: int,
               bank_budget_bytes: int = 512 << 20,
               hoisted: bool = False,
               state_bytes: int = 4) -> SplitPlan | None:
    """The best shared-prefix split of one fragment (least modelled
    bytes, subject to the ancestor bank fitting ``bank_budget_bytes``),
    or None when no split beats the flat plan (no slot, or a first slot
    at step 0).  The JAX package's planner, decision for decision.

    ``hoisted=True`` scores candidates for the serving shape (banks built
    once through ``meta["bank_fn"]`` and passed to every ``step_fn(xs,
    banks)``): the one-time build bytes are left out, so deeper splits
    win.  ``state_bytes``: 4 for f32 states, 2 for bf16 (a bf16 bank
    holds twice the ancestors a byte)."""
    plan = sim_fn.run_plan
    slot_vg = [s.vgate_idx for s in prog.slots]
    if any(stp[0] == "pauli" for stp in plan):
        return None  # trajectory noise: states diverge per label
    # candidate splits: before each newly-seen vgate's first slot step
    # (stepping back over the segment's preceding "ins" widenings), plus
    # the all-shared split at the end of the plan
    cands: list[tuple[int, int, list]] = []  # (split_idx, m_split, shared)
    seen: list[int] = []
    m = sim_fn.prefix_width
    for i, stp in enumerate(plan):
        if stp[0].startswith("slot"):
            g = slot_vg[stp[1]]
            if g not in seen:
                j, mm = i, m
                while j > 0 and plan[j - 1][0] == "ins":
                    j -= 1
                    mm -= 1
                cands.append((j, mm, list(seen)))
                seen.append(g)
        if stp[0] == "ins":
            m += 1
    cands.append((len(plan), m, list(seen)))

    finish_bytes = (1 << m) * 8 + (1 << max(0, m - 1)) * 4 + 2 * (1 << m) * 4
    best = None
    flat_est = None
    for split_idx, m_split, shared in cands:
        n_anc = 1
        for g in shared:
            n_anc *= specs[g].num_instantiations
        bank_bytes = n_anc * (1 << (m_split + 1)) * state_bytes
        pre_b, _ = _steps_hbm_bytes(plan[:split_idx], sim_fn.prefix_width)
        suf_b, _ = _steps_hbm_bytes(plan[split_idx:], m_split)
        build = pre_b * n_anc + bank_bytes             # build + write bank
        step = (
            (suf_b + finish_bytes) * global_labels     # per-label suffix
            + (0 if not shared else
               global_labels * (1 << (m_split + 1)) * 4)  # ancestor gather
        )
        est = step if hoisted else build + step
        if not shared:
            flat_est = est
        if shared and bank_bytes > bank_budget_bytes:
            continue
        if best is None or est < best[0]:
            best = (
                est, split_idx, m_split, shared, n_anc, bank_bytes, build,
            )
    if best is None or not best[3]:
        return None
    est, split_idx, m_split, shared, n_anc, bank_bytes, build = best
    if flat_est is not None and est >= flat_est:
        return None
    astrides: dict[int, int] = {}
    stride = 1
    for g in reversed(shared):
        astrides[g] = stride
        stride *= specs[g].num_instantiations
    return SplitPlan(
        shared=shared,
        astrides=astrides,
        n_anc=n_anc,
        split_idx=split_idx,
        m_split=m_split,
        prefix_steps=plan[:split_idx],
        suffix_steps=plan[split_idx:],
        bank_bytes=int(bank_bytes),
        est_bytes=int(est),
        est_flat_bytes=int(flat_est) if flat_est is not None else int(est),
        build_bytes=int(build),
    )


@dataclass
class SuffixStage:
    """One group-deduplicated segment of a SplitPlan's suffix: ``steps``
    run once per group of ``r_out`` consecutive labels (the states
    entering the next stage are repeated from group representatives);
    ``sids`` are the slot ids whose blocks this stage gathers, at the
    representative rows ``vidx[::r_out]``."""

    steps: list
    m_in: int
    r_out: int
    sids: list


def suffix_stages(sp: SplitPlan, prog, specs, gstride: dict,
                  chunk: int) -> tuple[list, int]:
    """Partition ``sp.suffix_steps`` into in-chunk deduplicated stages
    (the JAX package's rule).  The global label order is mixed-radix
    (last vgate fastest), so within an aligned block of R labels vgate
    column g is constant iff ``R | gstride[g]``.  Each suffix vgate opens
    a stage, run once per group of ``r_out`` labels (the largest
    trailing-product group that divides ``chunk`` and every dependency's
    stride) and repeated to the next stage's finer groups.  An unaligned
    ``chunk`` (or -1, a truncated label set) drives every ``r_out`` to 1:
    the per-label suffix.

    Returns ``(stages, r_anc)``: ``r_anc`` is the ancestor-gather group
    size (bank rows are fetched once per r_anc labels)."""
    slot_vg = [s.vgate_idx for s in prog.slots]
    bounds: list[tuple[int, int, int]] = []  # (step_idx, m_in, vgate)
    seen = list(sp.shared)
    m = sp.m_split
    for i, stp in enumerate(sp.suffix_steps):
        if stp[0].startswith("slot") and slot_vg[stp[1]] not in seen:
            j, mm = i, m
            while j > 0 and sp.suffix_steps[j - 1][0] == "ins":
                j -= 1
                mm -= 1
            bounds.append((j, mm, slot_vg[stp[1]]))
            seen.append(slot_vg[stp[1]])
        if stp[0] == "ins":
            m += 1
    if not bounds or bounds[0][0] != 0:
        # no suffix slot introduces a new vgate (all-shared split, or a
        # shared vgate's second endpoint in the suffix): one per-label
        # stage gathering whatever slots the suffix carries
        sids = sorted({
            stp[1] for stp in sp.suffix_steps if stp[0].startswith("slot")
        })
        return (
            [SuffixStage(list(sp.suffix_steps), sp.m_split, 1, sids)], 1,
        )

    suffix_vgs = [g for (_, _, g) in bounds]
    # natural group-size ladder: r_t = prod insts of vgates introduced
    # after stage t (trailing block of the mixed radix)
    ladder = [1]
    for g in reversed(suffix_vgs[1:]):
        ladder.append(ladder[-1] * specs[g].num_instantiations)
    ladder.reverse()
    r_first = ladder[0] * specs[suffix_vgs[0]].num_instantiations

    def _valid(r: int, deps) -> bool:
        return (
            r >= 1 and chunk % r == 0
            and all(gstride[g] % r == 0 for g in deps)
        )

    stages: list[SuffixStage] = []
    deps = list(sp.shared)
    # fine-to-coarse, so every stage's groups refine the previous one's
    r_eff = [1] * len(bounds)
    for t in range(len(bounds) - 1, -1, -1):
        d = deps + suffix_vgs[: t + 1]
        nat = ladder[t]
        r_eff[t] = nat if _valid(nat, d) else (
            r_eff[t + 1] if t + 1 < len(bounds) else 1
        )
    for t, (j, mm, _g) in enumerate(bounds):
        j_next = bounds[t + 1][0] if t + 1 < len(bounds) else len(
            sp.suffix_steps
        )
        seg = list(sp.suffix_steps[j:j_next])
        sids = sorted({
            stp[1] for stp in seg if stp[0].startswith("slot")
        })
        stages.append(SuffixStage(seg, mm, r_eff[t], sids))
    r_anc = r_first if _valid(r_first, sp.shared) else r_eff[0]
    return stages, r_anc


def ideal_stage_align(sp: SplitPlan, prog, specs, gstride: dict) -> int:
    """The chunk multiple at which :func:`suffix_stages` engages fully
    for this fragment (the stride-valid coarsest group size, ignoring
    chunk divisibility): ``meta["stage_align"]`` of the streamed scan.
    Chunks are not rounded to it; a caller passes an aligned chunk."""
    # chunk=0 sentinel: 0 % r == 0 for every r, so only strides bind
    stages, r_anc = suffix_stages(sp, prog, specs, gstride, 0)
    return max([r_anc] + [st.r_out for st in stages])


def make_prefix_fn(sim_fn, sp: SplitPlan):
    """``prefix_fn(slot_mats)`` for a :class:`SplitPlan` and a closure
    from :func:`make_sim_fn`: the ancestor states ``[V, 2, 2^m_split]``
    in the closure's dtype (the JAX package's ``make_split_fns`` prefix;
    the scan runs the suffix as staged steps).  ``slot_mats``: slot id ->
    tuple of ``[V, ...]`` blocks on one device (a dict)."""
    m0 = sim_fn.prefix_width
    dtype = sim_fn.dtype

    def prefix_fn(slot_mats):
        first = next(iter(slot_mats.values()))[0]
        v, dev = first.shape[0], first.device
        state = to_device(sim_fn.prefix_state, dev, dtype).expand(
            v, 2, 1 << m0)
        state, m = exec_plan_steps(state, m0, sp.prefix_steps, slot_mats,
                                   slot_masks=sim_fn.slot_masks)
        assert m == sp.m_split
        return state

    return prefix_fn


def _gate_bank(bank: np.ndarray, u: np.ndarray) -> np.ndarray:
    """A 1-qubit site's real bank ``[B, 2, 2, 2, 2]`` times a k-qubit gate
    ``u`` whose first qubit (the MSB of its index) the site sits on: the
    real blocks of ``kron(K_b, I) @ u``, ``[B, 2, 2^k, 2, 2^k]`` — branch
    b applied right after the gate in one pass."""
    u = np.asarray(u, np.complex128)
    eye = np.eye(u.shape[0] // 2)
    return np.stack([
        to_real_block(np.kron(blk[0, :, 0, :] + 1j * blk[1, :, 0, :], eye)
                      @ u)
        for blk in np.asarray(bank, np.float64)
    ])


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
    without slots, on its second argument ``device`` (None = "cuda";
    slot matrices bring their own device).  ``slot_mats`` is the
    list of per-slot stacked numpy blocks over all ``flat_count`` variants
    — or ``None`` with ``build_matrices=False``.

    ``sim_fn.run_plan`` (the per-variant steps after the shared host
    prefix), ``prefix_width``, ``prefix_state``, ``active_final``,
    ``sources``, ``slot_masks``, ``dtype``, ``noise_sites`` and
    ``readout_device`` are the JAX closure's attributes.

    ``dtype``: the states' storage dtype (default float32).
    ``torch.bfloat16`` is the serving mode: the prefix state, every pass
    and the slot blocks are bf16, host gate constants are rounded to it,
    and :func:`finish_row` squares in float32, so rows are float32.

    ``noise`` (a NoiseModel): the fragment's unfused op stream (no fused
    slots, no fused gate runs), routed onto ``noise.coupling`` when the
    model has one (``sim_fn.readout_device``: clbit -> device node
    holding it), with the physical-gate noise sites
    (ops/noise.fragment_noise_sites; ``sim_fn.noise_sites``;
    ``sim_fn.routed``: the ``circuit.routing.RoutedProgram``, None
    without a coupling map or noise) as
    ``("pauli", site, axes)`` steps at their op's width.
    ``sim_fn(slot_mats, device, pauli_mats)`` then takes ``pauli_mats``:
    site id -> the sampled branch block of every row ``[V, 2, k, 2, k]``,
    for the sites in ``sim_fn.active_sites`` (a site whose identity
    branch has probability 1 draws the identity and is left out of the
    plan), gathered from ``sim_fn.site_banks[site]``: the site's own
    bank, or for the first site of a gate on the gate's first qubit the
    bank times the gate (``kron(K_b, I) @ U``: the gate and its site are
    one pass, ``("pauli", site, gate axes, gate block)``).  A fragment
    without slots takes ``V`` from those blocks.  Float32 only.

    ``collapse=True`` (sampled measurement, exact path only: the sampled
    engine's rows without a kernel): every ``slot_meas`` becomes a
    ``("collapse", slot id, axes)`` step (:func:`collapse_qubit`), so no
    deferral ancilla enters the state; slots are not fused, and
    ``positions`` are the DATA clbits only.  ``sim_fn(slot_mats,
    collapse_args, device=None, picks=None)`` then takes
    ``collapse_args``: slot id -> ``(u, mflag, w0, w1)``, ``[V]`` float32
    each, and returns the rows times the rows' sampled fold weights;
    ``sim_fn.collapse_slots`` lists the collapse sites' slot ids in plan
    order (the order of the draws' columns), and ``picks`` (a list)
    collects each site's pick (:func:`picked_bits`)."""
    dtype = torch.float32 if dtype is None else dtype
    if noise is not None and dtype != torch.float32:
        raise ValueError("bf16 serving mode is exact-path only")
    if collapse:
        if noise is not None:
            raise ValueError("collapse mode is exact-path only")
        fused_slots = False  # slot_meas must stay a distinct step
    from .fusion import fused_stream

    prog = virt.programs[frag_name]
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, flat_count = label_strides(specs, prog.touching)
    clbit_sources = prog.clbit_sources
    # the noise path keeps the unfused per-step stream (slot_post noise
    # sites attach to individual endpoint ops)
    fused_slots = fused_slots and noise is None
    phys = None
    readout_device = None
    routed = None

    if noise is None:
        # fuse contiguous fixed-gate runs between slots into blocks of up
        # to ``fuse_qubits`` qubits
        source_ops = _fuse_slot_ops(prog.ops) if fused_slots else prog.ops
        if collapse:
            # measure in place: the ancilla then never appears in an op,
            # so the lazy introduction below never allocates its bit
            source_ops, clbit_sources = _collapse_ops(virt, prog)
        skeleton, mats = fused_stream(source_ops, max_qubits=fuse_qubits)
        prog_ops = []
        bi = 0
        for op in skeleton:
            if op[0] == "u":
                prog_ops.append(("u", mats[bi], op[1]))
                bi += 1
            else:
                prog_ops.append(op)
    elif noise.coupling is not None:
        from ..circuit.routing import route_stream

        with span("port.route"):
            routed = route_stream(prog.ops, prog.num_data_qubits,
                                  prog.clbit_sources, noise.coupling)
        prog_ops = routed.ops
        phys = routed.phys
        clbit_sources = routed.clbit_sources
        # device node holding each written clbit's value, for calibrated
        # readout lookup (the uncut simulator's rule)
        readout_device = {
            c: (routed.slot_device[s] if s < len(routed.slot_device)
                else None)
            for c, s in clbit_sources.items()
        }
    else:
        prog_ops = prog.ops

    positions = sorted(clbit_sources)
    sources = [clbit_sources[c] for c in positions]
    noise_sites = []
    if noise is not None:
        from .noise import _site_active, fragment_noise_sites

        noise_sites = fragment_noise_sites(noise, prog_ops, phys)
    # the bank each site's plan step gathers from (a site that opens its
    # gate's step carries the gate, below); inactive sites always draw the
    # identity and stay out of the plan
    site_banks = {s_i: site[3] for s_i, site in enumerate(noise_sites)}
    sites_after: dict[int, list[int]] = {}
    for s_i, (op_i, _q, probs, _b, _w) in enumerate(noise_sites):
        if _site_active(probs):
            sites_after.setdefault(op_i, []).append(s_i)

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
        after = sites_after.get(op_i, [])
        if kind == "u" and after and noise_sites[after[0]][1] == axes[0]:
            # the gate and its first site as one per-row block: the
            # site's bank times the gate, on the gate's qubits
            # ("pauli", site, axes, gate block for a noise-free call)
            s_i, after = after[0], after[1:]
            site_banks[s_i] = _gate_bank(noise_sites[s_i][3], op[1])
            plan.append(("pauli", s_i, tr, to_real_block(op[1])))
        elif kind in ("u", "u_aux"):
            plan.append(("u", to_real_block(op[1]), tr))
        else:
            plan.append((kind, op[1], tr))  # payload = slot id
        for s_i in after:
            plan.append(("pauli", s_i, (active.index(noise_sites[s_i][1]),)))
    active_final = list(active)

    # Prefix sharing: every plan step before the first variant-dependent
    # step (slot blocks, sampled noise sites) is identical across the
    # whole fan-out: run it ONCE on the host; each variant starts from
    # the resulting constant state.
    first_var = next(
        (i for i, stp in enumerate(plan) if stp[0] not in ("ins", "u")),
        len(plan),
    )
    with span("port.build.prefix"):
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

    def start(slot_mats, device, pauli_mats=None):
        # the blocks' device and row count; without any, ``device`` (None
        # = "cuda") and one row
        first = (slot_mats[0][0] if slot_mats
                 else next(iter(pauli_mats.values())) if pauli_mats
                 else None)
        if first is not None:
            v, dev = first.shape[0], first.device
        else:
            v, dev = 1, resolve_device(device)
        state = to_device(prefix_state, dev, dtype).expand(v, 2, 1 << m0)
        return state, [tuple(t.to(dtype) for t in tabs)
                       for tabs in slot_mats]

    if collapse:
        def sim_fn(slot_mats, collapse_args, device=None, picks=None):
            state, mats = start(slot_mats, device)
            state, m, w = exec_plan_steps(state, m0, run_plan, mats,
                                          collapse_args=collapse_args,
                                          picks=picks)
            return finish_row(state, m, active_final, sources) * w[:, None]

        sim_fn.collapse_slots = [stp[1] for stp in run_plan
                                 if stp[0] == "collapse"]
    else:
        def sim_fn(slot_mats, device=None, pauli_mats=None):
            state, mats = start(slot_mats, device, pauli_mats)
            state, m = exec_plan_steps(state, m0, run_plan, mats,
                                       slot_masks=slot_masks,
                                       pauli_mats=pauli_mats)
            return finish_row(state, m, active_final, sources)

    sim_fn.dtype = dtype
    sim_fn.noise_sites = noise_sites
    sim_fn.site_banks = site_banks
    sim_fn.active_sites = sorted({stp[1] for stp in run_plan
                                  if stp[0] == "pauli"})
    sim_fn.readout_device = readout_device
    sim_fn.routed = routed
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


def scan_variant_rows(sim_fn, all_mats, total: int, chunk: int, device,
                      sites=None):
    """``sim_fn`` over every variant row, ``chunk`` variants at a time:
    ``all_mats`` (per slot a tuple of numpy blocks with leading dim
    ``total``) is moved to ``device`` chunk by chunk, the rows ``[total,
    width]`` stay there.  A plain loop: each step is device work of one
    chunk, and nothing is fetched in between.  ``sites``: a noisy
    closure's ``[total]`` branch index of every row, per noise site; each
    chunk gathers its rows' blocks from ``sim_fn.site_banks`` on the
    device."""
    dev = torch.device(device)
    if sites is not None:
        banks = {s: to_device(sim_fn.site_banks[s], dev)
                 for s in sim_fn.active_sites}
        idx_dev = {s: to_device(sites[s], dev, torch.int64)
                   for s in sim_fn.active_sites}
    out = None
    for c0 in range(0, total, chunk):
        mats = [tuple(to_device(t[c0:c0 + chunk], dev) for t in tabs)
                for tabs in all_mats]
        pauli = None if sites is None else {
            s: banks[s][idx_dev[s][c0:c0 + chunk]] for s in banks}
        rows = sim_fn(mats, dev, pauli)
        if out is None:
            out = torch.empty((total, rows.shape[1]), dtype=torch.float32,
                              device=dev)
        out[c0:c0 + chunk] = rows
    return out


def gather_variant_rows(sim_fn, tables, slot_cols, vidx: torch.Tensor,
                        chunk: int) -> torch.Tensor:
    """``sim_fn`` over the variant rows of ``vidx`` (``[total,
    n_touching]`` variant indices on the device), ``chunk`` rows at a
    time: each chunk gathers its slot blocks on the device from the
    per-instantiation ``tables`` (per slot a tuple of tensors with the
    instantiation axis first), slot ``s`` by column ``slot_cols[s]``.
    The sharded engines' counterpart of :func:`scan_variant_rows`, whose
    blocks come per row from the host.  Rows ``[total, width]`` f32."""
    out = None
    for c0 in range(0, vidx.shape[0], chunk):
        v = vidx[c0:c0 + chunk].long()
        rows = sim_fn([tuple(t[v[:, c]] for t in tabs)
                       for c, tabs in zip(slot_cols, tables)])
        if out is None:
            out = torch.empty((vidx.shape[0], rows.shape[1]),
                              dtype=torch.float32, device=rows.device)
        out[c0:c0 + v.shape[0]] = rows
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
