"""Segmented blocked kernel: fragments of 21..24 simulated qubits.

Counterpart of the JAX package's ``ops/pallas_blocked.py`` (the Pallas
kernel built by ``_segment_call``, driven by ``make_blocked_chunk_kernel``).
Past the variant kernel's width gate the per-label state lives in device
memory as planar ``[labels, 2, 2^n]`` and the fused chain runs in
SEGMENTS:

* :func:`plan_segments` groups consecutive ops whose qubits fit a
  ``w``-bit window.  With ``pinned=c`` every window also holds the ``c``
  lowest storage bits, free of charge, so every tile is read in runs of
  ``2^c`` consecutive amplitudes (``pinned=0`` is the JAX planner);
  :func:`build_plan` leaves identities out first, so they take no slot;
* the state keeps ONE storage layout, the canonical one (qubit ``q`` on
  flat bit ``n-1-q``), from the prefix to the last segment.  Segment
  ``k``'s tiles are the sets of amplitudes that differ only in its
  window's bits: a tile is gathered from its addresses, worked on and
  stored back to them, so no re-tile pass runs between segments;
* one kernel launch applies one segment to every tile of every label of
  a chunk (``csrc/blocked_kernel.cu``), its gates the segment's rows
  rewritten by ``ops/op_rewrite`` (identities dropped, diagonal runs
  merged, signed permutations as moves) over tile-local bits; the
  leading and trailing signed permutations fold into the gather and
  scatter addresses (:func:`fold_moves`), and the last segment writes
  ``|psi|^2`` rows in place of the state;
* the shared prefix runs through the same kernel, one state from
  ``|0...0>``, when the device plan is built, and the device plan is
  cached on the ``VirtualCircuit`` (:func:`device_plan`).

Layers, as in ``variant_kernel.py``: the host build (:func:`build_plan`),
the wrappers (:func:`apply_segment` for one segment, :func:`segment_rows`
for the last, :func:`blocked_rows` for a chunk's ``|psi|^2`` rows,
:func:`prefix_state` for the prefix) that launch the CUDA kernel on CUDA
tensors and count the launches, and the plain PyTorch versions
(:func:`plain_segment`, :func:`plain_segment_rows`,
:func:`plain_blocked_rows`, :func:`plain_prefix_state`: the same
segments, gathered and scattered tiles and rewritten rows) that run on
the CPU and are the kernel's reference on the card.

The window is bounded by shared memory (``8 * 2^w`` bytes a tile), so the
gate is ``2 <= w <= 14``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import resolve_device, to_device
from ..virt.virtual_circuit import VirtualCircuit
from . import op_rewrite
from .kernel_build import KernelLibrary, check_tensor
from .statevector import marginalize_flat
from .variant_kernel import (
    MAX_QUBITS,
    OpTable,
    SlotEntries,
    _plan_ops,
    generic_ops,
    op_costs,
)

MAX_WINDOW = 14          # 8 * 2^14 B = 128 KB of a CTA's 227 KB
DEFAULT_WINDOW = 13      # 64 KB a tile: two CTAs an SM (fastest measured)
DEFAULT_PINNED = 3       # 8 amplitudes, one 32-byte sector, a run
MAX_BLOCKED_QUBITS = 24  # 2^24 * 8 B per label stays practical
DEP_BITS = 7             # a copy table: two halves of 2^7 entries
DEP_SIZE = 2 << DEP_BITS
_CACHE = "_blocked_plan_cache"


def plan_segments(ops, n: int, w: int, pinned: int = 0):
    """Greedy lookahead segmentation of a full-width op stream.

    ``ops``: [("u", mat, qubit_axes) | ("slot", sid, qubit_axes)].
    Returns ``segments = [(perm, seg_ops)]`` where ``perm`` maps qubit
    -> tile layout bit for that segment (every seg op's qubits map < w:
    bits below ``w`` index within a tile, the rest number the tiles) and
    ``seg_ops`` keep QUBIT axes (the executor translates).

    ``pinned=0`` is the JAX planner (``ops/pallas_blocked.plan_segments``):
    the first segment's perm is also the required input layout.  With
    ``pinned=c`` every window holds the qubits on the ``c`` lowest storage
    bits (qubits ``n-1`` .. ``n-c``), which cost no window slot; a window
    the segment's qubits do not fill takes the lowest storage bits left;
    layout bits follow storage bits in ascending order, so tile bits
    ``0..c-1`` are storage bits ``0..c-1``.
    """
    assert w < n
    segments = []
    i = 0
    cur_perm = None
    fixed = [n - 1 - b for b in range(pinned)]
    while i < len(ops):
        # lookahead: largest op prefix whose qubit union fits the window
        qubits: list[int] = list(fixed)
        j = i
        while j < len(ops):
            extra = [q for q in ops[j][2] if q not in qubits]
            if len(qubits) + len(extra) > w:
                break
            qubits.extend(extra)
            j += 1
        assert j > i, f"op {ops[i]} touches more than w={w} qubits"
        if pinned:
            segments.append((_storage_order(qubits, n, w), ops[i:j]))
            i = j
            continue
        # build the segment's perm: scheduled qubits -> low bits (keep
        # positions stable from the previous perm where already low)
        perm = {}
        used = set()
        if cur_perm is not None:
            for q in qubits:
                if cur_perm[q] < w:
                    perm[q] = cur_perm[q]
                    used.add(cur_perm[q])
        free = [b for b in range(n) if b not in used]
        fi = 0
        for q in qubits:
            if q not in perm:
                while free[fi] >= w:
                    fi += 1
                perm[q] = free[fi]
                used.add(free[fi])
                fi += 1
        rest = [b for b in range(n) if b not in used]
        ri = 0
        for q in range(n):
            if q not in perm:
                perm[q] = rest[ri]
                ri += 1
        segments.append((perm, ops[i:j]))
        cur_perm = perm
        i = j
    return segments


def _storage_order(qubits, n: int, w: int) -> dict:
    """A pinned segment's perm: the window (the storage bits of
    ``qubits``, filled up to ``w`` with the lowest bits left) on layout
    bits ``0..w-1``, then the other bits, each part in ascending storage
    order."""
    win = {n - 1 - q for q in qubits}
    win |= set([b for b in range(n) if b not in win][:w - len(win)])
    order = sorted(win) + [b for b in range(n) if b not in win]
    return {n - 1 - b: j for j, b in enumerate(order)}


def tile_offsets(perm: dict, n: int, w: int) -> tuple[np.ndarray, int]:
    """``(offsets, free_mask)`` of a segment layout: tile-local index ``i``
    sits at flat offset ``offsets[i]`` (``[2^w]`` int64) from its tile's
    base; the tile numbered ``t`` has its base at ``t``'s bits deposited
    into ``free_mask``'s bits in ascending order."""
    sbit = {j: n - 1 - q for q, j in perm.items()}
    i = np.arange(1 << w)
    off = np.zeros_like(i)
    for j in range(w):
        off |= ((i >> j) & 1) << sbit[j]
    free = sum(1 << sbit[j] for j in range(w, n))
    return off, int(free)


def xor_table(off: np.ndarray) -> np.ndarray:
    """The kernel's two-halves table of an affine offset map ``off``
    (``[2^w]``, ``w <= 14``): ``off[i] == table[i & 127] ^ table[128 +
    (i >> 7)]``, int32."""
    half = 1 << DEP_BITS
    tab = np.zeros(DEP_SIZE, np.int64)
    tab[:min(half, len(off))] = off[:half]
    hi = np.arange(len(off) >> DEP_BITS) << DEP_BITS
    tab[half:half + len(hi)] = off[hi] ^ off[0]
    i = np.arange(len(off))
    assert np.array_equal(tab[i & (half - 1)] ^ tab[half + (i >> DEP_BITS)],
                          off), "offset map is not affine"
    return tab.astype(np.int32)


def tile_index(table: np.ndarray, free_mask: int, n: int, w: int,
               device=None) -> torch.Tensor:
    """``[2^(n-w), 2^w]`` int64 flat index of every tile's amplitudes from
    a :func:`xor_table`, in the order the kernel numbers tiles and
    tile-local indices, built on ``device``."""
    tab = torch.as_tensor(table, dtype=torch.int64, device=device)
    i = torch.arange(1 << w, device=device)
    half = 1 << DEP_BITS
    local = tab[i & (half - 1)] ^ tab[half + (i >> DEP_BITS)]
    t = torch.arange(1 << (n - w), device=device)
    base = torch.zeros_like(t)
    free_bits = [b for b in range(n) if (free_mask >> b) & 1]
    for k, b in enumerate(free_bits):
        base |= ((t >> k) & 1) << b
    return base[:, None] | local[None, :]


def _monomial(row, x: np.ndarray):
    """``(to, phase)`` of a signed-permutation row (x, cx, swap, y, ...):
    the amplitude at each tile-local index of ``x`` moves to ``to``,
    multiplied by ``i ** phase``; None for any other row."""
    kind, ja, jb, code = (int(v) for v in row[:4])
    if kind not in (op_rewrite.OP_PERM1, op_rewrite.OP_PERM2):
        return None
    m = 2 if kind == op_rewrite.OP_PERM1 else 4
    to = np.zeros(m, np.int64)  # member src[r] becomes member r
    ph = np.zeros(m, np.int64)  # with phase i ** ph[src[r]]
    for r in range(m):
        src = (code >> (4 * r)) & 3
        to[src], ph[src] = r, (code >> (4 * r + 2)) & 3
    if m == 2:
        old = (x >> ja) & 1
        return (x & ~(1 << ja)) | (to[old] << ja), ph[old]
    old = 2 * ((x >> ja) & 1) + ((x >> jb) & 1)
    new = to[old]
    return ((x & ~((1 << ja) | (1 << jb))) | ((new >> 1) << ja)
            | ((new & 1) << jb)), ph[old]


def _compose(rows, x: np.ndarray):
    """``(to, phase)`` of a run of signed-permutation rows, in order."""
    phase = np.zeros_like(x)
    for row in rows:
        x, ph = _monomial(row, x)
        phase = (phase + ph) & 3
    return x, phase


def fold_moves(rows, w: int, whole_vectors: bool):
    """Fold a segment's leading and trailing runs of signed-permutation
    rows into its copies: the tile is gathered through the leading runs'
    inverse, and stored through the trailing runs' map, so those rows
    cost no pass (their phases are applied to each thread's copies as
    they land, and in the store).  Returns ``(first, last, gather,
    scatter)``:
    ``rows[first:last]`` stay; ``gather = (index, phase)``: tile-local
    index ``i`` loads the amplitude at ``index[i]`` and multiplies it by
    ``i ** phase[i]``; ``scatter = (index, phase)``: ``i`` is multiplied
    by ``i ** phase[i]`` and stored at ``index[i]``.  ``whole_vectors``:
    the copies move 4 floats, so every aligned group of 4 must load from
    one aligned group in order (the gather maps a group onto a group,
    bits 0 and 1 kept) and store within one group (the scatter keeps
    bits 0, 1 up to a flip of the group's own)."""
    x = np.arange(1 << w)
    last = len(rows)
    while last and _monomial(rows[last - 1], x) is not None:
        last -= 1
    for last in range(last, len(rows) + 1):
        scatter = _compose(rows[last:], x)
        if not whole_vectors or np.array_equal(
                scatter[0] ^ scatter[0][x & ~3], x & 3):
            break
    first = 0
    while first < last and _monomial(rows[first], x) is not None:
        first += 1
    for first in range(first, -1, -1):
        to, phase = _compose(rows[:first], x)
        index = np.empty_like(x)
        index[to] = x
        if not whole_vectors or np.array_equal(
                index, (index[x & ~3] & ~3) | (x & 3)):
            break
    return first, last, (index, phase[index]), scatter


@dataclass
class BlockedPlan:
    """Host build of one fragment's segmented run.

    Segments are numbered prefix first: ``n_prefix`` segments of the
    shared prefix (fixed gates, run once from ``|0...0>``), then one per
    entry of ``segments``, the suffix.  ``perms`` / ``prefix_perms`` map
    qubit -> tile layout bit for each.  ``ops``, ``fixed`` and the entry
    tables are the suffix's :class:`~.variant_kernel.OpTable` over
    tile-local bits (all below ``w``), ``segments[k]`` suffix segment
    ``k``'s row range in it (the work counts' yardstick).  ``table`` is
    what the kernel interprets: every segment's rows rewritten by
    ``ops/op_rewrite`` (one rewrite a segment) less the moves
    :func:`fold_moves` folds into its copies (``folded[g]``: leading,
    trailing), and ``row_segments[g]`` segment ``g``'s ``(row start, row
    end, pool start, pool end)``; a row's pool offsets count from its
    segment's pool start.  ``tables[g]`` are segment ``g``'s gather and
    scatter :func:`xor_table` (tile-local index -> offset from the
    tile's base), ``phases[g]`` the gather's and scatter's phases (powers
    of ``i`` a tile-local index; ``phased[g]``: which are not all 0) and
    ``free_masks[g]`` its tile numbering."""

    n: int
    w: int
    pinned: int
    perms: list                # per suffix segment {qubit: layout bit}
    prefix_perms: list         # per prefix segment
    ops: np.ndarray            # [n_ops, 4] int32, the suffix
    fixed: np.ndarray          # float32 coefficient pool of ops
    segments: list             # [(start, end)] suffix op ranges
    table: op_rewrite.Table    # the kernel's rows, every segment
    row_segments: list         # [(r0, r1, p0, p1)] prefix, then suffix
    folded: list               # [(leading, trailing)] rows folded
    tables: np.ndarray         # [segments, 2, DEP_SIZE] int32
    phases: np.ndarray         # [segments, 2, 2^w] uint8
    phased: list               # [(gather, scatter)] bool
    free_masks: list           # per segment
    entry_tables: list         # per slot [nI, 2*m*m] float32
    entry_gids: list           # per slot: global vgate id
    entry_stride: int          # floats per label entry row

    @property
    def n_prefix(self) -> int:
        return len(self.prefix_perms)


def _add_segments(table: OpTable, segs) -> list:
    """Append each segment's ops over its layout bits; their row ranges."""
    ranges = []
    for perm, seg_ops in segs:
        start = len(table.ops)
        for op in seg_ops:
            table.add(op, [perm[q] for q in op[2]])
        ranges.append((start, len(table.ops)))
    return ranges


def build_plan(virt: VirtualCircuit, frag_name: str,
               window: int = DEFAULT_WINDOW,
               pinned: int = DEFAULT_PINNED) -> BlockedPlan:
    """Segment one fragment's prefix and fused suffix, identities left
    out, at ``w = min(window, n - 1)`` bits with ``min(pinned, w - 2)``
    pinned bits (a 2q gate off them needs two slots) and build the
    tables: original and rewritten rows (moves folded), copy tables."""
    prefix_ops, suffix, prog = _plan_ops(virt, frag_name)
    # an identity does nothing (the rewrite drops its row): it takes no
    # window slot either
    prefix_ops, suffix = (
        [op for op in ops if op[0] != "u"
         or op_rewrite.classify(op[1]) != "identity"]
        for ops in (prefix_ops, suffix))
    specs = [vg.spec for vg in virt.vgates]
    n = prog.num_sim_qubits
    w = min(window, n - 1)
    c = max(0, min(pinned, w - 2))
    pre = plan_segments(prefix_ops, n, w, c)
    segs = plan_segments(suffix, n, w, c)

    pre_table = OpTable(prog, specs)
    pre_ranges = _add_segments(pre_table, pre)
    table = OpTable(prog, specs)
    ranges = _add_segments(table, segs)
    ops, fixed = table.ops_array(), table.fixed_array()

    rows, pool, row_segments, folded = [], [], [], []
    tables, phases, free = [], [], []
    perms = [perm for perm, _ in pre + segs]
    rewritten = [
        op_rewrite.rewrite(generic_ops(src.ops_array()[a:b],
                                       src.fixed_array()))
        for src, rngs in ((pre_table, pre_ranges), (table, ranges))
        for a, b in rngs]
    for perm, t in zip(perms, rewritten):
        first, last, gather, scatter = fold_moves(t.rows, w, c >= 2)
        r0, p0 = sum(len(r) for r in rows), sum(len(p) for p in pool)
        rows.append(t.rows[first:last])
        pool.append(t.pool)
        row_segments.append((r0, r0 + last - first, p0, p0 + len(t.pool)))
        folded.append((first, len(t.rows) - last))
        off, mask = tile_offsets(perm, n, w)
        tables.append([xor_table(off[gather[0]]), xor_table(off[scatter[0]])])
        phases.append([gather[1], scatter[1]])
        free.append(mask)
    return BlockedPlan(
        n=n, w=w, pinned=c, perms=[p for p, _ in segs],
        prefix_perms=[p for p, _ in pre], ops=ops, fixed=fixed,
        segments=ranges,
        table=op_rewrite.Table(
            np.concatenate(rows or [np.zeros((0, op_rewrite.ROW))])
            .astype(np.int32).reshape(-1, op_rewrite.ROW),
            np.concatenate(pool or [np.zeros(0)]).astype(np.float32)),
        row_segments=row_segments, folded=folded,
        tables=np.asarray(tables, np.int32).reshape(-1, 2, DEP_SIZE),
        phases=np.asarray(phases, np.uint8).reshape(-1, 2, 1 << w),
        phased=[(bool(a.any()), bool(b.any())) for a, b in phases],
        free_masks=free,
        entry_tables=table.entry_tables, entry_gids=table.entry_gids,
        entry_stride=table.entry_stride,
    )


class BlockedDevicePlan:
    """A :class:`BlockedPlan` with its tables on one device and the
    prefix state built there (``prefix``, ``[2, 2^n]``): by the kernel
    on a card, by the plain version on the CPU."""

    def __init__(self, plan: BlockedPlan, device):
        self.plan = plan
        self.device = torch.device(device)
        self.rows = to_device(
            plan.table.rows if len(plan.table.rows)
            else np.zeros((1, op_rewrite.ROW), np.int32), device)
        self.pool = to_device(
            plan.table.pool if plan.table.pool.size
            else np.zeros(1, np.float32), device)
        self.tables = to_device(
            plan.tables if len(plan.tables)
            else np.zeros((1, 2, DEP_SIZE), np.int32), device)
        self.phases = torch.as_tensor(plan.phases, device=self.device)
        self._entries = SlotEntries(plan.entry_tables, plan.entry_gids,
                                    device)
        self.prefix = (prefix_state(self) if self.device.type == "cuda"
                       else plain_prefix_state(self))

    def gather_entries(self, vidx_chunk: torch.Tensor) -> torch.Tensor:
        """``[C, entry_stride]`` per-label slot entries for a ``[C,
        num_vgates]`` block of variant indices (global vgate columns)."""
        return self._entries(vidx_chunk)

    def tile_index(self, g: int, side: int) -> torch.Tensor:
        """Segment ``g``'s :func:`tile_index` on the plan's device, built
        anew each call (``2^n`` int64s, held no longer than the caller
        needs them): where the kernel gathers (``side`` 0) or scatters
        (1) each amplitude of each tile."""
        p = self.plan
        return tile_index(p.tables[g, side], p.free_masks[g], p.n, p.w,
                          self.device)


def device_plan(virt: VirtualCircuit, frag_name: str, window: int,
                pinned: int, device) -> BlockedDevicePlan:
    """The fragment's :class:`BlockedDevicePlan`, built once per
    ``(fragment, window, pinned bits, device)`` and kept on the
    ``VirtualCircuit``, so a later call on the same circuit builds
    nothing (the plan and the prefix state depend on nothing else)."""
    n = virt.programs[frag_name].num_sim_qubits
    w = min(window, n - 1)
    key = (frag_name, w, max(0, min(pinned, w - 2)), str(device))
    cache = virt.__dict__.setdefault(_CACHE, {})
    if key not in cache:
        cache[key] = BlockedDevicePlan(
            build_plan(virt, frag_name, window, pinned), device)
    return cache[key]


def drop_device_plans(virt: VirtualCircuit) -> None:
    """Forget every :func:`device_plan` kept on ``virt`` (the next call
    builds them anew, prefix launches included)."""
    virt.__dict__.pop(_CACHE, None)


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def _plain_tiles(dp: BlockedDevicePlan, g: int, state, entries):
    """Segment ``g`` as the kernel runs it: every tile of every label
    gathered into ``[C * tiles, 2, 2^w]``, the segment's rewritten rows
    applied, the tiles scattered into a new ``[C, 2, 2^n]`` tensor (the
    folded moves are in the gather and scatter addresses).  ``state`` is
    ``[C, 2, 2^n]`` or one ``[2, 2^n]`` state every label starts from."""
    plan = dp.plan
    c, big, width = entries.shape[0], 1 << plan.n, 1 << plan.w
    if state.dim() == 2:
        state = state.expand(c, 2, big)
    idx = dp.tile_index(g, 0)
    tiles = idx.shape[0]
    st = state[:, :, idx].permute(0, 2, 1, 3).reshape(c * tiles, 2, width)
    if plan.phased[g][0]:
        st = _rotate(st, dp.phases[g, 0])
    ent = entries.repeat_interleave(tiles, dim=0)
    r0, r1, p0, p1 = plan.row_segments[g]
    pool = plan.table.pool[p0:p1]
    for row in plan.table.rows[r0:r1]:
        st = op_rewrite.apply_row(st, row, plan.w, pool, ent)
    if plan.phased[g][1]:
        st = _rotate(st, dp.phases[g, 1])
    out = torch.empty((c, 2, big), dtype=st.dtype, device=st.device)
    out[:, :, dp.tile_index(g, 1)] = \
        st.reshape(c, tiles, 2, width).permute(0, 2, 1, 3)
    return out


def _rotate(st, phase):
    """``st [B, 2, 2^w]`` times ``i ** phase`` (``[2^w]`` uint8), exactly:
    a power of ``i`` moves and negates the planes."""
    re, im = st[:, 0], st[:, 1]
    ph = phase.long()
    out_re = torch.where(ph == 0, re, torch.where(
        ph == 1, -im, torch.where(ph == 2, -re, im)))
    out_im = torch.where(ph == 0, im, torch.where(
        ph == 1, re, torch.where(ph == 2, -im, -re)))
    return torch.stack([out_re, out_im], dim=1)


def _no_entries(device) -> torch.Tensor:
    return torch.zeros((1, 1), dtype=torch.float32, device=device)


def _zero_state(n: int, device) -> torch.Tensor:
    st = torch.zeros((1, 2, 1 << n), dtype=torch.float32, device=device)
    st[0, 0, 0] = 1.0
    return st


def plain_prefix_state(dp: BlockedDevicePlan) -> torch.Tensor:
    """The plain version of :func:`prefix_state`: ``|0...0>`` through the
    prefix segments, ``[2, 2^n]``."""
    st = _zero_state(dp.plan.n, dp.device)
    for g in range(dp.plan.n_prefix):
        st = _plain_tiles(dp, g, st, _no_entries(dp.device))
    return st[0]


def plain_segment(dp: BlockedDevicePlan, k: int, state, entries):
    """Suffix segment ``k`` on ``state`` (``[C, 2, 2^n]``, or the shared
    ``[2, 2^n]`` prefix) over gathered tiles; returns a new ``[C, 2,
    2^n]`` tensor."""
    return _plain_tiles(dp, dp.plan.n_prefix + k, state, entries)


def plain_segment_rows(dp: BlockedDevicePlan, k: int, state, entries):
    """The plain version of :func:`segment_rows`: suffix segment ``k``,
    then ``|psi|^2`` rows ``[C, 2^n]``."""
    state = plain_segment(dp, k, state, entries)
    return (state * state).sum(dim=1)


def _run_segments(dp: BlockedDevicePlan, entries, segment_fn, rows_fn):
    """Prefix -> every suffix segment with ``segment_fn``, all in the one
    storage layout, the last with ``rows_fn`` -> ``|psi|^2`` rows ``[C,
    2^n]``."""
    plan = dp.plan
    last = len(plan.segments) - 1
    if last < 0:  # no segment: every label is the prefix state
        rows = (dp.prefix * dp.prefix).sum(dim=0)
        return rows.expand(entries.shape[0], 1 << plan.n)
    state = dp.prefix
    for k in range(last):
        state = segment_fn(dp, k, state, entries)
    return rows_fn(dp, last, state, entries)


def plain_blocked_rows(dp: BlockedDevicePlan, entries) -> torch.Tensor:
    """The plain PyTorch version of :func:`blocked_rows`, on any device:
    the same segments, tiles and rewritten rows."""
    return _run_segments(dp, entries, plain_segment, plain_segment_rows)


# ---------------------------------------------------------------------------
# The CUDA kernel: bind, launch
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blocked_segment_launch.argtypes = (
        [p, p, p, ctypes.c_longlong, p, p, p, p, p, p] + [i] * 8 + [p]
    )
    lib.blocked_segment_launch.restype = i
    lib.blocked_kernel_max_window.restype = i


# csrc/blocked_kernel.cu, built for sm_90a at first launch
LIBRARY = KernelLibrary("blocked_kernel", _bind,
                        "blocked_kernel_error_string")


def _launch(dp: BlockedDevicePlan, g: int, src, dst, stride: int, entries,
            labels: int, entry_stride: int, probs=None) -> None:
    """Segment ``g`` from ``src`` into ``dst`` (or, with ``probs``, its
    ``|psi|^2`` rows into ``probs``)."""
    lib = LIBRARY.load()
    plan = dp.plan
    dev = dst.device
    for name in ("rows", "pool", "tables", "phases"):
        if getattr(dp, name).device != dev:
            raise ValueError(f"plan table {name} is not on {dev}")
    if not 2 <= plan.w <= lib.blocked_kernel_max_window():
        raise ValueError(f"window {plan.w} is outside the kernel's "
                         f"2..{lib.blocked_kernel_max_window()}")
    r0, r1, p0, _ = plan.row_segments[g]
    rc = lib.blocked_segment_launch(
        src.data_ptr(), dst.data_ptr(),
        None if probs is None else probs.data_ptr(), stride,
        dp.rows.data_ptr(),
        dp.pool.data_ptr() + 4 * p0, entries.data_ptr(),
        dp.tables.data_ptr() + 4 * 2 * DEP_SIZE * g,
        *(dp.phases[g, side].data_ptr() if plan.phased[g][side] else None
          for side in (0, 1)),
        r0, r1, entry_stride,
        plan.n, plan.w, plan.free_masks[g],
        # 16-byte copies where tile bits 0, 1 are storage bits 0, 1
        4 if plan.pinned >= 2 else 1, labels,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "blocked kernel launch failed: " + LIBRARY.error_text(rc)
        )
    blocked_rows.launches += 1


def prefix_state(dp: BlockedDevicePlan) -> torch.Tensor:
    """The shared prefix state ``[2, 2^n]`` on the plan's card:
    ``|0...0>`` through the prefix segments, one launch each (counted in
    ``blocked_rows.launches``), in place."""
    st = _zero_state(dp.plan.n, dp.device)
    ent = _no_entries(dp.device)
    for g in range(dp.plan.n_prefix):
        _launch(dp, g, st, st, 2 << dp.plan.n, ent, 1, 0)
    return st[0]


def _launch_segment(dp: BlockedDevicePlan, k: int, state, entries,
                    rows: bool = False):
    plan = dp.plan
    dev = entries.device
    c = entries.shape[0]
    big = 1 << plan.n
    check_tensor(entries, "entries", torch.float32,
                 (c, max(1, plan.entry_stride)), dev)
    if state.dim() == 2:  # the shared prefix: read with label stride 0
        check_tensor(state, "prefix", torch.float32, (2, big), dev)
        src, stride = state, 0
        dst = None
    else:                 # in place
        check_tensor(state, "state", torch.float32, (c, 2, big), dev)
        src = dst = state
        stride = 2 * big
    probs = None
    if rows:
        dst = probs = torch.empty((c, big), dtype=torch.float32, device=dev)
    elif dst is None:
        dst = torch.empty((c, 2, big), dtype=torch.float32, device=dev)
    _launch(dp, plan.n_prefix + k, src, dst, stride, entries, c,
            plan.entry_stride, probs)
    return dst


def apply_segment(dp: BlockedDevicePlan, k: int, state,
                  entries) -> torch.Tensor:
    """Suffix segment ``k`` of the plan on a chunk's states.  ``state`` is
    the shared ``[2, 2^n]`` prefix (a new ``[C, 2, 2^n]`` tensor is
    returned) or contiguous ``[C, 2, 2^n]`` states.  CUDA tensors launch
    the hand-written kernel, which updates per-label states IN PLACE
    (counted in ``blocked_rows.launches``); CPU tensors run
    :func:`plain_segment`.  ``entries [C, entry_stride]`` from
    :meth:`BlockedDevicePlan.gather_entries`."""
    if entries.is_cuda:
        return _launch_segment(dp, k, state, entries)
    if entries.device.type != "cpu":
        raise ValueError(f"unsupported device {entries.device}")
    return plain_segment(dp, k, state, entries)


def segment_rows(dp: BlockedDevicePlan, k: int, state,
                 entries) -> torch.Tensor:
    """Suffix segment ``k`` on a chunk's states, as :func:`apply_segment`
    takes them, writing ``|psi|^2`` rows ``[C, 2^n]`` (a new tensor) in
    place of the states: the last segment's epilogue.  CUDA tensors
    launch the kernel (counted), CPU tensors run
    :func:`plain_segment_rows`."""
    if entries.is_cuda:
        return _launch_segment(dp, k, state, entries, rows=True)
    if entries.device.type != "cpu":
        raise ValueError(f"unsupported device {entries.device}")
    return plain_segment_rows(dp, k, state, entries)


def blocked_rows(dp: BlockedDevicePlan, entries) -> torch.Tensor:
    """``|psi|^2`` rows ``[C, 2^n]`` of a chunk of labels in the canonical
    layout: one :func:`apply_segment` per segment, nothing between them,
    the last one :func:`segment_rows`."""
    return _run_segments(dp, entries, apply_segment, segment_rows)


blocked_rows.launches = 0


# ---------------------------------------------------------------------------
# Streamed-engine integration point (the JAX make_blocked_chunk_kernel)
# ---------------------------------------------------------------------------

def make_blocked_chunk_kernel(
    virt: VirtualCircuit, frag_name: str, chunk: int,
    window: int = DEFAULT_WINDOW, force: bool = False, device=None,
    pinned: int = DEFAULT_PINNED,
):
    """``(rows_fn, positions)`` with the contract of
    ``variant_kernel.make_chunk_kernel``: ``rows_fn(vidx_chunk)`` maps a
    ``[chunk, num_vgates]`` label block to ``[chunk, 2^len(positions)]``
    rows marginalised onto the written clbits, through the segmented
    blocked kernel.  Returns None when the fragment is outside the
    n = 21..24 gate (``force=True`` lifts the lower bound, for small
    tests) or the window ``min(window, n - 1)`` is outside 2..14.
    ``rows_fn.plan`` is the :class:`BlockedDevicePlan` (cached,
    :func:`device_plan`)."""
    dev = resolve_device(device)
    prog = virt.programs[frag_name]
    n = prog.num_sim_qubits
    if n > MAX_BLOCKED_QUBITS or (not force and n <= MAX_QUBITS):
        return None
    if not 2 <= min(window, n - 1) <= MAX_WINDOW:
        return None
    dp = device_plan(virt, frag_name, window, pinned, dev)
    positions = sorted(prog.clbit_sources)
    # one storage layout throughout: qubit q is marginalize_flat's axis q
    axes = [prog.clbit_sources[c] for c in positions]
    memo: dict = {}  # the marginal's bit-order index, built once a scan

    def rows_fn(vidx_chunk):
        rows = blocked_rows(dp, dp.gather_entries(vidx_chunk))
        return marginalize_flat(rows, dp.plan.n, axes, memo)

    rows_fn.plan = dp
    return rows_fn, positions


# ---------------------------------------------------------------------------
# Work counts for the roofline bound (bytes and f32 operations)
# ---------------------------------------------------------------------------

def work_counts(plan: BlockedPlan, k: int, labels: int,
                entries=None) -> dict:
    """Work of suffix segment ``k`` on ``labels`` states.  ``bytes``: each
    input read once and each output written once (the states, or the
    shared prefix once for the first segment, and the states out, or the
    last segment's ``|psi|^2`` rows; the segment's rewritten rows, its
    pool, copy tables and phases, the entry rows it uses).
    ``flops``: f32 operations, each gate what its matrix needs
    (``variant_kernel.op_costs``: a slot gate from each label's row of
    ``entries [labels, entry_stride]``, dense without it)."""
    big = 1 << plan.n
    start, end = plan.segments[k]
    rows = plan.ops[start:end]
    coefs = np.where(rows[:, 0] == 1, 8, 32)
    is_slot = rows[:, 3] < 0
    r0, r1, p0, p1 = plan.row_segments[plan.n_prefix + k]
    state_in = 2 * big * (1 if k == 0 else labels)
    state_out = labels * big * (1 if k == len(plan.segments) - 1 else 2)
    nbytes = 4 * (
        state_in + state_out + op_rewrite.ROW * (r1 - r0)
        + (p1 - p0) + 2 * DEP_SIZE + labels * int(coefs[is_slot].sum())
        + sum(plan.phased[plan.n_prefix + k]) * (1 << plan.w) // 4
    )
    cost = op_costs(rows, plan.fixed, plan.n, entries)
    flops = int(cost.sum()) * (labels if entries is None else 1)
    return {"bytes": int(nbytes), "flops": flops}
