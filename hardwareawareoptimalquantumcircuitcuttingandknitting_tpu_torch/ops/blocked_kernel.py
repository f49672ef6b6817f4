"""Segmented blocked kernel: fragments of 21..24 simulated qubits.

Counterpart of the JAX package's ``ops/pallas_blocked.py`` (the Pallas
kernel built by ``_segment_call``, driven by ``make_blocked_chunk_kernel``).
Past the variant kernel's width gate the per-label state lives in device
memory as planar ``[labels, 2, 2^n]`` and the fused suffix runs in
SEGMENTS:

* :func:`plan_segments` groups consecutive ops whose qubits fit a
  ``w``-bit window and lays those qubits on the low ``w`` flat bits of a
  per-segment layout, so every aligned tile of ``2^w`` amplitudes is
  closed under the segment's gates;
* one kernel launch applies one segment to every tile of every label of
  a chunk (``csrc/blocked_kernel.cu``: the tile sits in shared memory
  while all the segment's gates apply, then is written back once);
* between segments one ``permute_bits_flat`` pass in torch re-tiles the
  batched state to the next segment's layout.

Layers, as in ``variant_kernel.py``: the host build (:func:`build_plan`),
the wrappers (:func:`apply_segment` for one segment, :func:`blocked_rows`
for a chunk's ``|psi|^2`` rows) that launch the CUDA kernel on CUDA
tensors and count the launches, and the plain PyTorch versions
(:func:`plain_segment`, :func:`plain_blocked_rows`) that run on the CPU
and are the kernel's reference on the card.

The window is bounded by shared memory (``8 * 2^w`` bytes a tile), so the
gate is ``2 <= w <= 14`` and the default 14.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import resolve_device, to_device
from ..virt.virtual_circuit import VirtualCircuit
from .bits import permute_bits_flat
from .kernel_build import KernelLibrary, check_tensor
from .statevector import apply_matrix_host, marginalize_flat
from .variant_kernel import (
    MAX_QUBITS,
    OpTable,
    _plan_ops,
    apply_op_plain,
    gather_slot_entries,
)

MAX_WINDOW = 14          # 8 * 2^14 B = 128 KB of a CTA's 227 KB
DEFAULT_WINDOW = 14
MAX_BLOCKED_QUBITS = 24  # host prefix and 2^24 * 8 B per label stay practical


def plan_segments(ops, n: int, w: int):
    """Greedy lookahead segmentation of a full-width op stream.

    ``ops``: [("u", mat, qubit_axes) | ("slot", sid, qubit_axes)].
    Returns ``segments = [(perm, seg_ops)]`` where ``perm`` maps qubit
    -> flat bit for that segment (every seg op's qubits map < w) and
    ``seg_ops`` keep QUBIT axes (the executor translates).  The first
    segment's perm is also the required input layout.
    """
    assert w < n
    segments = []
    i = 0
    cur_perm = None
    while i < len(ops):
        # lookahead: largest op prefix whose qubit union fits the window
        qubits: list[int] = []
        j = i
        while j < len(ops):
            extra = [q for q in ops[j][2] if q not in qubits]
            if len(qubits) + len(extra) > w:
                break
            qubits.extend(extra)
            j += 1
        assert j > i, f"op {ops[i]} touches more than w={w} qubits"
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


def _perm_dst_bits(prev: dict, nxt: dict, n: int) -> list[int]:
    """permute_bits_flat DST order taking layout ``prev`` to ``nxt``
    with bit labels = prev-layout flat positions: the input's bit j
    carries label j (src_bits = range(n)); output bit j must carry the
    prev-flat position of the qubit that layout ``nxt`` puts on bit j."""
    inv_next = {fb: q for q, fb in nxt.items()}
    return [prev[inv_next[j]] for j in range(n)]


@dataclass
class BlockedPlan:
    """Host build of one fragment's segmented run.

    ``perms[k]`` maps qubit -> flat bit in segment ``k``'s layout
    (``perms[0]`` is the prefix's layout; a fragment with an empty suffix
    has no segment and the canonical layout alone).  ``ops``, ``fixed``
    and the entry tables are one
    :class:`~.variant_kernel.OpTable` over all segments, rows in segment
    order over that segment's flat bits (all below ``w``);
    ``segments[k]`` is segment ``k``'s row range.  ``retiles[k]`` is the
    ``permute_bits_flat`` destination order (source labels ``range(n)``)
    from layout ``k`` to ``k + 1``."""

    n: int
    w: int
    prefix: np.ndarray         # [2, 2^n] float32 in perms[0]'s layout
    perms: list                # per segment {qubit: flat bit}
    ops: np.ndarray            # [n_ops, 4] int32
    fixed: np.ndarray          # float32 coefficient pool
    segments: list             # [(start, end)] op ranges
    retiles: list              # [n_segments - 1] dst-bit orders
    entry_tables: list         # per slot [nI, 2*m*m] float32
    entry_gids: list           # per slot: global vgate id
    entry_stride: int          # floats per label entry row

    def final_axes(self, qubits) -> list[int]:
        """``marginalize_flat`` axes of ``qubits`` in the LAST segment's
        layout (axis a is flat bit n-1-a)."""
        return [self.n - 1 - self.perms[-1][q] for q in qubits]


def build_plan(virt: VirtualCircuit, frag_name: str,
               window: int = DEFAULT_WINDOW) -> BlockedPlan:
    """Segment one fragment's fused suffix at ``min(window, n - 1)`` bits
    and build the prefix state, the op table and the re-tile orders."""
    prefix_ops, suffix, prog = _plan_ops(virt, frag_name)
    specs = [vg.spec for vg in virt.vgates]
    n = prog.num_sim_qubits
    w = min(window, n - 1)
    segs = plan_segments(suffix, n, w)
    perms = [perm for perm, _ in segs] or [{q: n - 1 - q for q in range(n)}]

    # host prefix in the FIRST segment's layout (qubit q on flat bit
    # perm[q]; apply_matrix_host's qubit q' sits on flat bit n-1-q')
    st = np.zeros((2, 1 << n), np.float32)
    st[0, 0] = 1.0
    for op in prefix_ops:
        st = apply_matrix_host(
            st, op[1], tuple(n - 1 - perms[0][q] for q in op[2]), n
        )

    table = OpTable(prog, specs)
    ranges = []
    for perm, seg_ops in segs:
        start = len(table.ops)
        for op in seg_ops:
            table.add(op, [perm[q] for q in op[2]])
        ranges.append((start, len(table.ops)))
    return BlockedPlan(
        n=n, w=w, prefix=st, perms=perms,
        ops=table.ops_array(), fixed=table.fixed_array(), segments=ranges,
        retiles=[_perm_dst_bits(perms[k], perms[k + 1], n)
                 for k in range(len(perms) - 1)],
        entry_tables=table.entry_tables, entry_gids=table.entry_gids,
        entry_stride=table.entry_stride,
    )


class BlockedDevicePlan:
    """A :class:`BlockedPlan` with its tables on one device."""

    def __init__(self, plan: BlockedPlan, device):
        self.plan = plan
        self.device = torch.device(device)
        self.prefix = to_device(plan.prefix, device)
        self.ops = to_device(
            plan.ops if plan.ops.size else np.zeros((1, 4), np.int32),
            device,
        )
        self.fixed = to_device(
            plan.fixed if plan.fixed.size else np.zeros(1, np.float32),
            device,
        )
        self.entry_tables = to_device(plan.entry_tables, device)

    def gather_entries(self, vidx_chunk: torch.Tensor) -> torch.Tensor:
        """``[C, entry_stride]`` per-label slot entries for a ``[C,
        num_vgates]`` block of variant indices (global vgate columns)."""
        return gather_slot_entries(self.entry_tables, self.plan.entry_gids,
                                   vidx_chunk)


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def plain_segment(dp: BlockedDevicePlan, k: int, state, entries):
    """Segment ``k`` on ``state`` (``[C, 2, 2^n]``, or the shared ``[2,
    2^n]`` prefix) with ``apply_slices`` over the flat state; returns a
    new ``[C, 2, 2^n]`` tensor."""
    plan = dp.plan
    c = entries.shape[0]
    if state.dim() == 2:
        state = state.expand(c, 2, 1 << plan.n)
    start, end = plan.segments[k]
    for row in plan.ops[start:end]:
        state = apply_op_plain(state, row, plan.n, plan.fixed, entries)
    return state


def _run_segments(dp: BlockedDevicePlan, entries, segment_fn):
    """Prefix -> every segment with ``segment_fn`` -> re-tile between
    segments -> ``|psi|^2`` rows ``[C, 2^n]`` in the last layout."""
    plan = dp.plan
    c = entries.shape[0]
    state = dp.prefix
    for k in range(len(plan.segments)):
        if k:
            state = permute_bits_flat(state, list(range(plan.n)),
                                      plan.retiles[k - 1])
        state = segment_fn(dp, k, state, entries)
    if state.dim() == 2:  # no segment: every label is the prefix state
        state = state.expand(c, 2, 1 << plan.n)
    return (state * state).sum(dim=1)


def plain_blocked_rows(dp: BlockedDevicePlan, entries) -> torch.Tensor:
    """The plain PyTorch version of :func:`blocked_rows`, on any device:
    the same segments and re-tiles, every gate an ``apply_slices`` pass."""
    return _run_segments(dp, entries, plain_segment)


# ---------------------------------------------------------------------------
# The CUDA kernel: bind, launch
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blocked_segment_launch.argtypes = (
        [p, p, ctypes.c_longlong, p, p, p] + [i] * 7 + [p]
    )
    lib.blocked_segment_launch.restype = i
    lib.blocked_kernel_max_window.restype = i


# csrc/blocked_kernel.cu, built for sm_90a at first launch
LIBRARY = KernelLibrary("blocked_kernel", _bind,
                        "blocked_kernel_error_string")


def _launch_segment(dp: BlockedDevicePlan, k: int, state, entries):
    lib = LIBRARY.load()
    plan = dp.plan
    dev = entries.device
    c = entries.shape[0]
    big = 1 << plan.n
    check_tensor(entries, "entries", torch.float32,
                 (c, max(1, plan.entry_stride)), dev)
    for name in ("ops", "fixed"):
        if getattr(dp, name).device != dev:
            raise ValueError(f"plan table {name} is not on {dev}")
    if not 2 <= plan.w <= lib.blocked_kernel_max_window():
        raise ValueError(f"window {plan.w} is outside the kernel's "
                         f"2..{lib.blocked_kernel_max_window()}")
    if state.dim() == 2:  # the shared prefix: read with label stride 0
        check_tensor(state, "prefix", torch.float32, (2, big), dev)
        src, stride = state, 0
        dst = torch.empty((c, 2, big), dtype=torch.float32, device=dev)
    else:                 # in place
        check_tensor(state, "state", torch.float32, (c, 2, big), dev)
        src = dst = state
        stride = 2 * big
    start, end = plan.segments[k]
    rc = lib.blocked_segment_launch(
        src.data_ptr(), dst.data_ptr(), stride, dp.ops.data_ptr(),
        dp.fixed.data_ptr(), entries.data_ptr(), start, end,
        plan.entry_stride, plan.n, plan.w, c,
        # one quad of a 2q gate per thread, within a warp and the limit
        max(32, min(1024, (1 << plan.w) // 4)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "blocked kernel launch failed: " + LIBRARY.error_text(rc)
        )
    blocked_rows.launches += 1
    return dst


def apply_segment(dp: BlockedDevicePlan, k: int, state,
                  entries) -> torch.Tensor:
    """Segment ``k`` of the plan on a chunk's states.  ``state`` is the
    shared ``[2, 2^n]`` prefix (a new ``[C, 2, 2^n]`` tensor is returned)
    or contiguous ``[C, 2, 2^n]`` states in segment ``k``'s layout.  CUDA
    tensors launch the hand-written kernel, which updates per-label
    states IN PLACE (counted in ``blocked_rows.launches``); CPU tensors
    run :func:`plain_segment`.  ``entries [C, entry_stride]`` from
    :meth:`BlockedDevicePlan.gather_entries`."""
    if entries.is_cuda:
        if state.dim() == 3 and not state.is_contiguous():
            state = state.contiguous()  # a re-tile returns a strided view
        return _launch_segment(dp, k, state, entries)
    if entries.device.type != "cpu":
        raise ValueError(f"unsupported device {entries.device}")
    return plain_segment(dp, k, state, entries)


def blocked_rows(dp: BlockedDevicePlan, entries) -> torch.Tensor:
    """``|psi|^2`` rows ``[C, 2^n]`` of a chunk of labels, in the last
    segment's layout (:meth:`BlockedPlan.final_axes`): one
    :func:`apply_segment` per segment, a torch re-tile between them."""
    return _run_segments(dp, entries, apply_segment)


blocked_rows.launches = 0


# ---------------------------------------------------------------------------
# Streamed-engine integration point (the JAX make_blocked_chunk_kernel)
# ---------------------------------------------------------------------------

def make_blocked_chunk_kernel(
    virt: VirtualCircuit, frag_name: str, chunk: int,
    window: int = DEFAULT_WINDOW, force: bool = False, device=None,
):
    """``(rows_fn, positions)`` with the contract of
    ``variant_kernel.make_chunk_kernel``: ``rows_fn(vidx_chunk)`` maps a
    ``[chunk, num_vgates]`` label block to ``[chunk, 2^len(positions)]``
    rows marginalised onto the written clbits, through the segmented
    blocked kernel.  Returns None when the fragment is outside the
    n = 21..24 gate (``force=True`` lifts the lower bound, for small
    tests) or the window ``min(window, n - 1)`` is outside 2..14.
    ``rows_fn.plan`` is the :class:`BlockedDevicePlan`."""
    dev = resolve_device(device)
    prog = virt.programs[frag_name]
    n = prog.num_sim_qubits
    if n > MAX_BLOCKED_QUBITS or (not force and n <= MAX_QUBITS):
        return None
    if not 2 <= min(window, n - 1) <= MAX_WINDOW:
        return None
    plan = build_plan(virt, frag_name, window)
    dp = BlockedDevicePlan(plan, dev)
    positions = sorted(prog.clbit_sources)
    # the last layout goes straight into the marginalisation's axes: no
    # permute back to the canonical layout
    axes = plan.final_axes(prog.clbit_sources[c] for c in positions)

    def rows_fn(vidx_chunk):
        rows = blocked_rows(dp, dp.gather_entries(vidx_chunk))
        return marginalize_flat(rows, plan.n, axes)

    rows_fn.plan = dp
    return rows_fn, positions


# ---------------------------------------------------------------------------
# Work counts for the roofline bound (bytes and f32 operations)
# ---------------------------------------------------------------------------

def work_counts(plan: BlockedPlan, k: int, labels: int) -> dict:
    """Work of segment ``k`` on ``labels`` states.  ``bytes``: each input
    read once and each output written once (the states, or the shared
    prefix once for the first segment; the op rows, coefficients and
    entry rows the segment uses).  ``flops``: f32 operations, 14 per
    amplitude for a 1q gate and 30 for a 2q gate (as
    ``variant_kernel.work_counts``)."""
    big = 1 << plan.n
    start, end = plan.segments[k]
    rows = plan.ops[start:end]
    per_op = np.where(rows[:, 0] == 1, 14, 30)
    coefs = np.where(rows[:, 0] == 1, 8, 32)
    is_slot = rows[:, 3] < 0
    state_in = 2 * big * (1 if k == 0 else labels)
    nbytes = 4 * (
        state_in + labels * 2 * big + rows.size
        + int(coefs[~is_slot].sum()) + labels * int(coefs[is_slot].sum())
    )
    return {"bytes": int(nbytes),
            "flops": int(per_op.sum()) * big * labels}
