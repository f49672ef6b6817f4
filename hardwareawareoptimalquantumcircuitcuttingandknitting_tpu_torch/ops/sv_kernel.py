"""Whole-fragment statevector kernel: every QPD variant of a fragment from
one launch.

Counterpart of the JAX package's ``ops/pallas_sv.py`` (the Pallas kernel
built by ``build_fragment_kernel`` and driven by ``run_fragment_pallas``).
It simulates the fragment's DATA qubits only.  Mid-circuit QPD
measurements use *projector branches* instead of deferred-measurement
ancillas: each measuring vgate contributes one branch bit, a *lane* is a
(variant, branch code) pair, and a measuring endpoint applies the lane's
projector ``(1-b, b)``, so the state never grows beyond the data qubits.
Per lane: ``|0..0>`` -> the fragment's fixed 1q/2q gates and, per slot,
the lane's ``pre`` 2x2, projector mask ``(m0, m1)`` and ``post`` 2x2 ->
``|psi|^2`` summed over the qubits no terminal measure reads.  The rows
of all lanes, ``[v_count << m, 2^k]``, are the fragment's
``FragmentResult.values [v_count, 2^(m+k)]`` as they lie in memory: the
branch code sits above the data bits, and the kernel's flat-bit layout
puts the data clbits in ascending order on the low bits, so nothing is
transposed or permuted after the launch.

Layers, as in the other kernel modules:

* the host build: :func:`_plan` and :func:`_slot_lane_params` (numpy, the
  JAX package's, with its refusals) and :func:`build_plan`: the original
  op table over flat bits, and what the kernel reads instead of a lane
  table: the fixed gates before the first slot run once on the host (the
  ``prefix`` state every lane starts from), the rest rewritten by
  ``ops/op_rewrite`` (identities dropped, diagonal runs merged, signed
  permutations as moves), and per slot a small table of the 18 floats
  for each (variant digit, branch bit) (:func:`_slot_tables`);
* :func:`sv_rows`, the wrapper: on a plan on CUDA it launches the
  hand-written kernel in ``csrc/sv_kernel.cu`` (built with ``nvcc`` for
  ``sm_90a`` at first use into ``build/``, loaded with ``ctypes``), which
  derives each lane's slot coefficients from its index, and counts the
  launch; on the CPU it runs :func:`plain_sv_rows` on the lane table that
  :func:`lane_params` builds by the kernel's own formula;
* :func:`plain_sv_rows`, the plain PyTorch version of the same function
  (the original op table from ``|0..0>``, a lane table row per lane),
  used on the CPU and as the kernel's reference on the card;
* :func:`build_fragment_kernel` / :func:`run_fragment_kernel`, the entry
  points (the JAX ``build_fragment_kernel`` / ``run_fragment_pallas``).
  The kernel is not an engine of ``run_virtual_circuit``: a caller
  composes ``run_fragment_kernel`` with ``knit.knit``.

Not carried over from the TPU kernel, because they are artefacts of its
128 lanes side by side: the lane table itself (on the card), its padding
to a multiple of 128, the ``[2^k, lanes]`` output with its host transpose
and bit permutation, and matrices baked into the traced program (one
build of the CUDA kernel interprets every fragment's op table).

What bounds the kernel on an H100 and what its design does about it is
written at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import resolve_device, to_device
from ..virt.virtual_circuit import VirtualCircuit
from . import op_rewrite
from .kernel_build import KernelLibrary, check_tensor
from .op_rewrite import matvec_ops as _matvec_ops
from .statevector import apply_matrix_host, apply_slices
from .variant_engine import FragmentResult, label_strides
from .variant_kernel import apply_op_plain

MAX_KERNEL_QUBITS = 13   # one lane's complex64 state: 64 KB of shared memory
SLOT_PARAMS = 18         # pre[8], mask[2], post[8] floats per lane and slot
_SLOT = 3                # op-table row kind of a slot (1, 2: fixed 1q, 2q)
# lanes per pass of the plain version: bounds its [lanes, 2, 2^n] states
_PLAIN_STATE_FLOATS = 1 << 27


@dataclass
class _SlotInfo:
    vgate_idx: int
    side: int
    qubit: int
    branch_bit: int | None  # index into the fragment's branch-code bits


def _plan(virt: VirtualCircuit, frag_name: str):
    """Static plan: op list over data qubits only, slots with branch bits."""
    prog = virt.programs[frag_name]
    n = prog.num_data_qubits
    if n > MAX_KERNEL_QUBITS:
        return None

    # branch bits: one per touching vgate whose clbit is written here
    meas_vgates = sorted(
        c - virt.num_clbits
        for c in prog.clbit_sources
        if c >= virt.num_clbits
    )
    branch_of = {g: j for j, g in enumerate(meas_vgates)}

    ops = []  # ("u", complex mat, qubits) | ("slot", _SlotInfo)
    terminal_sources: dict[int, int] = {}
    for kind, payload in prog.source:
        if kind == "slot":
            g, side, lq = payload
            ops.append(
                ("slot", _SlotInfo(g, side, lq, branch_of.get(g)))
            )
            continue
        ins = payload
        if ins.name == "measure":
            terminal_sources[ins.clbits[0]] = ins.qubits[0]
            continue
        if ins.name in ("reset",) or ins.condition is not None:
            return None  # the batched engine serves these
        if ins.name == "barrier":
            continue
        if len(ins.qubits) > 2:
            return None  # decompose() upstream handles 3q gates
        mat = (
            np.asarray(ins.op) if ins.name == "unitary" else ins.matrix()
        )
        ops.append(("u", mat, tuple(ins.qubits)))

    # verify data measures are terminal (no later ops on the qubit)
    touched_after: set[int] = set()
    for kind, payload in reversed(prog.source):
        if kind == "slot":
            touched_after.add(payload[2])
        elif payload.name == "measure":
            if payload.qubits[0] in touched_after:
                return None
            touched_after.add(payload.qubits[0])
        elif payload.name != "barrier":
            touched_after.update(payload.qubits)

    data_positions = sorted(terminal_sources)
    kept_qubits = sorted({terminal_sources[c] for c in data_positions})
    if len(kept_qubits) != len(data_positions):
        return None  # two clbits from one qubit: the batched engine's
    return (
        prog, n, meas_vgates, ops, terminal_sources, data_positions,
        kept_qubits,
    )


def _slot_lane_params(virt, prog, meas_vgates, slots):
    """Per-lane (variant x branch-code) coefficients of every slot: pre[8],
    mask[2], post[8], concatenated to ``[lanes, 18 * n_slots]`` float32.
    Returns ``(params, v_count, lanes)``.  No padding rows: a launch takes
    any number of lanes."""
    strides, n_inst, v_count = label_strides(
        [vg.spec for vg in virt.vgates], prog.touching
    )
    m = len(meas_vgates)
    total = v_count << m

    lane = np.arange(total)
    code = lane & ((1 << m) - 1)
    variant = lane >> m

    out = []
    # first measuring slot per vgate handles the zero-branch masking when no
    # endpoint measures under the current variant
    first_slot_of_g: dict[int, int] = {}
    for s_i, info in enumerate(slots):
        if info.branch_bit is not None and info.vgate_idx not in first_slot_of_g:
            first_slot_of_g[info.vgate_idx] = s_i

    for s_i, info in enumerate(slots):
        g = info.vgate_idx
        spec = virt.vgates[g].spec
        v_g = (variant // strides[g]) % n_inst[g]
        pres = np.stack([p[info.side].pre for p in spec.endpoints])[v_g]
        posts = np.stack([p[info.side].post for p in spec.endpoints])[v_g]
        meas = np.array(
            [p[info.side].measure for p in spec.endpoints], dtype=bool
        )[v_g]
        # does ANY endpoint of g in this fragment measure at this variant?
        any_meas = np.zeros(total, dtype=bool)
        for other in slots:
            if other.vgate_idx != g:
                continue
            o_meas = np.array(
                [p[other.side].measure for p in spec.endpoints], dtype=bool
            )[v_g]
            any_meas |= o_meas

        m0 = np.ones(total)
        m1 = np.ones(total)
        if info.branch_bit is not None:
            b = (code >> info.branch_bit) & 1
            # measuring here: projector (1-b, b)
            m0 = np.where(meas, 1.0 - b, m0)
            m1 = np.where(meas, b.astype(float), m1)
            # nobody measures g at this variant: designated slot kills b=1
            if first_slot_of_g.get(g) == s_i:
                dead = (~any_meas) & (b == 1)
                m0 = np.where(dead, 0.0, m0)
                m1 = np.where(dead, 0.0, m1)

        def c8(mats):
            return np.stack(
                [
                    mats[:, 0, 0].real, mats[:, 0, 0].imag,
                    mats[:, 0, 1].real, mats[:, 0, 1].imag,
                    mats[:, 1, 0].real, mats[:, 1, 0].imag,
                    mats[:, 1, 1].real, mats[:, 1, 1].imag,
                ],
                axis=1,
            )

        out.append(np.concatenate(
            [c8(pres), np.stack([m0, m1], axis=1), c8(posts)], axis=1
        ).astype(np.float32))

    if not out:
        arr = np.zeros((total, 0), dtype=np.float32)
    else:
        arr = np.concatenate(out, axis=1)  # [total, 18 * n_slots]
    return arr, v_count, total


def _c8(mats: np.ndarray) -> np.ndarray:
    """``[r, 2, 2]`` complex matrices -> ``[r, 8]``: entries 00, 01, 10,
    11, each re then im (the lane table's interleaving)."""
    return np.stack(
        [
            mats[:, 0, 0].real, mats[:, 0, 0].imag,
            mats[:, 0, 1].real, mats[:, 0, 1].imag,
            mats[:, 1, 0].real, mats[:, 1, 0].imag,
            mats[:, 1, 1].real, mats[:, 1, 1].imag,
        ],
        axis=1,
    )


def _slot_tables(virt, prog, meas_vgates, slots):
    """What the kernel reads instead of a lane table: ``(slot_tab [rows,
    18] f32, slot_meta [n_slots, 4] int32, v_count, total)``.  Slot ``s``
    owns rows ``off + 2 d + b`` of ``slot_tab``, one per variant digit
    ``d`` of its vgate and branch bit ``b``, with :func:`_slot_lane_params`'s
    rules (the projector ``(1-b, b)`` where the endpoint measures; on the
    first measuring slot of a vgate, ``(0, 0)`` for ``b = 1`` at a digit
    where no endpoint of the vgate in this fragment measures).
    ``slot_meta[s]`` = ``(stride, n_inst, branch bit or -1, off)``: a
    lane's digit is ``((lane >> m) // stride) % n_inst``."""
    strides, n_inst, v_count = label_strides(
        [vg.spec for vg in virt.vgates], prog.touching
    )
    first_slot_of_g: dict[int, int] = {}
    for s_i, info in enumerate(slots):
        if info.branch_bit is not None and info.vgate_idx not in first_slot_of_g:
            first_slot_of_g[info.vgate_idx] = s_i

    tabs, meta, off = [], [], 0
    for s_i, info in enumerate(slots):
        g = info.vgate_idx
        spec = virt.vgates[g].spec
        digit = np.repeat(np.arange(n_inst[g]), 2)
        b = np.tile(np.arange(2), n_inst[g])
        pres = np.stack([p[info.side].pre for p in spec.endpoints])[digit]
        posts = np.stack([p[info.side].post for p in spec.endpoints])[digit]
        meas = np.array(
            [p[info.side].measure for p in spec.endpoints], dtype=bool
        )[digit]
        any_meas = np.zeros(len(digit), dtype=bool)
        for other in slots:
            if other.vgate_idx == g:
                any_meas |= np.array(
                    [p[other.side].measure for p in spec.endpoints],
                    dtype=bool,
                )[digit]
        m0 = np.ones(len(digit))
        m1 = np.ones(len(digit))
        if info.branch_bit is not None:
            m0 = np.where(meas, 1.0 - b, m0)
            m1 = np.where(meas, b.astype(float), m1)
            if first_slot_of_g.get(g) == s_i:
                dead = (~any_meas) & (b == 1)
                m0 = np.where(dead, 0.0, m0)
                m1 = np.where(dead, 0.0, m1)
        tabs.append(np.concatenate(
            [_c8(pres), np.stack([m0, m1], axis=1), _c8(posts)], axis=1
        ).astype(np.float32))
        bb = -1 if info.branch_bit is None else info.branch_bit
        meta.append((strides[g], n_inst[g], bb, off))
        off += len(digit)
    slot_tab = (np.concatenate(tabs) if tabs
                else np.zeros((0, SLOT_PARAMS), np.float32))
    slot_meta = np.asarray(meta, np.int32).reshape(-1, 4)
    return slot_tab, slot_meta, v_count, v_count << len(meas_vgates)


def lane_rows(plan, lanes=None) -> np.ndarray:
    """``[L, n_slots]``: the ``slot_tab`` row of every slot for each lane
    (all ``plan.total`` lanes, or the indices ``lanes``), by the kernel's
    formula."""
    lane = (np.arange(plan.total, dtype=np.int64) if lanes is None
            else np.asarray(lanes, np.int64))
    variant, code = lane >> plan.m, lane & ((1 << plan.m) - 1)
    cols = []
    for stride, n_inst, bb, off in plan.slot_meta.tolist():
        b = (code >> bb) & 1 if bb >= 0 else 0
        cols.append(off + 2 * ((variant // stride) % n_inst) + b)
    return np.stack(cols, axis=1) if cols else np.zeros((len(lane), 0),
                                                        np.int64)


def lane_params(plan, lanes=None) -> np.ndarray:
    """The lane table ``[L, p_cols]`` f32 that the kernel's formula reads
    from the per-slot tables (one zero column without a slot): equal to
    :func:`_slot_lane_params` bit for bit.  The plain version takes it."""
    rows = lane_rows(plan, lanes)
    if not plan.slots:
        return np.zeros((len(rows), 1), np.float32)
    return plan.slot_tab[rows].reshape(len(rows), -1)


@dataclass
class SvPlan:
    """Host build of one fragment's kernel.

    ``ops``: the original op table, rows ``(kind, ja, jb, off)`` over flat
    bits: kind 1 / 2 a fixed 1q / 2q gate (``ja`` the gate-index MSB,
    ``off`` its offset in the ``fixed`` pool: re ``[m*m]`` then im
    ``[m*m]``), kind 3 a slot on flat bit ``ja`` whose 18 floats start at
    column ``off`` of the lane's ``params`` row.  Flat bit ``i < k`` holds
    the qubit that data clbit ``data_positions[i]`` reads, the qubits no
    terminal measure reads sit on bits ``k..n-1`` and are summed out.
    ``positions``: the result's clbits (data clbits ascending, then
    ``num_clbits + g`` per measuring vgate: the branch-code bits).

    What the kernel reads: ``prefix [2, 2^n]`` (the fixed gates before
    the first slot, applied once on the host), ``table`` (the rest,
    rewritten by ``ops/op_rewrite``), ``slot_tab`` / ``slot_meta`` (see
    :func:`_slot_tables`)."""

    name: str
    n: int                   # state width: max(data qubits, 1)
    k: int                   # kept (terminally measured) qubits
    ops: np.ndarray          # [n_ops, 4] int32
    fixed: np.ndarray        # float32 coefficient pool
    slots: list              # _SlotInfo per slot, in op order
    meas_vgates: list
    data_positions: list
    kept_qubits: list
    terminal_sources: dict
    positions: list
    touching: list
    prefix: np.ndarray       # [2, 2^n] float32
    prefix_ops: int          # rows of ``ops`` the prefix covers
    table: op_rewrite.Table
    slot_tab: np.ndarray     # [rows, 18] float32
    slot_meta: np.ndarray    # [n_slots, 4] int32
    v_count: int
    total: int               # lanes: v_count << m

    @property
    def m(self) -> int:
        return len(self.meas_vgates)

    @property
    def p_cols(self) -> int:
        """Columns of a lane's ``params`` row (1 dummy column without a
        slot)."""
        return max(1, SLOT_PARAMS * len(self.slots))

    @property
    def width(self) -> int:
        return 1 << self.k


def build_plan(virt: VirtualCircuit, frag_name: str) -> SvPlan | None:
    """The kernel's op tables for one fragment, or None where
    :func:`_plan` refuses it (``reset``, conditions, gates on more than 2
    qubits, a data measure that is not terminal, two clbits from one
    qubit, more than ``MAX_KERNEL_QUBITS`` data qubits)."""
    plan = _plan(virt, frag_name)
    if plan is None:
        return None
    (prog, n_data, meas_vgates, ops, terminal_sources, data_positions,
     kept_qubits) = plan
    n = max(n_data, 1)
    src = [terminal_sources[c] for c in data_positions]
    flat_of_q = {q: i for i, q in enumerate(src)}
    for q in range(n):
        flat_of_q.setdefault(q, len(flat_of_q))

    rows, fixed, slots, generic = [], [], [], []
    for entry in ops:
        if entry[0] == "slot":
            info = entry[1]
            rows.append((_SLOT, flat_of_q[info.qubit], 0,
                         SLOT_PARAMS * len(slots)))
            generic.append(("slot", flat_of_q[info.qubit], len(slots)))
            slots.append(info)
            continue
        _, mat, qubits = entry
        mat = np.asarray(mat, complex)
        js = [flat_of_q[q] for q in qubits]
        rows.append((len(js), js[0], js[1] if len(js) == 2 else 0,
                     len(fixed)))
        generic.append(("u", mat, js))
        fixed.extend(mat.real.astype(np.float32).ravel())
        fixed.extend(mat.imag.astype(np.float32).ravel())

    # the fixed gates before the first slot act on |0..0> alike in every
    # lane: once, on the host (apply_matrix_host's qubit q' is flat bit
    # n-1-q')
    first = next((i for i, g in enumerate(generic) if g[0] == "slot"),
                 len(generic))
    st = np.zeros((2, 1 << n), np.float32)
    st[0, 0] = 1.0
    for _, mat, js in generic[:first]:
        st = apply_matrix_host(st, mat, tuple(n - 1 - j for j in js), n)
    slot_tab, slot_meta, v_count, total = _slot_tables(
        virt, prog, meas_vgates, slots)
    return SvPlan(
        name=frag_name, n=n, k=len(kept_qubits),
        ops=np.asarray(rows, np.int32).reshape(-1, 4),
        fixed=np.asarray(fixed, np.float32), slots=slots,
        meas_vgates=list(meas_vgates), data_positions=list(data_positions),
        kept_qubits=list(kept_qubits),
        terminal_sources=dict(terminal_sources),
        positions=list(data_positions) + [
            virt.num_clbits + g for g in meas_vgates
        ],
        touching=list(prog.touching), prefix=st.astype(np.float32),
        prefix_ops=first, table=op_rewrite.rewrite(generic[first:]),
        slot_tab=slot_tab, slot_meta=slot_meta, v_count=v_count,
        total=total,
    )


class SvDevicePlan:
    """An :class:`SvPlan` with its tables on one device: the original op
    table for the plain version, the kernel's tables beside it."""

    def __init__(self, plan: SvPlan, device):
        self.plan = plan

        def put(arr, empty_shape, dtype):
            return to_device(arr if arr.size else np.zeros(empty_shape,
                                                           dtype), device)

        self.ops = put(plan.ops, (1, 4), np.int32)
        self.fixed = put(plan.fixed, 1, np.float32)
        self.rows = put(plan.table.rows, (1, op_rewrite.ROW), np.int32)
        self.pool = put(plan.table.pool, 1, np.float32)
        self.prefix = to_device(plan.prefix, device)
        self.slot_tab = put(plan.slot_tab, (1, SLOT_PARAMS), np.float32)
        self.slot_meta = put(plan.slot_meta, (1, 4), np.int32)
        self.device = self.prefix.device   # with its index: cuda:0


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def _slot_plain(st, n: int, j: int, par):
    """One slot on flat bit ``j`` of ``st [L, 2, 2^n]``: the lanes' pre
    gate, projector mask and post gate from ``par [L, 18]``."""
    axes = (n - 1 - j,)  # flat bit j <-> qubit n-1-j

    def gate(x, base):
        # entry (r, c) of the 2x2 at par[base + 4 r + 2 c] (re), + 1 (im)
        return apply_slices(
            x, lambda r, c: par[:, base + 4 * r + 2 * c],
            lambda r, c: par[:, base + 4 * r + 2 * c + 1], axes, n,
        )

    lanes = st.shape[0]
    x = gate(st, 0).reshape(lanes, 2, 1 << (n - 1 - j), 2, 1 << j)
    x = x * par[:, 8:10].reshape(lanes, 1, 1, 2, 1)
    return gate(x.reshape(lanes, 2, 1 << n), 10)


def plain_sv_rows(dp: SvDevicePlan, params: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device: the op
    table applied step by step to the states of all lanes ``[L, 2, 2^n]``
    (in passes over runs of lanes, to bound memory), then ``|psi|^2``
    summed over the dropped bits.  Returns ``[L, 2^k]``."""
    plan = dp.plan
    n, k = plan.n, plan.k
    lanes = params.shape[0]
    dev = params.device
    out = torch.empty((lanes, 1 << k), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_STATE_FLOATS >> (n + 1))
    for l0 in range(0, lanes, step):
        par = params[l0:l0 + step]
        c = par.shape[0]
        st = torch.zeros((c, 2, 1 << n), dtype=torch.float32, device=dev)
        st[:, 0, 0] = 1.0
        for row in plan.ops:
            if int(row[0]) == _SLOT:
                off = int(row[3])
                st = _slot_plain(st, n, int(row[1]),
                                 par[:, off:off + SLOT_PARAMS])
            else:
                st = apply_op_plain(st, row, n, plan.fixed, None)
        sq = (st * st).sum(dim=1)
        out[l0:l0 + step] = sq.reshape(c, 1 << (n - k), 1 << k).sum(dim=1)
    return out


def replay_kernel_table(dp: SvDevicePlan, lanes=None) -> torch.Tensor:
    """What the kernel computes, replayed in plain PyTorch on the plan's
    device: the ``prefix`` state, the rewritten table (``ops/op_rewrite``)
    with each slot's 18 floats from the per-slot tables, the epilogue.
    Rows ``[L, 2^k]``; tests hold it to :func:`plain_sv_rows`, which
    replays the original table."""
    plan = dp.plan
    n, k = plan.n, plan.k
    par = torch.as_tensor(lane_params(plan, lanes), device=dp.device)
    st = dp.prefix.expand(par.shape[0], 2, 1 << n)

    def slot(x, row):
        off = SLOT_PARAMS * int(row[2])
        return _slot_plain(x, n, int(row[1]), par[:, off:off + SLOT_PARAMS])

    st = op_rewrite.replay(st, plan.table, n, special=slot)
    sq = (st * st).sum(dim=1)
    return sq.reshape(-1, 1 << (n - k), 1 << k).sum(dim=1)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sv_rows_launch.argtypes = (
        [p] * 7 + [ctypes.c_longlong] + [i] * 10 + [p]
    )
    lib.sv_rows_launch.restype = i
    lib.sv_kernel_max_qubits.restype = i
    lib.sv_kernel_smem_bytes.argtypes = [i] * 7
    lib.sv_kernel_smem_bytes.restype = i


# csrc/sv_kernel.cu, built for sm_90a at first launch
LIBRARY = KernelLibrary("sv_kernel", _bind, "sv_kernel_error_string")


def launch_geometry(n: int) -> tuple[int, int]:
    """``(threads, group)`` of a launch: ``group`` threads share one lane's
    state (8 amplitudes each, at least a warp, at most 1024), and a block
    of at least 256 threads runs ``threads // group`` lanes side by
    side."""
    group = min(1024, max(32, (1 << n) // 8))
    return max(256, group), group


def _launch(dp: SvDevicePlan, lanes) -> torch.Tensor:
    lib = LIBRARY.load()
    plan = dp.plan
    dev = dp.device
    count = plan.total if lanes is None else lanes.shape[0]
    for name in ("rows", "pool", "prefix", "slot_tab", "slot_meta"):
        if getattr(dp, name).device != dev:
            raise ValueError(f"plan table {name} is not on {dev}")
    if count < 1:
        raise ValueError("no lane to run")
    if plan.n > lib.sv_kernel_max_qubits():
        raise ValueError(f"{plan.n} qubits exceed the kernel's width gate")
    threads, group = launch_geometry(plan.n)
    n_rows = len(plan.table.rows)
    n_pool = int(plan.table.pool.size)
    n_slot = int(plan.slot_tab.size)
    n_slots = len(plan.slots)
    smem = lib.sv_kernel_smem_bytes(plan.n, threads, group, n_rows, n_pool,
                                    n_slot, n_slots)
    props = torch.cuda.get_device_properties(dev)
    per_sm = max(1, min(2048 // threads, (227 * 1024) // max(1, smem)))
    lanes_per_block = threads // group
    grid = min(-(-count // lanes_per_block),
               props.multi_processor_count * per_sm)
    out = torch.empty((count, plan.width), dtype=torch.float32, device=dev)
    rc = lib.sv_rows_launch(
        dp.rows.data_ptr(), dp.pool.data_ptr(), dp.prefix.data_ptr(),
        dp.slot_tab.data_ptr(), dp.slot_meta.data_ptr(),
        0 if lanes is None else lanes.data_ptr(), out.data_ptr(), count,
        plan.n, plan.k, plan.m, n_rows, n_pool, n_slot, n_slots, group,
        grid, threads,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "sv kernel launch failed: " + LIBRARY.error_text(rc)
        )
    sv_rows.launches += 1
    return out


def sv_rows(dp: SvDevicePlan, lanes: torch.Tensor | None = None):
    """Rows ``[L, 2^k]`` of the lanes ``lanes`` (int64 indices in
    ``[0, plan.total)``, on the plan's device; None: every lane in
    order).  A plan on CUDA launches the hand-written kernel, once for all
    lanes (counted in ``sv_rows.launches``); it reads no lane table.  A
    plan on the CPU runs :func:`plain_sv_rows` on the lane table of
    :func:`lane_params`."""
    if lanes is not None:
        check_tensor(lanes, "lanes", torch.int64, (lanes.shape[0],),
                     dp.device)
        if len(lanes) and not (0 <= int(lanes.min())
                               and int(lanes.max()) < dp.plan.total):
            raise ValueError(f"lane indices outside [0, {dp.plan.total})")
    if dp.device.type == "cuda":
        return _launch(dp, lanes)
    if dp.device.type != "cpu":
        raise ValueError(f"unsupported device {dp.device}")
    idx = None if lanes is None else lanes.numpy()
    return plain_sv_rows(dp, torch.as_tensor(lane_params(dp.plan, idx)))


sv_rows.launches = 0


# ---------------------------------------------------------------------------
# Entry points (the JAX build_fragment_kernel / run_fragment_pallas)
# ---------------------------------------------------------------------------

def build_fragment_kernel(virt: VirtualCircuit, frag_name: str, device=None):
    """``(fn, params, meta)`` or None where the fragment is outside the
    kernel (see :func:`build_plan`).  ``params`` is the host lane table
    ``[lanes, p_cols]`` (numpy, :func:`_slot_lane_params`: the JAX
    function's contract; the kernel itself reads no lane table);
    ``fn(lanes=None)`` gives the fragment's rows ``[v_count, 2^(m+k)]`` on
    ``device`` (None = "cuda"), or ``[L, 2^k]`` for lane indices
    ``lanes``: bit ``i < k`` of a row's index is data clbit
    ``data_positions[i]``, bit ``k + j`` the clbit of ``meas_vgates[j]``.
    ``fn.plan`` is the :class:`SvDevicePlan`; ``meta`` holds the JAX
    function's keys."""
    dev = resolve_device(device)
    plan = build_plan(virt, frag_name)
    if plan is None:
        return None
    params, v_count, total = _slot_lane_params(
        virt, virt.programs[frag_name], plan.meas_vgates, plan.slots
    )
    if params.shape[1] == 0:
        params = np.zeros((total, 1), np.float32)
    dp = SvDevicePlan(plan, dev)

    def fn(lanes=None):
        rows = sv_rows(dp, lanes)
        return rows.reshape(v_count, -1) if lanes is None else rows

    fn.plan = dp
    meta = {
        "v_count": v_count,
        "total": total,
        "meas_vgates": plan.meas_vgates,
        "data_positions": plan.data_positions,
        "kept_qubits": plan.kept_qubits,
        "terminal_sources": plan.terminal_sources,
        "width": plan.width,
    }
    return fn, params, meta


def run_fragment_kernel(
    virt: VirtualCircuit, frag_name: str, device=None,
    timings: dict | None = None,
) -> FragmentResult | None:
    """A fragment's full variant fan-out from the kernel, as a
    ``FragmentResult`` on ``device`` (None = "cuda"; "cpu" runs the plain
    version).  Returns None where the fragment is outside the kernel
    (:func:`build_plan`); it never runs another engine itself.  No lane
    table is built on the card.  A ``timings`` dict gets the host seconds
    of the two stages added to its ``plan_s`` (the op tables, the prefix
    and the per-slot tables in numpy) and ``upload_and_kernel_s`` (their
    upload and the launch, ended by a device synchronize)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    plan = build_plan(virt, frag_name)
    if plan is None:
        return None
    t1 = time.perf_counter()
    values = sv_rows(SvDevicePlan(plan, dev)).reshape(plan.v_count, -1)
    if timings is not None:
        if values.is_cuda:
            torch.cuda.synchronize(values.device)
        t2 = time.perf_counter()
        timings["plan_s"] = timings.get("plan_s", 0.0) + t1 - t0
        timings["upload_and_kernel_s"] = (
            timings.get("upload_and_kernel_s", 0.0) + t2 - t1
        )
    return FragmentResult(frag_name, values, list(plan.positions),
                          list(plan.touching))


# ---------------------------------------------------------------------------
# Work counts for the roofline bound (bytes and f32 operations)
# ---------------------------------------------------------------------------

def work_counts(plan: SvPlan, lanes=None) -> dict:
    """Work of the lanes ``lanes`` (indices; None: all ``plan.total``),
    whatever implements the function.

    ``bytes``: the tables the kernel reads (rewritten op table and pool,
    the prefix state, the per-slot tables) once, the rows written once.
    ``flops``: what the matrices at hand need (:func:`_matvec_ops`: zero,
    unit, real and imaginary entries are not charged as dense complex
    ones).  The fixed gates before the first slot act on the same
    ``|0..0>`` in every lane and count once per fragment; every later
    fixed gate counts once per lane.  A slot counts each lane's own
    ``pre`` and ``post`` plus 2 an amplitude of a mask entry other than 0
    or 1.  Then ``|psi|^2`` 3 an amplitude and one add per amplitude
    summed away.  ``pass_bytes`` is what this design moves through shared
    memory on top: the prefix copied in, a read and a write of the lane's
    ``[2, 2^n]`` f32 state per rewritten row in every lane, and the
    epilogue's reads."""
    big = 1 << plan.n
    count = plan.total if lanes is None else len(lanes)
    shared = per_lane = 0
    for i, (kind, _, _, off) in enumerate(plan.ops.tolist()):
        if kind == _SLOT:
            continue
        d = 1 << kind
        mat = plan.fixed[off:off + 2 * d * d].reshape(2, d, d)
        cost = int(_matvec_ops(mat[0], mat[1])) * (big // d)
        if i < plan.prefix_ops:
            shared += cost
        else:
            per_lane += cost
    slot_ops = 0
    if plan.slots:
        tab = plan.slot_tab
        pre, post = (tab[:, a:a + 8].reshape(-1, 2, 2, 2) for a in (0, 10))
        mask = tab[:, 8:10]
        row_cost = (_matvec_ops(pre[..., 0], pre[..., 1])
                    + _matvec_ops(post[..., 0], post[..., 1])
                    + 2 * ((mask != 0) & (mask != 1)).sum(1)) * (big // 2)
        uses = np.bincount(lane_rows(plan, lanes).ravel(),
                           minlength=len(tab))
        slot_ops = int((row_cost * uses).sum())
    epilogue = 3 * big + (big - plan.width)
    flops = shared + slot_ops + count * (per_lane + epilogue)
    nbytes = 4 * (plan.table.rows.size + plan.table.pool.size
                  + plan.prefix.size + plan.slot_tab.size
                  + plan.slot_meta.size + count * plan.width)
    passes = count * (16 * len(plan.table.rows) + 8 + 8 + 8) * big
    return {"bytes": int(nbytes), "flops": int(flops),
            "pass_bytes": int(passes)}
