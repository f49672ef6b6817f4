"""Whole-variant statevector kernel for the ``engine="pallas"`` label scan.

Counterpart of the JAX package's ``ops/pallas_variant.py`` (the Pallas
kernel built by ``_build_call`` and entered through
``make_folded_chunk_kernel`` and ``make_chunk_kernel``).  Per QPD label of
a chunk: shared prefix state -> fused suffix (fixed 1q/2q gates, slot
gates with the label's own entries) -> epilogue, either the fold (vgate
weights, z signs and dropped bits contracted into a ``[2^d]`` knit row) or
full ``|psi|^2`` rows.

Three layers:

* the host build (:func:`build_plan`): the same fused op stream the JAX
  kernel runs, split at the first slot; the prefix runs once on the host;
  the suffix becomes an integer op table over flat bits plus a fixed-
  coefficient pool, grouped into one segment per slot (staged mode), and
  that table rewritten by ``ops/op_rewrite`` for the kernel (identities
  dropped, diagonal runs merged, signed permutations as moves), its
  segments cut at the same slots;
* :func:`variant_rows`, the wrapper: on CUDA tensors it launches the
  hand-written kernels in ``csrc/variant_kernel.cu`` (built with ``nvcc``
  for ``sm_90a`` at first use into ``build/``, loaded with ``ctypes``):
  a one-CTA schedule launch that cuts the chunk into runs (its plain
  version is :func:`run_table`), then the rows launch, which it counts;
  on CPU tensors it runs :func:`plain_variant_rows`.  :func:`label_rows`,
  the call the row functions make, has the schedule launch sort a
  chunk's labels by their slot digits first (plain version:
  :meth:`DevicePlan.order`) and the rows land in the chunk's order, so
  any label order gets a natural chunk's staging;
* :func:`plain_variant_rows`, the plain PyTorch version of the same
  function (the original op table and epilogue, every label replayed in
  full with no staging), used on the CPU and as the kernel's reference on
  the card.

What bounds the kernel on an H100 and what its design does about it is
written at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import resolve_device, to_device
from ..virt.virtual_circuit import VirtualCircuit
from . import op_rewrite
from .kernel_build import KernelLibrary, check_tensor
from .op_rewrite import OP_GATE1, OP_GATE2, matvec_ops
from .statevector import apply_matrix_host, apply_slices, marginalize_flat
from .variant_engine import _slot_tables, _fuse_slot_ops

# Port's own width gate: up to 15 qubits the state is on chip, from 16 to
# 20 it lives in a per-CTA global scratch ([CTAs, segments, 2, 2^n] f32
# with the checkpoints).  Wider fragments need the segmented blocked
# kernel.
MAX_QUBITS = 20
CLUSTER_QUBITS = 15  # the width a cluster of two CTAs holds on chip
_BLOCKED_ITEM = (
    "the segmented blocked kernel serves 21..24 qubits "
    "(ops/blocked_kernel.make_blocked_chunk_kernel; ROADMAP H100 port, "
    "queue B, kernel 4)"
)


def _to_complex(block: np.ndarray) -> np.ndarray:
    """Real (2, m, 2, m) block -> complex (m, m)."""
    return block[0, :, 0, :] + 1j * block[1, :, 0, :]


def _plan_ops(virt: VirtualCircuit, frag_name: str):
    """(prefix_ops, suffix_steps, prog) — the fused-slot op stream the JAX
    engines execute, split at the first slot.  Suffix steps:
    ("u", complex mat, axes) | ("slot", slot_id, axes)."""
    from .fusion import fused_stream

    prog = virt.programs[frag_name]
    skeleton, mats = fused_stream(_fuse_slot_ops(prog.ops), max_qubits=2)
    ops = []
    bi = 0
    for op in skeleton:
        if op[0] == "u":
            ops.append(("u", np.asarray(mats[bi], complex), op[1]))
            bi += 1
        else:  # ("slot", sid, axes)
            ops.append(op)
    first = next((i for i, op in enumerate(ops) if op[0] != "u"), len(ops))
    return ops[:first], ops[first:], prog


class OpTable:
    """Accumulates a kernel's op table: rows ``(nq, ja, jb, coef)`` over
    flat bits (``ja`` = the gate-index MSB), the fixed-coefficient pool
    and the per-slot entry tables.  ``coef >= 0`` is an offset into the
    pool (re ``[m*m]`` then im ``[m*m]``), ``coef < 0`` is ``-1 -
    offset`` into the label's entry row (the concatenated per-slot ``[2,
    m, m]`` entries).  A row with ``nq == 0`` is a collapse site on flat
    bit ``ja`` whose per-label scalars sit at site index ``jb`` (the
    collapse kernel alone reads such rows; ``sites`` lists their slot
    ids in row order).  One table format serves every circuit, so one
    build of a kernel does too."""

    def __init__(self, prog, specs):
        self._prog = prog
        self._specs = specs
        self._tabs: dict = {}          # fused? -> _slot_tables(...)
        self.sites: list = []          # slot id per collapse row
        self.ops: list = []
        self.fixed: list = []
        self.entry_tables: list = []   # per slot [nI, 2*m*m] float32
        self.entry_gids: list = []     # per slot: global vgate id
        self.entry_stride = 0          # floats per label entry row
        self.slot_rows: list = []      # op rows that are slots

    def _slot_table(self, sid: int, kind: str) -> np.ndarray:
        """``[nI, 2, m, 2, m]`` real blocks of one slot op: the composed
        block (``"slot"``) or the unfused pre / post endpoint gate."""
        fused = kind == "slot"
        if fused not in self._tabs:
            self._tabs[fused] = _slot_tables(self._prog, self._specs,
                                             fused=fused)
        return self._tabs[fused][sid][{"slot": 0, "slot_pre": 0,
                                       "slot_post": 2}[kind]]

    def add(self, op, js) -> None:
        """Append ``("u", complex mat, axes)``, ``("slot" | "slot_pre" |
        "slot_post", slot_id, axes)`` or ``("collapse", slot_id, axes)``
        acting on flat bits ``js``."""
        if op[0] == "collapse":
            self.ops.append((0, js[0], len(self.sites), 0))
            self.sites.append(op[1])
            return
        if len(js) not in (1, 2):
            raise NotImplementedError(
                f"{len(js)}-qubit op in the fused suffix: the kernels "
                "apply 1q and 2q gates only"
            )
        ja, jb = js[0], (js[1] if len(js) == 2 else 0)
        if op[0] == "u":
            mat = np.asarray(op[1], complex)
            coef = len(self.fixed)
            self.fixed.extend(mat.real.astype(np.float32).ravel())
            self.fixed.extend(mat.imag.astype(np.float32).ravel())
        else:
            self.slot_rows.append(len(self.ops))
            tab = self._slot_table(op[1], op[0])
            cx = np.stack([_to_complex(t) for t in tab])  # [nI, m, m]
            ent = np.stack([cx.real, cx.imag], axis=1).astype(np.float32)
            self.entry_tables.append(ent.reshape(ent.shape[0], -1))
            self.entry_gids.append(self._prog.slots[op[1]].vgate_idx)
            coef = -1 - self.entry_stride
            self.entry_stride += self.entry_tables[-1].shape[1]
        self.ops.append((len(js), ja, jb, coef))

    def ops_array(self) -> np.ndarray:
        return np.asarray(self.ops, np.int32).reshape(-1, 4)

    def fixed_array(self) -> np.ndarray:
        return np.asarray(self.fixed, np.float32)


def generic_ops(ops: np.ndarray, fixed: np.ndarray) -> list:
    """An :class:`OpTable`'s rows as ``op_rewrite.rewrite`` takes them:
    fixed gates from their f32 pool entries, slot gates by their entry
    offset, collapse rows as sites."""
    out = []
    for nq, ja, jb, coef in ops.tolist():
        if nq == 0:
            out.append(("site", ja, jb))
            continue
        js = [ja, jb][:nq]
        if coef < 0:
            out.append(("e", js, -1 - coef))
            continue
        m = 1 << nq
        blk = fixed[coef:coef + 2 * m * m].astype(np.float64)
        out.append(("u", (blk[:m * m] + 1j * blk[m * m:]).reshape(m, m),
                    js))
    return out


def op_costs(ops: np.ndarray, fixed: np.ndarray, n: int,
             entries=None) -> np.ndarray:
    """f32 operations of each :class:`OpTable` row on a ``2^n`` state,
    ``[C, n_ops]`` for the labels' entry rows ``entries [C, stride]``
    (numpy), else ``[1, n_ops]``: a gate what its matrix needs
    (``op_rewrite.matvec_ops``: nothing for an identity or a permutation),
    a slot gate from each label's own entries (as dense without them), a
    collapse row nothing."""
    big = 1 << n
    c = 1 if entries is None else len(entries)
    cost = np.zeros((c, len(ops)), np.int64)
    for i, (nq, _, _, coef) in enumerate(np.asarray(ops).tolist()):
        if nq == 0:
            continue
        m = 1 << nq
        if coef >= 0:
            blk = fixed[coef:coef + 2 * m * m].reshape(2, m, m)
        elif entries is None:
            blk = np.ones((2, m, m), np.float32)   # dense complex
        else:
            off = -1 - coef
            blk = np.moveaxis(np.asarray(entries)[:, off:off + 2 * m * m]
                              .reshape(c, 2, m, m), 1, 0)
        cost[:, i] = matvec_ops(blk[0], blk[1]) * (big // m)
    return cost


class SlotEntries:
    """Per-slot tables (``tables[s]`` ``[nI_s, w_s]`` float32, slot ``s``
    reading label column ``gids[s]``) on one device, gathered into a
    per-label row ``[C, sum w_s]`` (the slots' rows side by side) by one
    index into their concatenation: a handful of device ops, however many
    slots.  Without a slot, rows of one zero."""

    def __init__(self, tables, gids, device):
        dev = torch.device(device)
        self.flat = None
        if tables:
            self.flat = to_device(np.concatenate(
                [np.asarray(t, np.float32).ravel() for t in tables]), dev)
            base, col, stride, at = [], [], [], 0
            for tab, g in zip(tables, gids):
                w = tab.shape[1]
                base.extend(at + np.arange(w))
                col.extend([g] * w)
                stride.extend([w] * w)
                at += tab.size
            self.base, self.col, self.stride = (
                torch.as_tensor(np.asarray(a, np.int64), device=dev)
                for a in (base, col, stride))

    def __call__(self, vidx_chunk: torch.Tensor) -> torch.Tensor:
        """``[C, width]`` rows for a ``[C, num_vgates]`` block of variant
        indices (global vgate columns)."""
        if self.flat is None:
            return torch.zeros((vidx_chunk.shape[0], 1), dtype=torch.float32,
                               device=vidx_chunk.device)
        return self.flat[vidx_chunk[:, self.col] * self.stride + self.base]


@dataclass
class VariantPlan:
    """Host build of one fragment's kernel (the JAX ``_build_call``).

    ``ops``, ``fixed`` and the entry tables are an :class:`OpTable`'s
    (the original table, which the plain version replays).
    ``segments`` are op ranges: one per slot when staged, else
    one covering the whole suffix (none when the fragment has no slot).
    ``table`` is what the kernel interprets, the suffix rewritten by
    ``ops/op_rewrite``, and ``row_segments`` its row ranges, cut at the
    same slots (a slot row ends any diagonal run, so they line up).
    ``fold`` is None (full rows) or ``(wbits, zmask, d)``."""

    n: int
    prefix: np.ndarray             # [2, 2^n] float32, shared by all labels
    ops: np.ndarray                # [n_ops, 4] int32
    fixed: np.ndarray              # float32 coefficient pool
    segments: list                 # [(start, end)] op ranges
    entry_tables: list             # per slot [nI, 2*m*m] float32
    entry_gids: list               # per slot: global vgate id
    entry_stride: int              # floats per label entry row
    fold: tuple | None             # (wbits list, zmask, d) or None
    staged: bool                   # one segment per slot
    table: op_rewrite.Table        # the kernel's rewritten rows
    row_segments: list             # [(start, end)] rewritten row ranges

    @property
    def out_width(self) -> int:
        return 1 << (self.fold[2] if self.fold is not None else self.n)


def build_plan(virt: VirtualCircuit, frag_name: str, fold=None,
               staged: bool = True) -> VariantPlan:
    """Host build of the kernel for one fragment.  ``fold`` follows the
    JAX ``_build_call`` contract: ``{"w": [(clbit | None, ti)], "z":
    [clbits], "keep": [clbits ascending]}``.  Raises NotImplementedError
    past the port's width gate."""
    prefix_ops, suffix, prog = _plan_ops(virt, frag_name)
    specs = [vg.spec for vg in virt.vgates]
    n = prog.num_sim_qubits
    if n > MAX_QUBITS:
        raise NotImplementedError(
            f"fragment {frag_name!r} simulates {n} qubits, past the "
            f"variant kernel's {MAX_QUBITS}-qubit width gate: "
            f"{_BLOCKED_ITEM}"
        )

    # ---- flat-bit layout (permuted for the fold epilogue) -------------
    fold_desc = None
    if fold is None:
        flat_of_q = {q: n - 1 - q for q in range(n)}
    else:
        kept = list(fold["keep"])
        d_keep = len(kept)
        flat_of_q = {}
        for j, c in enumerate(kept):
            flat_of_q[prog.clbit_sources[c]] = j
        nxt = d_keep
        for q in range(n):
            if q not in flat_of_q:
                flat_of_q[q] = nxt
                nxt += 1
        assert nxt == n, (nxt, n)
        wbits = []
        for ti, (c, t) in enumerate(fold["w"]):
            assert t == ti, (t, ti)
            wbits.append(-1 if c is None else flat_of_q[prog.clbit_sources[c]])
        zmask = 0
        for c in fold.get("z", ()):
            zmask |= 1 << flat_of_q[prog.clbit_sources[c]]
        assert all(fb < 0 or fb >= d_keep for fb in wbits)
        assert zmask & ((1 << d_keep) - 1) == 0
        fold_desc = (wbits, zmask, d_keep)

    # host-shared prefix at full width (apply_matrix_host's qubit q' sits
    # on flat bit n-1-q')
    st = np.zeros((2, 1 << n), np.float32)
    st[0, 0] = 1.0
    for op in prefix_ops:
        st = apply_matrix_host(
            st, op[1], tuple(n - 1 - flat_of_q[q] for q in op[2]), n
        )

    table = OpTable(prog, specs)
    for op in suffix:
        table.add(op, [flat_of_q[q] for q in op[2]])
    ops, fixed = table.ops_array(), table.fixed_array()
    ktable = op_rewrite.rewrite(generic_ops(ops, fixed))
    # slot rows keep their own row in the rewrite, in chain order
    k_starts = [i for i, r in enumerate(ktable.rows.tolist())
                if r[0] in (OP_GATE1, OP_GATE2) and r[3] < 0]
    assert len(k_starts) == len(table.slot_rows)
    return VariantPlan(
        n=n, prefix=st, ops=ops, fixed=fixed,
        segments=_segments(table.slot_rows, len(ops), staged),
        entry_tables=table.entry_tables,
        entry_gids=table.entry_gids, entry_stride=table.entry_stride,
        fold=fold_desc, staged=staged, table=ktable,
        row_segments=_segments(k_starts, len(ktable.rows), staged),
    )


def _segments(starts: list, end: int, staged: bool) -> list:
    """Row ranges of the segments: one per slot (``starts``) when staged,
    else one for the whole suffix; none without a slot."""
    assert not starts or starts[0] == 0, "suffix must start at a slot"
    if not starts:
        return []
    if staged:
        return list(zip(starts, starts[1:] + [end]))
    return [(0, end)]


class DevicePlan:
    """A :class:`VariantPlan` with its tables on one device: the kernel's
    rewritten rows, pool and segment starts, the entry tables and the
    fold's weight bits (the plain version reads the plan's original
    table)."""

    def __init__(self, plan: VariantPlan, device):
        self.plan = plan
        self.device = torch.device(device)
        self.prefix = to_device(plan.prefix, device)
        self.rows = to_device(
            plan.table.rows if len(plan.table.rows)
            else np.zeros((1, op_rewrite.ROW), np.int32), device)
        self.pool = to_device(
            plan.table.pool if plan.table.pool.size
            else np.zeros(1, np.float32), device)
        bounds = [s for s, _ in plan.row_segments] + (
            [plan.row_segments[-1][1]] if plan.row_segments else [0]
        )
        self.seg_start = to_device(np.asarray(bounds, np.int32), device)
        self._entries = SlotEntries(plan.entry_tables, plan.entry_gids,
                                    device)
        wbits = plan.fold[0] if plan.fold is not None else []
        self.wbits = to_device(
            np.asarray(wbits or [0], np.int32), device
        )
        # the slots' digits as one mixed-radix key, chain order most
        # significant (None where it would not fit an int64: no sort)
        radix = [len(t) for t in plan.entry_tables]
        self.key_strides = None
        if plan.staged and radix and math.prod(radix) < 2 ** 62:
            self.key_strides = to_device(np.asarray(
                [math.prod(radix[i + 1:]) for i in range(len(radix))],
                np.int64), device)

    def gather_entries(self, vidx_chunk: torch.Tensor) -> torch.Tensor:
        """``[C, entry_stride]`` per-label slot entries for a ``[C,
        num_vgates]`` block of variant indices (global vgate columns)."""
        return self._entries(vidx_chunk)

    def stages(self, vidx_chunk: torch.Tensor) -> torch.Tensor:
        """Per-label resume stage: the first chain-order slot whose variant
        differs from the PREVIOUS row (row 0: 0; all slots when nothing
        changed).  Unstaged plans replay everything (all zeros)."""
        c = vidx_chunk.shape[0]
        k = len(self.plan.entry_gids)
        if not self.plan.staged or k == 0:
            return torch.zeros(c, dtype=torch.int32, device=self.device)
        comp = vidx_chunk[:, self.plan.entry_gids]
        prev = torch.cat(
            [torch.full((1, k), -1, dtype=comp.dtype, device=comp.device),
             comp[:-1]], dim=0,
        )
        dif = comp != prev
        first = dif.to(torch.int8).argmax(dim=1)
        return torch.where(dif.any(dim=1), first,
                           torch.full_like(first, k)).to(torch.int32)

    def sort_key(self, vidx_chunk: torch.Tensor):
        """``[C]`` int64: each label's slot digits as one mixed-radix
        number, chain order most significant.  None where sorting gains
        nothing (an unstaged plan, no slot) or the key would not fit an
        int64."""
        if self.key_strides is None:
            return None
        return (vidx_chunk[:, self.plan.entry_gids]
                * self.key_strides).sum(dim=1)

    def order(self, vidx_chunk: torch.Tensor):
        """The chunk's rows sorted by their slot digits in chain order (a
        stable argsort of :meth:`sort_key`): labels that share the early
        slots come side by side, so their stages are late.  None where
        :meth:`sort_key` is.  The plain version of the kernel's schedule
        launch, which sorts on the card."""
        key = self.sort_key(vidx_chunk)
        return None if key is None else torch.argsort(key, stable=True)


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def apply_op_plain(state, row, n: int, fixed: np.ndarray, entries):
    """One op-table row applied to ``state [B, 2, 2^n]`` with
    ``apply_slices`` (flat bit j is qubit n-1-j)."""
    nq, ja, jb, coef = (int(v) for v in row)
    m = 1 << nq
    js = (ja, jb)[:nq]
    axes = tuple(n - 1 - j for j in js)  # flat bit j <-> qubit n-1-j
    if coef >= 0:
        blk = fixed[coef:coef + 2 * m * m]
        ur = lambda r, c: float(blk[r * m + c])  # noqa: E731
        ui = lambda r, c: float(blk[m * m + r * m + c])  # noqa: E731
    else:
        off = -1 - coef
        ur = lambda r, c: entries[:, off + r * m + c]  # noqa: E731
        ui = lambda r, c: entries[:, off + m * m + r * m + c]  # noqa: E731
    return apply_slices(state, ur, ui, axes, n)


def _epilogue_plain(st, ws, dp: DevicePlan):
    sq = (st * st).sum(dim=1)  # [B, 2^n]
    plan = dp.plan
    if plan.fold is None:
        return sq
    wbits, zmask, d = plan.fold
    b = sq.shape[0]
    hdim = 1 << (plan.n - d)
    h = torch.arange(hdim, device=sq.device)
    fac = torch.ones((b, hdim), dtype=sq.dtype, device=sq.device)
    for t, fb in enumerate(wbits):
        w0, w1 = ws[:, t, 0:1], ws[:, t, 1:2]
        if fb < 0:
            fac = fac * w0
        else:
            bit = ((h >> (fb - d)) & 1).bool()
            fac = fac * torch.where(bit, w1, w0)
    zh = zmask >> d
    if zh:
        par = torch.zeros_like(h)
        for j in range(plan.n - d):
            if (zh >> j) & 1:
                par = par ^ ((h >> j) & 1)
        fac = fac * (1 - 2 * par).to(sq.dtype)
    return (sq.reshape(b, hdim, 1 << d) * fac[:, :, None]).sum(dim=1)


def plain_variant_rows(dp: DevicePlan, entries, wstack) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device: every label
    of the chunk replays the whole suffix from the shared prefix in one
    batch, then the epilogue.  No runs, no checkpoints and no stages — the
    staged schedule only skips work whose result it already holds, so the
    rows do not depend on it."""
    plan = dp.plan
    c = entries.shape[0]
    st = dp.prefix.to(entries.device).expand(c, 2, 1 << plan.n)
    for row in plan.ops:
        st = apply_op_plain(st, row, plan.n, plan.fixed, entries)
    return _epilogue_plain(st, wstack, dp)


def replay_kernel_table(dp: DevicePlan, entries, wstack, stage,
                        cap: int) -> torch.Tensor:
    """What the kernel computes, replayed in plain PyTorch with its own
    schedule: the runs of :func:`run_table`, the rewritten table
    (``plan.table``, ``plan.row_segments``), a run's first label from the
    prefix, every other label from the checkpoint its stage names (the
    previous label's final state when nothing changed), then the
    epilogue.  Returns rows like :func:`plain_variant_rows`; tests hold
    the two together, which replay different tables."""
    plan = dp.plan
    n, n_seg = plan.n, len(plan.row_segments)
    table, count = run_table(stage, n_seg, cap)
    out = [None] * entries.shape[0]
    for first, length in table[:int(count)].tolist():
        ck, st = {}, None
        for lab in range(first, first + length):
            s = 0 if lab == first else int(stage[lab])
            if s == 0 or s < n_seg:
                st = dp.prefix[None].to(entries.device) if s == 0 else ck[s]
                for i in range(s, n_seg):
                    if i > s:
                        ck[i] = st      # segment i's start, kept
                    a, b = plan.row_segments[i]
                    for row in plan.table.rows[a:b]:
                        st = op_rewrite.apply_row(st, row, n, plan.table.pool,
                                                  entries[lab:lab + 1])
            out[lab] = _epilogue_plain(st, wstack[lab:lab + 1], dp)
    return torch.cat(out)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.variant_rows_launch.argtypes = [p] * 13 + [i] * 17 + [p]
    lib.variant_rows_launch.restype = i
    lib.variant_kernel_max_weights.restype = i
    lib.variant_kernel_capacity.argtypes = [i] * 3
    lib.variant_kernel_capacity.restype = i
    lib.variant_kernel_max_schedule.restype = i
    lib.variant_schedule_launch.argtypes = [p, p, i, p, i, i, i, p, p, p, p,
                                            p]
    lib.variant_schedule_launch.restype = i


# csrc/variant_kernel.cu, built for sm_90a at first launch
LIBRARY = KernelLibrary("variant_kernel", _bind,
                        "variant_kernel_error_string")


def launch_geometry(n: int) -> tuple[int, int, bool]:
    """``(threads, csize, use_smem)`` of a launch of the variant or the
    collapse kernel: the state is split over ``csize`` CTAs (2 at n = 15,
    else 1), held in shared memory up to n = 15 (``use_smem``); a CTA has
    8 amplitudes of its share a thread (at least 32 threads, at most 512:
    32 amplitudes a thread at n = 14 and 15, all in the collapse kernel's
    register checkpoint), so narrow states leave registers for more CTAs
    an SM."""
    csize = 2 if n == CLUSTER_QUBITS else 1
    threads = min(512, max(32, ((1 << n) // csize) // 8))
    return threads, csize, n <= CLUSTER_QUBITS


def run_heads(stage: torch.Tensor, n_seg: int, cap: int) -> torch.Tensor:
    """``[C]`` bool: the labels that open a run of the kernel, from the
    stages of a chunk in its launch order (on its device, no host wait).
    A label group (labels that share every slot digit but the chain's
    last) starts where the stage is below ``n_seg - 1``, or is 0.  A run
    opens at row 0 and at every stage 0 (a full replay either way), at
    the first group starting in each new span of ``cap`` rows, and every
    ``cap`` rows inside a longer group."""
    c = stage.shape[0]
    idx = torch.arange(c, device=stage.device)
    group = stage < max(n_seg - 1, 1)
    group[0] = True
    head = torch.cummax(torch.where(group, idx, torch.zeros_like(idx)),
                        dim=0).values
    prev = torch.cat([head[:1], head[:-1]])   # the group before row i's
    return ((idx == 0) | (stage == 0) | (group & (idx // cap != prev // cap))
            | (~group & ((idx - head) % cap == 0)))


def run_table(stage: torch.Tensor, n_seg: int, cap: int):
    """The kernel's run table, built on the device with no wait for it:
    ``(table [C, 2] int32, count [1] int32)``.  The first ``count`` rows
    hold the runs of :func:`run_heads` in order, first label and length;
    the rest are empty runs."""
    c = stage.shape[0]
    dev = stage.device
    new = run_heads(stage, n_seg, cap)
    rid = torch.cumsum(new, dim=0) - 1
    idx = torch.arange(c, device=dev)
    # run r's first row at starts[r]; rows that open no run land past the
    # end, and starts[R] keeps its fill c, the end of the last run
    starts = torch.full((c + 2,), c, dtype=torch.int64, device=dev)
    starts.scatter_(0, torch.where(new, rid, c + 1), idx)
    starts = starts[:c + 1]
    table = torch.stack([starts[:-1], starts[1:] - starts[:-1]], dim=1)
    return table.to(torch.int32).contiguous(), (rid[-1:] + 1).to(torch.int32)


_CAPACITY: dict = {}
_SMEM_TABLES = 200 * 1024  # dynamic shared memory a CTA may fill with the
                           # state and the staged tables (of 227 KB)


def _capacity(lib, threads: int, smem: int, csize: int) -> int:
    key = (torch.cuda.current_device(), threads, smem, csize)
    if key not in _CAPACITY:
        _CAPACITY[key] = lib.variant_kernel_capacity(threads, smem, csize)
    return _CAPACITY[key]


def _launch(dp: DevicePlan, entries, wstack, stage, cap, key=None):
    lib = LIBRARY.load()
    plan = dp.plan
    dev = entries.device
    c = entries.shape[0]
    n_w = wstack.shape[1]
    n_wbits = len(plan.fold[0]) if plan.fold is not None else 0
    check_tensor(entries, "entries", torch.float32,
                 (c, max(1, plan.entry_stride)), dev)
    check_tensor(wstack, "wstack", torch.float32, (c, n_w, 2), dev)
    if key is None:
        check_tensor(stage, "stage", torch.int32, (c,), dev)
    else:
        check_tensor(key, "key", torch.int64, (c,), dev)
    for name in ("prefix", "rows", "pool", "seg_start", "wbits"):
        if getattr(dp, name).device != dev:
            raise ValueError(f"plan table {name} is not on {dev}")
    if c < 1:
        raise ValueError("an empty label chunk")
    if n_wbits > lib.variant_kernel_max_weights() or n_wbits > n_w:
        raise ValueError(f"{n_wbits} fold weights exceed the kernel's "
                         f"limit or the wstack's {n_w} columns")
    most = lib.variant_kernel_max_schedule()
    if c > most:   # one schedule launch sorts at most this many labels
        return torch.cat([
            _launch(dp, entries[a:a + most], wstack[a:a + most],
                    None if stage is None else stage[a:a + most], cap,
                    None if key is None else key[a:a + most])
            for a in range(0, c, most)])
    threads, csize, use_smem = launch_geometry(plan.n)
    big = 1 << plan.n
    smem = (8 * big) // csize if use_smem else 0
    # the row table and the pool beside the state, where they fit
    n_rows, pool_len = len(plan.table.rows), plan.table.pool.size
    tables = 4 * (pool_len + op_rewrite.ROW * n_rows)
    stage_tables = smem + tables <= _SMEM_TABLES
    smem += tables if stage_tables else 0
    capacity = _capacity(lib, threads, smem, csize)
    if capacity < 1:
        raise RuntimeError(f"the variant kernel cannot run at n = {plan.n} "
                           f"({threads} threads, {smem} B of shared memory)")
    n_seg = len(plan.row_segments)
    # runs no longer than the chunk spread over every CTA (or cluster)
    # the card holds, and no shorter than a natural group (the last
    # slot's variants): a cut inside a group costs a full replay
    group = len(plan.entry_tables[-1]) if plan.entry_tables else 1
    cap = cap or max(group, -(-c // capacity))
    # order, stage, runs [C, 2] and count in one buffer
    sched = torch.empty((4 * c + 1,), dtype=torch.int32, device=dev)
    order, runs, count = sched[:c], sched[2 * c:4 * c], sched[4 * c:]
    if key is not None:
        stage = sched[c:2 * c]
    rc = lib.variant_schedule_launch(
        0 if key is None else key.data_ptr(),
        0 if key is None else dp.key_strides.data_ptr(),
        len(plan.entry_gids), stage.data_ptr() if key is None else 0, c,
        n_seg, cap, order.data_ptr(), stage.data_ptr(), runs.data_ptr(),
        count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            "variant schedule launch failed: " + LIBRARY.error_text(rc))
    grid = min(c, capacity) * csize
    # every segment's start but the first (the prefix), and on the
    # global path the working state
    n_slots = max(0, n_seg - 1) if use_smem else max(1, n_seg)
    scratch = torch.empty((max(1, grid * n_slots * 2 * (big // csize)),),
                          dtype=torch.float32, device=dev)
    out = torch.empty((c, plan.out_width), dtype=torch.float32, device=dev)
    wbits, zmask, d = plan.fold if plan.fold is not None else ([], 0, 0)
    rc = lib.variant_rows_launch(
        dp.prefix.data_ptr(), dp.rows.data_ptr(), dp.pool.data_ptr(),
        dp.seg_start.data_ptr(), entries.data_ptr(), stage.data_ptr(),
        wstack.data_ptr(), dp.wbits.data_ptr(),
        0 if key is None else order.data_ptr(), runs.data_ptr(),
        count.data_ptr(), scratch.data_ptr(), out.data_ptr(), plan.n, d,
        int(plan.fold is not None), c, n_seg, plan.entry_stride, n_w,
        n_wbits, zmask, csize, int(use_smem), n_slots, n_rows, pool_len,
        int(stage_tables), grid, threads,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "variant kernel launch failed: " + LIBRARY.error_text(rc)
        )
    variant_rows.launches += 1
    variant_rows.last_launch = {
        "runs": count, "cap": cap, "grid": grid, "threads": threads,
        "cluster": csize, "scratch_bytes": 4 * scratch.numel(),
        "tables_on_chip": stage_tables,
        "order": order if key is not None else None, "stage": stage,
        "table": runs.view(c, 2),
    }
    return out


def variant_rows(dp: DevicePlan, entries, wstack, stage,
                 cap: int | None = None) -> torch.Tensor:
    """Rows ``[C, out_width]`` for a chunk of labels, in the order given.
    CUDA tensors launch the hand-written kernel: its schedule launch cuts
    the runs (:func:`run_table` is its plain version), its rows launch
    computes the rows (counted in ``variant_rows.launches``;
    ``variant_rows.last_launch`` says runs, cap, grid, cluster, scratch
    bytes and holds the schedule's tensors); CPU tensors run
    :func:`plain_variant_rows`.  ``entries [C, entry_stride]`` (from
    :meth:`DevicePlan.gather_entries`), ``wstack [C, n_w, 2]`` f32,
    ``stage [C]`` int32 (:meth:`DevicePlan.stages` of the same order: the
    kernel's resume schedule).  ``cap`` overrides the longest run in
    labels (default: the chunk spread over the CTAs the card holds, at
    least the last slot's variants)."""
    if entries.is_cuda:
        return _launch(dp, entries, wstack, stage, cap)
    if entries.device.type != "cpu":
        raise ValueError(f"unsupported device {entries.device}")
    return plain_variant_rows(dp, entries, wstack)


variant_rows.launches = 0
variant_rows.last_launch = None


def label_rows(dp: DevicePlan, vidx_chunk, weigh) -> torch.Tensor:
    """Rows ``[C, out_width]`` of a ``[C, num_vgates]`` chunk of labels in
    the chunk's order, the call the row functions make.  The labels run
    sorted by their slot digits in chain order (:meth:`DevicePlan.order`),
    with the stages of that order, so any order gets a natural chunk's
    staging; the rows do not depend on the order.  On CUDA tensors the
    kernel's schedule launch sorts them (by :meth:`DevicePlan.sort_key`)
    and the rows kernel reads each label's entries and weights
    (``weigh(vidx) -> wstack [C, n_w, 2]``) and writes its row where the
    label sits; on CPU tensors the plain version runs on the chunk as
    given."""
    entries, wstack = dp.gather_entries(vidx_chunk), weigh(vidx_chunk)
    key = dp.sort_key(vidx_chunk)
    if entries.is_cuda and key is not None:
        return _launch(dp, entries, wstack, None, None, key)
    return variant_rows(dp, entries, wstack, dp.stages(vidx_chunk))


# ---------------------------------------------------------------------------
# Streamed-engine integration points (the JAX make_*_chunk_kernel)
# ---------------------------------------------------------------------------

def make_folded_chunk_kernel(
    virt: VirtualCircuit, frag_name: str, chunk: int, keep_clbits=None,
    z_clbits=None, staged: bool = True, device=None,
):
    """``(rows_fn, kept_positions)``: ``rows_fn(vidx_chunk)`` maps a
    ``[chunk, num_vgates]`` block of per-label variant indices (global
    vgate columns, on ``device``) to FOLDED rows ``[chunk, 2^len(kept)]``:
    per touching vgate the measure clbit (num_clbits + g, when written
    here) folds with ``fold_weights[ti][v] = (w0, w1)``, non-measuring
    owners multiply by w0, ``keep_clbits`` drops data bits outside the
    set, ``z_clbits`` contracts every data bit ((+1, -1) on the support,
    summed elsewhere; kept is then []).  Output bit j carries
    ``kept_positions[j]`` (little-endian, ascending).  ``rows_fn.plan`` is
    the :class:`DevicePlan`.  Returns None past the kernel's width gate
    (``MAX_QUBITS``), where the blocked kernel takes over."""
    from .knit import fold_weights

    dev = resolve_device(device)
    prog = virt.programs[frag_name]
    if prog.num_sim_qubits > MAX_QUBITS:
        return None
    positions = sorted(prog.clbit_sources)
    frag_weights = fold_weights(virt, frag_name)
    w_entries = []
    w_tabs = []
    for ti, g in enumerate(prog.touching):
        cg = virt.num_clbits + g
        w_entries.append((cg if cg in positions else None, ti))
        w_tabs.append(np.asarray(frag_weights[ti], np.float32))
    data_pos = [p for p in positions if p < virt.num_clbits]
    z_list: list[int] = []
    if z_clbits is not None:
        z_list = [p for p in data_pos if p in set(z_clbits)]
        kept: list[int] = []
    elif keep_clbits is not None:
        kept = [p for p in data_pos if p in set(keep_clbits)]
    else:
        kept = list(data_pos)
    plan = build_plan(
        virt, frag_name,
        fold={"w": w_entries, "z": z_list, "keep": kept}, staged=staged,
    )
    dp = DevicePlan(plan, dev)
    w_rows = SlotEntries(w_tabs, list(prog.touching), dev)

    def weigh(vidx):
        if w_tabs:
            return w_rows(vidx).view(vidx.shape[0], len(w_tabs), 2)
        return torch.ones((vidx.shape[0], 1, 2), dtype=torch.float32,
                          device=dev)

    def rows_fn(vidx_chunk):
        return label_rows(dp, vidx_chunk, weigh)

    rows_fn.plan = dp
    rows_fn.weigh = weigh
    return rows_fn, kept


def make_chunk_kernel(
    virt: VirtualCircuit, frag_name: str, chunk: int, staged: bool = True,
    device=None,
):
    """``(rows_fn, positions)``: ``rows_fn(vidx_chunk)`` maps a ``[chunk,
    num_vgates]`` label block to full-width kernel rows marginalised onto
    the written clbits, ``[chunk, 2^len(positions)]`` (the JAX
    ``make_chunk_kernel`` row contract).  ``rows_fn.plan`` is the
    :class:`DevicePlan`.  Returns None past the kernel's width gate."""
    dev = resolve_device(device)
    if virt.programs[frag_name].num_sim_qubits > MAX_QUBITS:
        return None
    plan = build_plan(virt, frag_name, staged=staged)
    dp = DevicePlan(plan, dev)
    prog = virt.programs[frag_name]
    positions = sorted(prog.clbit_sources)
    sources = [prog.clbit_sources[c] for c in positions]

    def ones(vidx):
        return torch.ones((vidx.shape[0], 1, 2), dtype=torch.float32,
                          device=dev)

    def rows_fn(vidx_chunk):
        return marginalize_flat(label_rows(dp, vidx_chunk, ones), plan.n,
                                sources)

    rows_fn.plan = dp
    rows_fn.weigh = ones
    return rows_fn, positions


# ---------------------------------------------------------------------------
# Work counts for the roofline bound (bytes and f32 operations)
# ---------------------------------------------------------------------------

def effective_stages(stage: np.ndarray, n_seg: int, cap: int) -> np.ndarray:
    """The stages the CUDA kernel runs for a chunk in its launch order:
    the given ones, with the first label of every run (:func:`run_heads`)
    forced to 0 (the function itself needs a full replay only at row 0,
    where the stage array already says 0)."""
    s = np.asarray(stage, np.int64).copy()
    s[run_heads(torch.as_tensor(s), n_seg, cap).numpy()] = 0
    return s


def work_counts(plan: VariantPlan, stage: np.ndarray, n_w: int,
                entries=None) -> dict:
    """Work of one chunk replayed from these stages (data-dependent: only
    the replayed segments count).  The function's own stage array
    (:meth:`DevicePlan.stages` of the sorted chunk, :meth:`DevicePlan.order`)
    gives the roofline work; :func:`effective_stages` gives what the CUDA
    kernel's runs replay.

    ``bytes``/``flops`` define the roofline bound: the bytes the function
    must move (each input read once, each output written once) and the
    f32 operations it performs: each gate of the original table what its
    matrix needs (:func:`op_costs`; a slot gate from the label's own row
    of ``entries [C, entry_stride]``, dense without it), ``|psi|^2`` 3
    and the fold another ``n_wbits + 2``.  ``passes`` counts the passes
    over the state the kernel makes (rows of the rewritten table),
    ``passes_before`` those the original table would make on the same
    stages; ``pass_bytes`` is the state traffic the kernel's design adds:
    each pass reads and writes the ``[2, 2^n]`` f32 state once, the
    epilogue reads it once."""
    c = len(stage)
    big = 1 << plan.n
    n_ops = len(plan.ops)
    cost = op_costs(plan.ops, plan.fixed, plan.n, entries)
    tail = np.concatenate([np.cumsum(cost[:, ::-1], axis=1)[:, ::-1],
                           np.zeros((len(cost), 1), np.int64)], axis=1)
    stage = np.minimum(np.asarray(stage, np.int64), len(plan.segments))
    starts = np.asarray([a for a, _ in plan.segments] + [n_ops], np.int64)
    at = starts[stage]
    rows = np.arange(c) if len(cost) == c else np.zeros(c, np.int64)
    gate_flops = int(tail[rows, at].sum())
    k_rows = len(plan.table.rows)
    k_starts = np.asarray([a for a, _ in plan.row_segments] + [k_rows],
                          np.int64)
    passes = int((k_rows - k_starts[stage]).sum())
    epi = (3 + len(plan.fold[0]) + 2 if plan.fold is not None else 3) * big
    nbytes = 4 * (
        plan.prefix.size + plan.ops.size + plan.fixed.size
        + c * max(1, plan.entry_stride) + c + c * n_w * 2
        + c * plan.out_width
    )
    return {"bytes": int(nbytes), "flops": int(gate_flops + c * epi),
            "passes": passes, "passes_before": int((n_ops - at).sum()),
            "pass_bytes": int(passes * big * 16 + c * big * 8)}
