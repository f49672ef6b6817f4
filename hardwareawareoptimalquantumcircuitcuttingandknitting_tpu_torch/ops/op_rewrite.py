"""The kernels' op tables, built on the host, and their rewrite: the same
function in fewer passes.

The variant, collapse and blocked kernels' wrappers turn a fragment's
fused op stream (:func:`_plan_ops`, split at the first slot) into an op
table over flat bits, an :class:`OpTable`: rows ``(nq, ja, jb, coef)``, the
fixed-coefficient pool and the per-slot entry tables, which
:class:`SlotEntries` gathers into each label's entry row on the device.
:func:`generic_ops` hands such a table to :func:`rewrite`,
:func:`op_costs` counts what each row needs, and :func:`apply_row`
replays a row of either table (an original row's ``nq`` is the code of
``OP_GATE1`` or ``OP_GATE2``).

The collapse kernel (``csrc/collapse_kernel.cu``) and the whole-fragment
kernel (``csrc/sv_kernel.cu``) interpret an op table, one pass over the
state and one barrier per row.  Many rows need no arithmetic at all (an
identity, a CX) or commute and could share a pass (a run of ``cp``
gates).  :func:`rewrite` turns an op list into the table both kernels
interpret:

* a fixed gate equal to the identity (every entry within half an f32 ulp
  of the identity's) is dropped;
* consecutive diagonal fixed gates become one ``OP_DIAG`` row: per
  amplitude, the product of their entries is taken in registers;
* a signed permutation (every row one entry in {+-1, +-i}: ``x``, ``cx``,
  ``swap``, ``cz`` is diagonal) becomes an ``OP_PERM*`` row, a move with
  no multiply;
* a collapse site with its slot's pre and post gate on the same qubit
  becomes two rows: ``OP_SITE_A`` (pre gate and the Born sums) and
  ``OP_SITE_B`` (projection, rescale and post gate).

Rows are ``(kind, ja, jb, a0, a1, a2)`` int32 over flat bits (``ja`` the
gate-index MSB):

========== ===================================================================
kind       meaning
========== ===================================================================
OP_GATE1   1q gate on ``ja``; ``a0 >= 0``: offset in the pool (re[4], im[4]),
           ``a0 < 0``: offset ``-1 - a0`` in the label's entry row
OP_GATE2   2q gate on ``(ja, jb)``, the same with re[16], im[16]
OP_DIAG    ``ja`` diagonal gates from pool offset ``a0``, 10 floats each:
           bits ``(ba, bb)`` then entries re, im of index ``2 bit(ba) +
           bit(bb)`` (a 1q gate has ``bb = ba``: entries 0 and 3)
OP_PERM1   1q signed permutation on ``ja``, code ``a0`` (below)
OP_PERM2   2q signed permutation on ``(ja, jb)``, code ``a0``
OP_SITE_A  collapse site on ``ja``, site index ``jb``, pre / post gate at
           entry offsets ``a0`` / ``a1`` (-1: none)
OP_SITE_B  its second half, the same arguments
OP_SLOT    whole-fragment kernel's slot on ``ja``, slot index ``jb``
========== ===================================================================

A permutation code holds 4 bits per output row ``r`` at ``4 r``: the
source column (2 bits) and the phase (2 bits: 1, i, -1, -i).

:func:`replay` applies a rewritten table to states in plain PyTorch, so a
test can hold it to the original table's replay.  :func:`matvec_ops`
counts what a matrix needs, for the roofline bounds of every kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..convert import to_device
from .fusion import fused_stream
from .statevector import apply_slices
from .variant_engine import _fuse_slot_ops, _slot_tables

OP_GATE1, OP_GATE2, OP_DIAG, OP_PERM1, OP_PERM2 = 1, 2, 3, 4, 5
OP_SITE_A, OP_SITE_B, OP_SLOT = 6, 7, 8
ROW = 6            # ints per row
DIAG_FLOATS = 10   # floats per diagonal gate of an OP_DIAG row
_EPS = 2.0 ** -24  # half an f32 ulp of 1: below it an entry counts as zero
_PHASES = (1, 1j, -1, -1j)


def matvec_ops(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """f32 operations of ``y = M x`` on one group of ``d`` complex
    amplitudes, for matrices ``re + i im`` of shape ``[..., d, d]``: per
    row, a product with an entry that has both components costs 6, with a
    real or imaginary one 2, with ``+-1`` or ``+-i`` nothing, and each
    term after the first 2 for the complex add.  A component below half
    an f32 ulp of 1 counts as zero.  An identity or a signed permutation
    so costs nothing, a dense complex 1q / 2q matrix 28 / 120 (14 / 30 an
    amplitude), a ``cp`` 6 (its one complex entry)."""
    r, i = np.abs(re) >= _EPS, np.abs(im) >= _EPS
    unit = (r ^ i) & (np.abs(re) + np.abs(im) == 1)
    mul = np.where(unit, 0, 2 * (r | i) + 4 * (r & i))
    adds = 2 * np.maximum((r | i).sum(-1) - 1, 0)
    return (mul.sum(-1) + adds).sum(-1)


def classify(mat) -> str:
    """``"identity"``, ``"diagonal"``, ``"permutation"`` (a signed one:
    one entry of ``{+-1, +-i}`` per row and column, the rest zero) or
    ``"dense"``; entries within half an f32 ulp count as exact."""
    mat = np.asarray(mat, complex)
    d = mat.shape[0]
    nz = np.abs(mat) >= _EPS
    off = nz & ~np.eye(d, dtype=bool)
    if not off.any():
        if np.all(np.abs(np.diag(mat) - 1) < _EPS):
            return "identity"
        return "diagonal"
    if (nz.sum(0) == 1).all() and (nz.sum(1) == 1).all():
        vals = mat[nz]
        if all(min(abs(v - p) for p in _PHASES) < _EPS for v in vals):
            return "permutation"
    return "dense"


def perm_code(mat) -> int:
    """The code of a signed permutation matrix (see the module doc)."""
    mat = np.asarray(mat, complex)
    code = 0
    for r in range(mat.shape[0]):
        c = int(np.argmax(np.abs(mat[r])))
        p = int(np.argmin([abs(mat[r, c] - q) for q in _PHASES]))
        code |= (c | (p << 2)) << (4 * r)
    return code


def perm_matrix(code: int, d: int) -> np.ndarray:
    """The signed permutation matrix a code stands for."""
    mat = np.zeros((d, d), complex)
    for r in range(d):
        nib = (code >> (4 * r)) & 15
        mat[r, nib & 3] = _PHASES[nib >> 2]
    return mat


@dataclass
class Table:
    """A rewritten op table: ``rows [R, ROW]`` int32 and the float32
    coefficient ``pool`` its rows point into."""

    rows: np.ndarray
    pool: np.ndarray

    @property
    def kinds(self) -> list:
        return self.rows[:, 0].tolist() if len(self.rows) else []


def rewrite(ops) -> Table:
    """Rewrite an op list over flat bits into a :class:`Table`.  Entries:
    ``("u", complex matrix, js)`` a fixed gate; ``("e", js, off)`` a gate
    with the label's own coefficients at ``off`` of its entry row;
    ``("site", j, index)`` a collapse site; ``("slot", j, index)`` a
    whole-fragment slot."""
    rows: list = []
    pool: list = []
    diag: list = []   # pending diagonal gates: (ja, jb, 4 complex entries)

    def flush():
        if not diag:
            return
        rows.append((OP_DIAG, len(diag), 0, len(pool), 0, 0))
        for ja, jb, ent in diag:
            pool.extend([ja, jb])
            for v in ent:
                pool.extend([v.real, v.imag])
        diag.clear()

    i = 0
    while i < len(ops):
        op = ops[i]
        kind = op[0]
        if kind == "u":
            mat = np.asarray(op[1], complex)
            js = list(op[2])
            cls = classify(mat)
            i += 1
            if cls == "identity":
                continue
            if cls == "diagonal":
                d = np.diag(mat)
                if len(js) == 1:
                    diag.append((js[0], js[0], (d[0], 0, 0, d[1])))
                else:
                    diag.append((js[0], js[1], tuple(d)))
                continue
            flush()
            jb = js[1] if len(js) == 2 else 0
            if cls == "permutation":
                rows.append((OP_PERM1 if len(js) == 1 else OP_PERM2, js[0],
                             jb, perm_code(mat), 0, 0))
                continue
            rows.append((len(js), js[0], jb, len(pool), 0, 0))
            pool.extend(mat.real.ravel())
            pool.extend(mat.imag.ravel())
            continue
        flush()
        if kind == "e":
            js, off = list(op[1]), op[2]
            nxt = ops[i + 1] if i + 1 < len(ops) else None
            after = ops[i + 2] if i + 2 < len(ops) else None
            if (len(js) == 1 and nxt is not None and nxt[0] == "site"
                    and nxt[1] == js[0] and after is not None
                    and after[0] == "e" and list(after[1]) == js):
                # pre gate, site, post gate on one qubit: two passes
                for half in (OP_SITE_A, OP_SITE_B):
                    rows.append((half, js[0], nxt[2], off, after[2], 0))
                i += 3
                continue
            rows.append((len(js), js[0], js[1] if len(js) == 2 else 0,
                         -1 - off, 0, 0))
        elif kind == "site":
            for half in (OP_SITE_A, OP_SITE_B):
                rows.append((half, op[1], op[2], -1, -1, 0))
        elif kind == "slot":
            rows.append((OP_SLOT, op[1], op[2], 0, 0, 0))
        else:
            raise ValueError(f"unknown op {kind!r}")
        i += 1
    flush()
    return Table(np.asarray(rows, np.int32).reshape(-1, ROW),
                 np.asarray(pool, np.float32))


# ---------------------------------------------------------------------------
# Plain replay of a rewritten table
# ---------------------------------------------------------------------------

def _gate(st, js, n, ur, ui):
    return apply_slices(st, ur, ui, tuple(n - 1 - j for j in js), n)


def _diag_phase(pool: np.ndarray, start: int, count: int, n: int, device):
    """``(re, im)`` ``[2^n]`` f32 tensors: per amplitude, the product of
    the run's diagonal entries, multiplied in the run's order as the
    kernel does."""
    f = torch.arange(1 << n, device=device)
    pr = torch.ones(1 << n, dtype=torch.float32, device=device)
    pi = torch.zeros(1 << n, dtype=torch.float32, device=device)
    for e in range(count):
        blk = pool[start + DIAG_FLOATS * e:start + DIAG_FLOATS * (e + 1)]
        ja, jb = int(blk[0]), int(blk[1])
        m = 2 * ((f >> ja) & 1) + ((f >> jb) & 1)
        er = torch.as_tensor(blk[2::2].copy(), device=device)[m]
        ei = torch.as_tensor(blk[3::2].copy(), device=device)[m]
        pr, pi = pr * er - pi * ei, pr * ei + pi * er
    return pr, pi


def apply_row(st, row, n: int, pool: np.ndarray, entries=None):
    """One row of kinds ``OP_GATE*``, ``OP_DIAG`` or ``OP_PERM*`` applied
    to ``st [B, 2, 2^n]``; an :class:`OpTable` gate row ``(nq, ja, jb,
    coef)`` is an ``OP_GATE*`` row of the same meaning, read from the
    ``fixed`` pool given as ``pool``."""
    kind, ja, jb, a0 = (int(v) for v in row[:4])
    if kind in (OP_GATE1, OP_GATE2):
        m = 1 << kind
        js = (ja, jb)[:kind]
        if a0 >= 0:
            blk = pool[a0:a0 + 2 * m * m]
            return _gate(st, js, n, lambda r, c: float(blk[r * m + c]),
                         lambda r, c: float(blk[m * m + r * m + c]))
        off = -1 - a0
        return _gate(st, js, n, lambda r, c: entries[:, off + r * m + c],
                     lambda r, c: entries[:, off + m * m + r * m + c])
    if kind in (OP_PERM1, OP_PERM2):
        d = 2 if kind == OP_PERM1 else 4
        mat = perm_matrix(a0, d)
        js = (ja,) if kind == OP_PERM1 else (ja, jb)
        return _gate(st, js, n, lambda r, c: float(mat[r, c].real),
                     lambda r, c: float(mat[r, c].imag))
    if kind == OP_DIAG:
        pr, pi = _diag_phase(pool, a0, ja, n, st.device)
        re, im = st[:, 0], st[:, 1]
        return torch.stack([re * pr - im * pi, re * pi + im * pr], dim=1)
    raise ValueError(f"row kind {kind} needs its kernel's own replay")


def replay(st, table: Table, n: int, entries=None, special=None):
    """Apply every row of ``table`` to ``st [B, 2, 2^n]``;
    ``special(st, row)`` applies the kernel-specific rows (sites, slots)."""
    for row in table.rows:
        if int(row[0]) >= OP_SITE_A:
            st = special(st, row)
        else:
            st = apply_row(st, row, n, table.pool, entries)
    return st



# ---------------------------------------------------------------------------
# The op table every kernel wrapper builds
# ---------------------------------------------------------------------------

def _plan_ops(virt, frag_name: str):
    """(prefix_ops, suffix_steps, prog) — the fused-slot op stream the JAX
    engines execute, split at the first slot.  Suffix steps:
    ("u", complex mat, axes) | ("slot", slot_id, axes)."""
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


def _to_complex(block: np.ndarray) -> np.ndarray:
    """Real (2, m, 2, m) block -> complex (m, m)."""
    return block[0, :, 0, :] + 1j * block[1, :, 0, :]


def _check_width(js) -> None:
    if len(js) not in (1, 2):
        raise NotImplementedError(
            f"{len(js)}-qubit op in the fused suffix: the kernels "
            "apply 1q and 2q gates only"
        )


class OpTable:
    """Accumulates a kernel's op table: rows ``(nq, ja, jb, coef)`` over
    flat bits (``ja`` = the gate-index MSB), the fixed-coefficient pool
    and the entry tables, one per gate whose matrix each row picks (a
    slot's, by the label's variant; on kernel 1's noisy rows also a noise
    site's, by the trajectory's branch).  ``coef >= 0`` is an offset into
    the pool (re ``[m*m]`` then im ``[m*m]``), ``coef < 0`` is ``-1 -
    offset`` into the row's entry row (the concatenated ``[2, m, m]``
    entries).  A row with ``nq == 0`` is a collapse site on flat
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
        self.entry_tables: list = []   # per entry gate [nI, 2*m*m] float32
        self.entry_gids: list = []     # per entry gate: its index column
        self.entry_stride = 0          # floats per label entry row
        self.slot_rows: list = []      # op rows that read the entry row

    def _slot_table(self, sid: int, kind: str) -> np.ndarray:
        """``[nI, 2, m, 2, m]`` real blocks of one slot op: the composed
        block (``"slot"``) or the unfused pre / measure / post endpoint
        gate."""
        fused = kind == "slot"
        if fused not in self._tabs:
            self._tabs[fused] = _slot_tables(self._prog, self._specs,
                                             fused=fused)
        return self._tabs[fused][sid][{"slot": 0, "slot_pre": 0,
                                       "slot_meas": 1,
                                       "slot_post": 2}[kind]]

    def add(self, op, js) -> None:
        """Append ``("u", complex mat, axes)``, ``("slot" | "slot_pre" |
        "slot_meas" | "slot_post", slot_id, axes)`` or ``("collapse",
        slot_id, axes)`` acting on flat bits ``js``."""
        if op[0] == "collapse":
            self.ops.append((0, js[0], len(self.sites), 0))
            self.sites.append(op[1])
            return
        if op[0] != "u":
            self.add_entries(self._slot_table(op[1], op[0]),
                             self._prog.slots[op[1]].vgate_idx, js)
            return
        _check_width(js)
        mat = np.asarray(op[1], complex)
        coef = len(self.fixed)
        self.fixed.extend(mat.real.astype(np.float32).ravel())
        self.fixed.extend(mat.imag.astype(np.float32).ravel())
        self.ops.append((len(js), js[0], js[1] if len(js) == 2 else 0, coef))

    def add_entries(self, blocks, gid: int, js) -> None:
        """Append a gate on flat bits ``js`` whose matrix each row picks
        from ``blocks`` (``[nI, 2, m, 2, m]`` real blocks) by column
        ``gid`` of its index row: a slot's variants, read by the label's
        global vgate column, or a noise site's branches."""
        _check_width(js)
        self.slot_rows.append(len(self.ops))
        cx = np.stack([_to_complex(t) for t in np.asarray(blocks)])
        ent = np.stack([cx.real, cx.imag], axis=1).astype(np.float32)
        self.entry_tables.append(ent.reshape(ent.shape[0], -1))
        self.entry_gids.append(gid)
        coef = -1 - self.entry_stride
        self.entry_stride += self.entry_tables[-1].shape[1]
        self.ops.append((len(js), js[0], js[1] if len(js) == 2 else 0, coef))

    def ops_array(self) -> np.ndarray:
        return np.asarray(self.ops, np.int32).reshape(-1, 4)

    def fixed_array(self) -> np.ndarray:
        return np.asarray(self.fixed, np.float32)


def generic_ops(ops: np.ndarray, fixed: np.ndarray) -> list:
    """An :class:`OpTable`'s rows as :func:`rewrite` takes them: fixed
    gates from their f32 pool entries, slot gates by their entry offset,
    collapse rows as sites."""
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
    (:func:`matvec_ops`: nothing for an identity or a permutation), a
    slot gate from each label's own entries (as dense without them), a
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
