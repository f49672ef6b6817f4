"""Gate fusion: collapse adjacent gates into single matrices.

Every gate application on an n-qubit state streams the whole [2, 2^n]
tensor through HBM, so op count is the direct cost driver of the exact
engines.  This pass merges, order-preservingly:

  * runs of 1q gates on the same qubit -> one 2x2;
  * 1q gates into the next/previous 2q gate touching that qubit;
  * consecutive 2q gates on the same qubit pair (either orientation)
    -> one 4x4.

Typical benchmark circuits (supremacy/sycamore layers of 1q gates
between couplers) shrink 2-3x.  Used on the exact paths only: the
trajectory noise engine needs per-physical-gate sites, so it keeps the
unfused stream.

Convention (ops/statevector.apply_matrix): ``axes[0]`` is the most
significant bit of the matrix index.

``xp=torch`` runs the same passes on complex64 tensors (the
differentiable sweep, ops/sweep.py: blocks holding a parameterised gate
are rebuilt from theta and carry its gradient).  Every matrix handed in
is then a tensor on one device; the identities the passes add are made
on that device.
"""
from __future__ import annotations

import numpy as np
import torch

_I2 = np.eye(2, dtype=complex)


def _eye(n: int, like, xp=np):
    """The ``n x n`` identity in ``like``'s backend (and device)."""
    if xp is torch:
        return torch.eye(n, dtype=like.dtype, device=like.device)
    return np.eye(n, dtype=complex)


def _swap_operands(u4):
    """Reorder a 4x4 matrix from qubit order (a, b) to (b, a)."""
    perm = [0, 2, 1, 3]
    return u4[perm][:, perm]


def _kron2(ua, ub, xp=np):
    """4x4 acting as ua on the first (most significant) operand, ub on
    the second (a 2x2 numpy identity becomes one of the other operand's
    backend)."""
    if xp is torch:
        if not isinstance(ua, torch.Tensor):
            ua = _eye(2, ub, xp)
        if not isinstance(ub, torch.Tensor):
            ub = _eye(2, ua, xp)
    return xp.kron(ua, ub)


class _OwnerMapFuser:
    """Shared owner-map bookkeeping for the pairwise and block fusers:
    ``pending`` rows are [matrix, axes, alive], ``owner`` maps qubit ->
    pending row index; ``_flush`` retires one row into ``out`` preserving
    operator order, ``passthrough`` flushes everything then emits an op
    unfused (the too-many-qubits escape).

    ``xp`` selects the array backend: numpy (the host compile path) or
    torch (complex64 tensors that may carry gradients); the fusion
    *structure* depends only on op axes.
    """

    def __init__(self, xp=np):
        self.xp = xp
        self.out: list[tuple] = []
        # qubit -> pending op index in self.pending
        self.owner: dict[int, int] = {}
        self.pending: list = []  # [matrix, axes, alive]

    def _as(self, mat):
        if self.xp is np:
            return np.asarray(mat, dtype=complex)
        return mat.to(torch.complex64)

    def _flush(self, idx: int) -> None:
        mat, axes, alive = self.pending[idx]
        if not alive:
            return
        self.pending[idx][2] = False
        for q in axes:
            if self.owner.get(q) == idx:
                del self.owner[q]
        self.out.append((self._as(mat), tuple(axes)))

    def passthrough(self, mat, axes) -> None:
        for idx in range(len(self.pending)):
            self._flush(idx)
        self.out.append((self._as(mat), tuple(axes)))

    def finish(self) -> list[tuple]:
        for idx in range(len(self.pending)):
            self._flush(idx)
        return self.out


class _Fuser(_OwnerMapFuser):
    def _flush_qubit(self, q: int) -> None:
        if q in self.owner:
            self._flush(self.owner[q])

    def _start(self, mat, axes: tuple[int, ...]) -> None:
        idx = len(self.pending)
        self.pending.append([self._as(mat), axes, True])
        for q in axes:
            self.owner[q] = idx

    def add(self, mat, axes: tuple[int, ...]) -> None:
        mat = self._as(mat)
        if len(axes) == 1:
            q = axes[0]
            idx = self.owner.get(q)
            if idx is None:
                self._start(mat, axes)
                return
            pmat, paxes, _ = self.pending[idx]
            if len(paxes) == 1:
                self.pending[idx][0] = mat @ pmat
            else:  # absorb into the pending 2q
                a, b = paxes
                lift = (
                    _kron2(mat, _I2, self.xp) if q == a
                    else _kron2(_I2, mat, self.xp)
                )
                self.pending[idx][0] = lift @ pmat
            return

        a, b = axes
        ia, ib = self.owner.get(a), self.owner.get(b)
        if ia is not None and ia == ib:
            pmat, paxes, _ = self.pending[ia]
            if len(paxes) == 2:  # same pair: compose
                if tuple(paxes) == (b, a):
                    mat = _swap_operands(mat)
                    a, b = paxes
                self.pending[ia][0] = mat @ pmat
                return
        # absorb pending 1q gates on a/b; flush pending 2q conflicts
        for q in (a, b):
            idx = self.owner.get(q)
            if idx is None:
                continue
            pmat, paxes, _ = self.pending[idx]
            if len(paxes) == 1:
                lift = (
                    _kron2(pmat, _I2, self.xp) if q == a
                    else _kron2(_I2, pmat, self.xp)
                )
                mat = mat @ lift
                self.pending[idx][2] = False
                del self.owner[q]
            else:
                self._flush(idx)
        self._start(mat, (a, b))


def fused_stream(
    prog_ops: list, max_qubits: int = 2, xp=np,
) -> tuple[list, list]:
    """Fuse a FragmentProgram-style op stream (fixed "u"/"u_aux" entries
    interleaved with slot ops).  Fixed-gate runs between slots fuse;
    slot ops pass through as structural entries.

    ``max_qubits`` > 2 additionally merges ops into k-qubit blocks
    (:func:`fuse_blocks`) — used by engines whose ``apply_matrix``
    supports 3q blocks; the sharded/Pallas paths stay at 2.

    Returns (skeleton, mats): skeleton entries are ("u", axes) for fused
    fixed gates (matrix in ``mats``, aligned by order of appearance) or
    the original slot tuples; the skeleton alone is the structural key
    used by the parameter-sweep binder.
    """
    skeleton: list = []
    mats: list = []
    run: list = []

    def flush():
        fused = (
            fuse_blocks(run, max_qubits, xp) if max_qubits > 2
            else fuse_ops(run, xp)
        )
        for m, ax in fused:
            skeleton.append(("u", tuple(ax)))
            mats.append(m)
        run.clear()

    for op in prog_ops:
        if op[0] in ("u", "u_aux"):
            run.append((op[1], op[2]))
        else:
            flush()
            skeleton.append(op)
    flush()
    return skeleton, mats


def fuse_ops(
    ops: list, xp=np,
) -> list:
    """Fuse a (matrix, axes) op list; 3q+ ops flush everything and pass
    through unfused."""
    fuser = _Fuser(xp)
    for mat, axes in ops:
        if len(axes) > 2:
            fuser.passthrough(mat, axes)
            continue
        fuser.add(mat, axes)
    return fuser.finish()


# ---------------------------------------------------------------------------
# Second pass: k-qubit block fusion (k <= 3)
# ---------------------------------------------------------------------------

def _expand(mat, axes: tuple[int, ...],
            target: tuple[int, ...], xp=np):
    """Lift ``mat`` on ``axes`` to a 2^len(target) matrix on ``target``
    (qubit order = target; axes must be a subset)."""
    k = len(target)
    rest = [q for q in target if q not in axes]
    m = xp.kron(mat, _eye(1 << len(rest), mat, xp))
    cur = list(axes) + rest
    perm = [cur.index(q) for q in target]
    t = m.reshape((2,) * k + (2,) * k)
    t = t.permute(perm + [k + p for p in perm]) if xp is torch \
        else np.transpose(t, perm + [k + p for p in perm])
    return t.reshape(1 << k, 1 << k)


class _BlockFuser(_OwnerMapFuser):
    """Greedy owner-map fuser over already-2q-fused ops: merges an op into
    a pending disjoint block when their qubit union stays <= max_qubits.
    Pending blocks are mutually disjoint (hence commuting), so flushing
    conflicting blocks before a merge preserves operator order."""

    def __init__(self, max_qubits: int, xp=np):
        super().__init__(xp)
        self.max_q = max_qubits

    def add(self, mat, axes: tuple[int, ...]) -> None:
        overlapping = sorted(
            {self.owner[q] for q in axes if q in self.owner}
        )
        best = None
        for idx in overlapping:
            union = list(self.pending[idx][1]) + [
                q for q in axes if q not in self.pending[idx][1]
            ]
            if len(union) <= self.max_q and (
                best is None or len(union) < len(best[1])
            ):
                best = (idx, union)
        for idx in overlapping:
            if best is None or idx != best[0]:
                self._flush(idx)
        if best is None:
            idx = len(self.pending)
            self.pending.append([self._as(mat), tuple(axes), True])
            for q in axes:
                self.owner[q] = idx
            return
        idx, union = best
        union = tuple(union)
        pmat, paxes, _ = self.pending[idx]
        self.pending[idx][0] = (
            _expand(mat, axes, union, self.xp)
            @ _expand(pmat, paxes, union, self.xp)
        )
        self.pending[idx][1] = union
        for q in union:
            self.owner[q] = idx


def fuse_blocks(
    ops: list, max_qubits: int = 3, xp=np,
) -> list:
    """Fuse a (matrix, axes) op list into blocks of <= max_qubits qubits.
    Runs the pairwise fuser first (its absorb rules are tighter for 1q),
    then the greedy block pass.  Every merged block replaces >= 2 HBM
    passes with one — the direct lever on the bandwidth-limited engines."""
    base = fuse_ops(ops, xp)
    if max_qubits <= 2:
        return base
    fuser = _BlockFuser(max_qubits, xp)
    for mat, axes in base:
        if len(axes) > max_qubits:
            fuser.passthrough(mat, axes)
            continue
        fuser.add(mat, axes)
    return fuser.finish()
