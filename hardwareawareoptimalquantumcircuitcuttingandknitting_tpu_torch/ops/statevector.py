"""Exact statevector simulation in PyTorch: the uncut-circuit oracle.

Port of the JAX package's ``ops/statevector.py`` (the parts the
``engine="pallas"`` slice needs).  Mid-circuit measurement is handled by
the deferred-measurement principle (a CX onto a fresh ancilla), ``reset``
by swapping with a fresh |0> ancilla, and classically-conditioned X/Z by a
CX/CZ from the bit's holder qubit; the final probability tensor is
marginalised onto the written clbits.

The state is a real float32 tensor ``[2, 2^n]`` (axis 0 = re, im), qubit 0
the most significant bit of the flat amplitude index.  A gate is applied as
a slice combination: every output sub-block is a coefficient-weighted sum
of input sub-blocks (elementwise multiply-adds in f32, no matrix product,
so no TF32 path exists), and host-known zero coefficients are skipped.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..circuit.circuit import Circuit
from ..circuit.gates import CX, CZ, SWAP
from ..convert import resolve_device


def to_real_block(u: np.ndarray) -> np.ndarray:
    """Complex (m, m) matrix -> real (2, m, 2, m) block."""
    u = np.asarray(u)
    ur, ui = np.real(u).astype(np.float32), np.imag(u).astype(np.float32)
    m = u.shape[0]
    block = np.zeros((2, m, 2, m), dtype=np.float32)
    block[0, :, 0, :] = ur
    block[0, :, 1, :] = -ui
    block[1, :, 0, :] = ui
    block[1, :, 1, :] = ur
    return block


def _split_shape(axes, n: int) -> list[int]:
    """Flat 2^n axis split into gap and bit axes: sorted qubit ``qs[i]``
    lands on axis ``2 * i + 1``."""
    shape = []
    prev = -1
    for q in sorted(axes):
        shape += [1 << (q - prev - 1), 2]
        prev = q
    shape.append(1 << (n - 1 - max(axes)))
    return shape


def apply_slices(state: torch.Tensor, ur, ui, axes, n: int) -> torch.Tensor:
    """Apply a k-qubit gate to ``state [B, 2, 2^n]`` (B labels, planar
    re/im).  ``ur(r, c)``/``ui(r, c)`` give the gate's real and imaginary
    entry for gate-local row ``r``, column ``c`` (``axes[0]`` = MSB of the
    gate index) as a Python float (shared by every label; zeros skipped)
    or a ``[B]`` tensor (one coefficient per label)."""
    k = len(axes)
    shape = _split_shape(axes, n)
    b = state.shape[0]
    st = state.reshape((b, 2) + tuple(shape))
    rank = len(shape)
    pos = {q: 2 * i + 1 for i, q in enumerate(sorted(axes))}

    def sub(comp, c):
        idx = [slice(None), comp] + [slice(None)] * rank
        for i, q in enumerate(axes):
            idx[2 + pos[q]] = (c >> (k - 1 - i)) & 1
        return st[tuple(idx)]

    def coef(v):
        if isinstance(v, torch.Tensor):
            return v.reshape((b,) + (1,) * (rank - k))
        return v

    def mac(acc, cval, x):
        if not isinstance(cval, torch.Tensor) and cval == 0.0:
            return acc
        t = x * coef(cval)
        return t if acc is None else acc + t

    outs = {}
    for r in range(1 << k):
        acc_r = acc_i = None
        for c in range(1 << k):
            cr, ci = ur(r, c), ui(r, c)
            xr, xi = sub(0, c), sub(1, c)
            acc_r = mac(mac(acc_r, cr, xr), -ci, xi)
            acc_i = mac(mac(acc_i, cr, xi), ci, xr)
        if acc_r is None:
            acc_r = torch.zeros_like(sub(0, 0))
            acc_i = torch.zeros_like(sub(1, 0))
        outs[r] = (acc_r, acc_i)

    out = torch.empty_like(st)
    for r, (acc_r, acc_i) in outs.items():
        for comp, val in ((0, acc_r), (1, acc_i)):
            idx = [slice(None), comp] + [slice(None)] * rank
            for i, q in enumerate(axes):
                idx[2 + pos[q]] = (r >> (k - 1 - i)) & 1
            out[tuple(idx)] = val
    return out.reshape(b, 2, 1 << n)


def apply_block_einsum(state: torch.Tensor, block, axes,
                       n: int) -> torch.Tensor:
    """Apply a k-qubit real block to ``state [B, 2, 2^n]`` as one einsum
    (the JAX package's route for blocks wider than 3 qubits, where a
    slice combination would cost 4^k multiply-adds).  ``block``: a host
    ``[2, m, 2, m]`` array or a ``[2, m, 2, m]`` tensor shared by every
    label (a runtime block, which may carry a gradient: it is never
    copied per label), or a per-label ``[B, 2, m, 2, m]`` tensor; it is
    cast to the state's dtype.  Exact f32 with TF32 off (PyTorch's
    default)."""
    k = len(axes)
    b = state.shape[0]
    per_label = isinstance(block, torch.Tensor) and block.dim() == 5
    blk = torch.as_tensor(block).to(device=state.device, dtype=state.dtype)
    blk = blk.reshape(((b,) if per_label else ()) + (2,) * (2 * k + 2))
    letters = iter("abcdefghijklmnopqrstuvw")
    outs = [next(letters) for _ in range(k)]
    ins = [next(letters) for _ in range(k)]
    lead = "Z" if per_label else ""
    blk_sub = lead + "x" + "".join(outs) + "y" + "".join(ins)
    st_sub, out_sub = "Zy", "Zx"
    for q in sorted(axes):
        gap = next(letters)
        i = list(axes).index(q)
        st_sub += gap + ins[i]
        out_sub += gap + outs[i]
    gap = next(letters)
    st_sub += gap
    out_sub += gap
    st = state.reshape((b, 2) + tuple(_split_shape(axes, n)))
    out = torch.einsum(f"{blk_sub},{st_sub}->{out_sub}", blk, st)
    return out.reshape(b, 2, 1 << n)


def apply_matrix(state: torch.Tensor, u, axes, n: int | None = None):
    """Apply a host-constant complex (m, m) unitary to a flat real-rep
    state ``[2, 2^n]`` on the given qubit indices (``axes[0]`` = MSB of
    the matrix index, qubit 0 = MSB of the flat amplitude index)."""
    if n is None:
        n = int(math.log2(state.shape[-1]))
    u = np.asarray(u, dtype=np.complex128)
    out = apply_slices(
        state[None],
        lambda r, c: float(u[r, c].real),
        lambda r, c: float(u[r, c].imag),
        tuple(axes), n,
    )
    return out[0]


@dataclass
class CompiledCircuit:
    """Static execution plan for an exact simulation of one circuit."""

    num_sim_qubits: int          # circuit qubits + deferral ancillas
    ops: list                    # (matrix np.ndarray, axes tuple)
    clbit_sources: dict[int, int]  # clbit -> sim-qubit holding its value
    num_clbits: int
    op_names: list | None = None  # per-op source gate name ("_defer" for
                                  # measure-deferral / reset / c_if
                                  # bookkeeping); None after fusion


def compile_circuit(circ: Circuit, fuse: bool = False) -> CompiledCircuit:
    """``fuse=True`` merges adjacent gates (ops/fusion.py) — exact paths
    only; the trajectory noise engine needs the per-gate ops and their
    names (``op_names``: the untranspiled noise binding reads them)."""
    n = circ.num_qubits
    ops: list[tuple[np.ndarray, tuple[int, ...]]] = []
    names: list[str] = []
    clbit_sources: dict[int, int] = {}
    next_anc = n

    # which instruction index is the last op touching each qubit?
    last_touch = [-1] * n
    for idx, ins in enumerate(circ.instructions):
        if ins.name == "barrier":
            continue
        for q in ins.qubits:
            last_touch[q] = idx

    for idx, ins in enumerate(circ.instructions):
        if ins.name == "barrier":
            continue
        if ins.name == "measure":
            (q,), (c,) = ins.qubits, ins.clbits
            if c in clbit_sources:
                raise NotImplementedError(f"clbit {c} measured twice")
            if last_touch[q] == idx:
                clbit_sources[c] = q  # terminal measure: read qubit directly
            else:
                anc = next_anc
                next_anc += 1
                ops.append((CX, (q, anc)))
                names.append("_defer")
                clbit_sources[c] = anc
            continue
        if ins.name == "reset":
            (q,) = ins.qubits
            if last_touch[q] == idx:
                continue  # nothing observes the qubit afterwards
            anc = next_anc
            next_anc += 1
            ops.append((SWAP, (q, anc)))
            names.append("_defer")
            continue
        if ins.condition is not None:
            cbit, val = ins.condition
            if cbit not in clbit_sources:
                raise ValueError(f"condition on unwritten clbit {cbit}")
            src = clbit_sources[cbit]
            if val != 1:
                raise NotImplementedError("only c_if(bit == 1) supported")
            if ins.name == "x":
                ops.append((CX, (src, ins.qubits[0])))
                names.append("_defer")
            elif ins.name == "z":
                ops.append((CZ, (src, ins.qubits[0])))
                names.append("_defer")
            else:
                raise NotImplementedError(f"conditioned {ins.name}")
            continue
        if ins.name == "unitary":
            ops.append((np.asarray(ins.op), tuple(ins.qubits)))
            names.append("unitary")
            continue
        ops.append((ins.matrix(), tuple(ins.qubits)))
        names.append(ins.name)

    if fuse:
        from .fusion import fuse_ops

        ops = fuse_ops(ops)
        return CompiledCircuit(next_anc, ops, clbit_sources, circ.num_clbits)
    return CompiledCircuit(next_anc, ops, clbit_sources, circ.num_clbits,
                           op_names=names)


def run_statevector(compiled: CompiledCircuit, device=None) -> torch.Tensor:
    """Final flat real-rep state ``[2, 2^num_sim_qubits]`` (float32) on
    ``device`` (None = "cuda")."""
    dev = resolve_device(device)
    n = compiled.num_sim_qubits
    state = torch.zeros((2, 1 << n), dtype=torch.float32, device=dev)
    state[0, 0] = 1.0
    for u, axes in compiled.ops:
        state = apply_matrix(state, u, axes, n)
    return state


@dataclass
class Distribution:
    """Dense probability/quasi-probability vector over a subset of clbits.

    ``values[i]`` is the weight of the outcome whose written clbits spell the
    binary expansion of ``i`` with ``bit_positions[j]`` holding bit j (LSB
    first).  Unwritten clbits are implicitly 0, matching the reference where
    fragments leave untouched clbits at 0
    (qvm/virtual_circuit.py:116-131, quasi_distr.py:13-20).
    """

    values: np.ndarray          # [2^k] float32
    bit_positions: list[int]    # global clbit index per local bit (sorted)
    num_clbits: int

    def to_dict(self, tol: float = 0.0) -> dict[int, float]:
        vals = np.asarray(self.values)
        out: dict[int, float] = {}
        for i in np.nonzero(np.abs(vals) > tol)[0]:
            key = 0
            for j, pos in enumerate(self.bit_positions):
                if (int(i) >> j) & 1:
                    key |= 1 << pos
            out[key] = float(vals[i])
        return out


def marginalize_flat(
    probs: torch.Tensor, n: int, keep_axes: list[int],
    memo: dict | None = None,
) -> torch.Tensor:
    """Sum a ``[..., 2^n]`` probability tensor over qubits not in
    ``keep_axes`` via pairwise reductions, then reorder the kept bits so
    ``keep_axes[0]`` is the LSB of the flattened index.  Leading axes
    (labels) are untouched.  ``memo``: as ``bits.permute_bits_flat``
    takes it, for a caller that reorders many blocks the same way."""
    lead = tuple(probs.shape[:-1])
    kept = list(range(n))
    cur = n
    for q in sorted(
        (a for a in range(n) if a not in keep_axes), reverse=True
    ):
        pos = kept.index(q)
        probs = probs.reshape(
            lead + (1 << pos, 2, 1 << (cur - 1 - pos))
        ).sum(dim=len(lead) + 1)
        probs = probs.reshape(lead + (-1,))
        kept.pop(pos)
        cur -= 1
    if kept:
        # flat bits are little-endian over kept *descending* (qubit 0 is
        # the MSB of the amplitude index); reorder so keep_axes[0] is LSB
        from .bits import permute_bits_flat

        probs = permute_bits_flat(
            probs.reshape(lead + (-1,)), list(reversed(kept)),
            list(keep_axes), memo,
        )
    return probs.reshape(lead + (-1,))


def probabilities(
    compiled: CompiledCircuit, state: torch.Tensor | None = None,
    device=None,
) -> Distribution:
    """Exact outcome distribution over written clbits."""
    if state is None:
        state = run_statevector(compiled, device)
    n = compiled.num_sim_qubits
    positions = sorted(compiled.clbit_sources)
    sources = [compiled.clbit_sources[c] for c in positions]
    probs = marginalize_flat((state * state).sum(dim=0), n, sources)
    return Distribution(
        probs.cpu().numpy(), positions, compiled.num_clbits
    )


def simulate_circuit(circ: Circuit, device=None) -> Distribution:
    """Exact end-to-end: compile + run + marginalise on ``device`` (None =
    "cuda").  The uncut-circuit oracle used by the fidelity harness
    (reference: Utilities.py:39-69)."""
    return probabilities(compile_circuit(circ, fuse=True), device=device)


def _kq_operands(b, axes, n: int, state):
    """Setup for the general k-qubit gate einsum (k >= 3) on the host:
    (block, reshaped state, einsum subscript)."""
    import string

    k = len(axes)
    u = b.reshape((2,) + (2,) * k + (2,) + (2,) * k)
    order = sorted(range(k), key=lambda i: axes[i])
    if order != list(range(k)):
        perm = [0] + [1 + p for p in order] + [k + 1] + [
            k + 2 + p for p in order
        ]
        u = np.transpose(u, perm)
    st = state.reshape((2,) + tuple(_split_shape(axes, n)))
    pool = [c for c in string.ascii_letters if c not in ("x", "y")]
    assert 3 * k + 1 <= len(pool), f"fused block too wide for einsum: k={k}"
    outs = pool[:k]
    ins = pool[k:2 * k]
    gaps = pool[2 * k:3 * k + 1]
    u_sub = "x" + "".join(outs) + "y" + "".join(ins)
    st_sub = "y" + "".join(gaps[i] + ins[i] for i in range(k)) + gaps[k]
    out_sub = "x" + "".join(gaps[i] + outs[i] for i in range(k)) + gaps[k]
    return u, st, f"{u_sub},{st_sub}->{out_sub}"


def apply_matrix_host(state: np.ndarray, u, axes, n: int) -> np.ndarray:
    """Host (numpy) gate application on ``[2, 2^n]`` real-rep states (the
    JAX package's ``apply_matrix_host``: same einsum contractions, same
    bit conventions).  Builds the kernel's shared prefix state."""
    b = to_real_block(u) if np.iscomplexobj(u) or u.ndim == 2 else u
    if len(axes) == 1:
        q = axes[0]
        st = state.reshape(2, 1 << q, 2, 1 << (n - 1 - q))
        return np.einsum("xiyj,yajb->xaib", b, st).reshape(2, 1 << n)
    if len(axes) == 2:
        qa, qb = axes
        u6 = b.reshape(2, 2, 2, 2, 2, 2)
        if qa > qb:
            u6 = u6.transpose(0, 2, 1, 3, 5, 4)
            qa, qb = qb, qa
        st = state.reshape(
            2, 1 << qa, 2, 1 << (qb - qa - 1), 2, 1 << (n - 1 - qb)
        )
        return np.einsum("xijykl,yakblc->xaibjc", u6, st).reshape(2, 1 << n)
    u, st, sub = _kq_operands(b, axes, n, state)
    return np.einsum(sub, u, st).reshape(2, 1 << n)
