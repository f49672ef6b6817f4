"""Amplitude-sharded statevector simulation: fragments larger than one
device.

Port of the JAX package's ``ops/sharded_sv.py`` over a process-group
mesh (parallel/mesh.py) in place of ``shard_map``.  The state's
amplitude axis is split over a mesh axis: each of its ``2^k`` ranks
holds a ``[B, 2, 2^(n-k)]`` block (``B`` states side by side, the
variant axis the JAX package ``vmap``s), and

  * a gate on *local* qubits (index >= k) is a plain block-local pass
    (``variant_engine._apply_block``) — no communication;
  * a gate touching a *global* qubit (index < k, a bit of the shard
    index) exchanges partner blocks with the rank whose index differs in
    that bit (:meth:`~..parallel.mesh.Mesh.exchange`, the JAX
    ``lax.ppermute``) and mixes them with shard-dependent coefficients,
    one hop per global qubit.

The layout is the JAX package's: qubit 0 is the MSB of the flat index,
so the shard index is qubits ``0..k-1`` and shard bit ``k-1-q`` is qubit
``q``.  The shard index is a Python int here, so JAX's
``jnp.where(my == 0, ...)`` selects are plain branches.  The final clbit
marginal is assembled from each shard's local marginal scattered into
its global-bit slot and summed over the axis
(:meth:`~..parallel.mesh.Mesh.all_reduce`, the JAX ``lax.psum``), so the
full 2^n vector never exists anywhere.  A bf16 state's blocks and
exchanges stay bf16; the marginal accumulates in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.mesh import Mesh
from .statevector import (
    CompiledCircuit,
    Distribution,
    marginalize_flat,
    to_real_block,
)
from .variant_engine import _apply_block, _round_block


def _take(block, *index):
    """``block[index]`` over the block axes of a host block, or of every
    row of a per-row ``[B, ...]`` tensor block."""
    if isinstance(block, torch.Tensor):
        return block[(slice(None),) + index]
    return block[index]


def _six(block):
    """A 2-qubit real block ``[2, 4, 2, 4]`` (or ``[B, ...]``) as
    ``(x, a_out, b_out, y, a_in, b_in)`` axes."""
    if isinstance(block, torch.Tensor):
        return block.reshape(block.shape[0], 2, 2, 2, 2, 2, 2)
    return np.asarray(block).reshape(2, 2, 2, 2, 2, 2)


def _swap_operands(b6):
    """The same 2-qubit block with its two operands swapped."""
    if isinstance(b6, torch.Tensor):
        return b6.permute(0, 1, 3, 2, 4, 6, 5)
    return np.transpose(b6, (0, 2, 1, 3, 5, 4))


def _mix(terms, dtype):
    """``sum_t sum_y coef_t[x, y] * src_t[:, y]`` for states ``src_t
    [B, 2, L]`` (axis 1 = re/im): a coefficient is a host ``[2, 2]``
    array (Python floats, rounded to the state's dtype, zeros skipped)
    or a per-row ``[B, 2, 2]`` tensor.  Summed in float32 and stored
    once in ``dtype``, one rounding a pass as ``_apply_block`` rounds."""
    acc = [None, None]
    for coef, src in terms:
        s = src.to(torch.float32)
        host = not isinstance(coef, torch.Tensor)
        if host and dtype != torch.float32:
            coef = _round_block(np.asarray(coef, np.float32), dtype)
        for x in (0, 1):
            for y in (0, 1):
                if host:
                    c = float(coef[x, y])
                    if c == 0.0:
                        continue
                    t = s[:, y] * c
                else:
                    t = s[:, y] * coef[:, x, y].to(torch.float32)[:, None]
                acc[x] = t if acc[x] is None else acc[x] + t
    ref = terms[0][1]
    acc = [torch.zeros(ref.shape[0], ref.shape[2], dtype=torch.float32,
                       device=ref.device) if a is None else a for a in acc]
    return torch.stack(acc, dim=1).to(dtype)


class ShardCtx:
    """Amplitude-sharded gate application over one mesh axis.

    Holds the static layout (``n`` sim qubits, ``2^k`` shards on
    ``mesh.shape[axis_name]``) and dispatches any 1/2-qubit gate to the
    right local/global case.  Blocks may be host ``[2, m, 2, m]`` arrays
    or per-row ``[B, 2, m, 2, m]`` tensors — the latter is what the
    sharded *fragment* engine (ops/sharded_fragment.py) feeds it: QPD
    slot blocks that vary along the variant axis.  The JAX ``ShardCtx(n,
    num_shards, axis_name)`` reads the shard count off the mesh here."""

    def __init__(self, n: int, mesh: Mesh, axis_name: str = "amp"):
        num_shards = mesh.shape[axis_name]
        self.n = n
        self.k = int(math.log2(num_shards))
        assert 1 << self.k == num_shards, "mesh axis must be a power of 2"
        assert self.k <= n, (
            f"more shards ({num_shards}) than amplitudes (2^{n})"
        )
        self.num_shards = num_shards
        self.axis_name = axis_name
        self.mesh = mesh

    # -- helpers ---------------------------------------------------------

    def my_bits(self) -> dict[int, int]:
        """Per-global-qubit bit value of this shard's index."""
        idx = self.mesh.index(self.axis_name)
        return {q: (idx >> (self.k - 1 - q)) & 1 for q in range(self.k)}

    def apply(self, state, block, axes, my_bits, mask=None):
        """Dispatch one gate on local blocks ``[B, 2, 2^(n-k)]``.
        ``mask``: a per-row block's host-known nonzero pattern, for a
        local gate (``_apply_block``).

        Contract: <= 2 qubits per gate when any qubit is global (index
        < k) — feed this engine unfused or max_qubits=2-fused streams
        only (k-qubit fused blocks are the single-device engines'
        trick)."""
        if all(q >= self.k for q in axes):
            return self._gate_local(state, block, axes, mask)
        if len(axes) > 2:
            raise ValueError(
                f"sharded apply supports <= 2-qubit gates on global "
                f"qubits, got {len(axes)} qubits {axes} with k={self.k}"
            )
        if len(axes) == 1:
            return self._gate_1q_global(state, block, axes[0], my_bits)
        if any(q >= self.k for q in axes):
            return self._gate_2q_mixed(state, block, axes, my_bits)
        return self._gate_2q_global(state, block, axes, my_bits)

    def _mask(self, q: int) -> int:
        return 1 << (self.k - 1 - q)

    def _partner(self, x, mask):
        return self.mesh.exchange(x, self.axis_name, mask)

    # -- gate cases ------------------------------------------------------

    def _gate_local(self, state, block, axes, mask=None):
        local_axes = tuple(q - self.k for q in axes)
        return _apply_block(state, block, local_axes, self.n - self.k, mask)

    def _gate_1q_global(self, state, block, q, my_bits):
        myb = my_bits[q]
        partner = self._partner(state, self._mask(q))
        c_keep = _take(block, slice(None), myb, slice(None), myb)
        c_swap = _take(block, slice(None), myb, slice(None), 1 - myb)
        return _mix([(c_keep, state), (c_swap, partner)], state.dtype)

    def _gate_2q_mixed(self, state, block, axes, my_bits):
        """One global qubit g, one local qubit l."""
        (g, l) = axes
        b6 = _six(block)
        if g >= self.k:  # gate order (local, global) -> swap operand axes
            g, l = l, g
            b6 = _swap_operands(b6)
        myb = my_bits[g]
        partner = self._partner(state, self._mask(g))
        # (x, i_l, y, j_l) blocks for the kept / fetched global bit value
        a_keep = _take(b6, slice(None), myb, slice(None), slice(None), myb)
        a_swap = _take(b6, slice(None), myb, slice(None), slice(None),
                       1 - myb)
        nl = self.n - self.k
        out = _apply_block(state, a_keep, (l - self.k,), nl)
        return out + _apply_block(partner, a_swap, (l - self.k,), nl)

    def _gate_2q_global(self, state, block, axes, my_bits):
        """Both qubits global: two exchange hops, 4-way mix."""
        (g1, g2) = axes
        b6 = _six(block)
        my1, my2 = my_bits[g1], my_bits[g2]
        p2 = self._partner(state, self._mask(g2))
        # stacked[j2] = block whose g2 bit is j2
        stacked = [state, p2] if my2 == 0 else [p2, state]
        pd = self._partner(torch.stack(stacked), self._mask(g1))
        # full[j1][j2]: the block whose (g1, g2) bits are (j1, j2)
        full = [stacked, [pd[0], pd[1]]] if my1 == 0 \
            else [[pd[0], pd[1]], stacked]
        coef = _take(b6, slice(None), my1, my2)      # (x, y, j1, j2)
        terms = [(_take(coef, slice(None), slice(None), a, b), full[a][b])
                 for a in (0, 1) for b in (0, 1)]
        return _mix(terms, state.dtype)

    def marginal(self, local_state, keep_axes: list[int]):
        """Per shard: |amp|^2, local marginal, scatter to global slots,
        sum over the axis -> the full ``[B, 2^len(keep_axes)]`` marginal
        (replicated), ``keep_axes[0]`` the LSB."""
        idx = self.mesh.index(self.axis_name)
        # probabilities accumulate in f32 even for a bf16 serving state
        s32 = local_state.to(torch.float32)
        probs = (s32 * s32).sum(dim=1)

        kept_local = [q for q in keep_axes if q >= self.k]
        kept_global = [q for q in keep_axes if q < self.k]
        local_marg = marginalize_flat(
            probs, self.n - self.k, [q - self.k for q in kept_local]
        )

        n_keep = len(keep_axes)
        # static dilation: local marginal bit j -> final bit position of
        # kept_local[j] within keep_axes, plus this shard's global kept
        # bits (an identity when every kept bit is local and in order)
        local_pos = [keep_axes.index(q) for q in kept_local]
        if local_pos == list(range(n_keep)):
            out = local_marg.contiguous()
        else:
            offset = 0
            for q in kept_global:
                bit = (idx >> (self.k - 1 - q)) & 1
                offset += bit << keep_axes.index(q)
            i = torch.arange(1 << len(kept_local), device=local_marg.device)
            cols = torch.full_like(i, offset)
            for j, pos in enumerate(local_pos):
                cols |= ((i >> j) & 1) << pos
            out = torch.zeros(local_marg.shape[0], 1 << n_keep,
                              dtype=torch.float32, device=local_marg.device)
            out.index_copy_(1, cols, local_marg)
        return self.mesh.all_reduce(out, self.axis_name)


class _Builder(ShardCtx):
    """Per-shard step function for one compiled (static-gate) circuit."""

    def __init__(self, compiled: CompiledCircuit, mesh: Mesh,
                 axis_name: str):
        super().__init__(compiled.num_sim_qubits, mesh, axis_name)
        self.compiled = compiled
        self.blocks = [
            (to_real_block(u), axes) for u, axes in compiled.ops
        ]

    def step(self, local_state):
        my_bits = self.my_bits()
        state = local_state
        for block, axes in self.blocks:
            state = self.apply(state, block, axes, my_bits)
        return state


def make_sharded_sim(
    compiled: CompiledCircuit, mesh: Mesh, axis_name: str = "amp"
):
    """Returns ``(fn, state0, positions)``: ``fn(state0)`` ->
    the exact clbit marginal ``[2^len(positions)]`` (replicated over the
    axis).  ``state0`` is THIS rank's block ``[2, 2^(n-k)]`` of the
    |0...0> initial state (a host array: the JAX package hands the whole
    ``[2, 2^n]`` state to its sharding, which would not fit one device
    at the widths this engine is for)."""
    builder = _Builder(compiled, mesh, axis_name)
    positions = sorted(compiled.clbit_sources)
    keep_axes = [compiled.clbit_sources[c] for c in positions]

    def per_shard(local_state):
        final = builder.step(local_state[None])
        return builder.marginal(final, keep_axes)[0]

    state0 = np.zeros((2, 1 << (builder.n - builder.k)), dtype=np.float32)
    if mesh.index(axis_name) == 0:
        state0[0, 0] = 1.0
    return per_shard, state0, positions


def sharded_probabilities(
    compiled: CompiledCircuit, mesh: Mesh, axis_name: str = "amp"
) -> Distribution:
    """End-to-end: simulate with the amplitude axis sharded over
    ``mesh[axis_name]`` and return the exact outcome distribution."""
    fn, state0, positions = make_sharded_sim(
        compiled, mesh, axis_name
    )
    values = fn(torch.as_tensor(state0, device=mesh.device))
    return Distribution(values.cpu().numpy(), positions, compiled.num_clbits)
