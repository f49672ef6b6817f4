"""Lane-layout variant execution: the chunk axis trailing.

The streamed and batched engines run a chunk of variants with the chunk
as the LEADING axis (``variant_engine.make_sim_fn``'s closure on ``[V,
2, 2^m]`` states), so each gate pass walks bit slices of every variant's
state.  Here the same execution plan (``make_sim_fn``'s lazy-width step
list — shared, not re-derived) runs with the chunk axis TRAILING: the
state is ``[2, 2^m, C]``, and every gate is one ``torch.einsum`` that
keeps ``C`` as the minor-most label, so each gate's contraction reads
the ``C`` variants of one amplitude as one contiguous row.

Port of the JAX package's ``ops/lane_engine.py``, plain PyTorch.  On the
TPU the trailing axis is the 128-wide lane axis and the layout is a
recorded negative result there; on a GPU the trailing axis is the one a
warp's loads coalesce along, so the question is a different one.  The
JAX module's constant-block fast paths (slice combines, diagonal
broadcasts) are XLA-side rewrites of the same product; here every gate
is the einsum.

``make_lane_sim`` returns a chunk-level function: per-slot variant
matrices arrive as ``[C, ...]`` gathered tables (the streamed path's
tables) and the result is ``[2^k, C]`` probability rows, the transpose
of ``make_sim_fn``'s rows for the same gathered matrices.
"""
from __future__ import annotations

import string

import numpy as np
import torch

from ..convert import resolve_device, to_device
from ..virt.virtual_circuit import VirtualCircuit


def _gate_subscripts(k: int):
    """(block_sub, state_sub, out_sub) einsum labels for a k-qubit gate on
    a ``[2(re/im), bits..., C]`` state; 'c' is reserved for the chunk
    axis, 'x'/'y' for the real-rep component axes."""
    pool = [ch for ch in string.ascii_letters if ch not in "xyc"]
    assert 3 * k + 1 <= len(pool), f"fused block too wide: k={k}"
    outs, ins = pool[:k], pool[k:2 * k]
    gaps = pool[2 * k:3 * k + 1]
    block = "x" + "".join(outs) + "y" + "".join(ins)
    state = "y"
    out = "x"
    for i in range(k):
        state += gaps[i] + ins[i]
        out += gaps[i] + outs[i]
    state += gaps[k] + "c"
    out += gaps[k] + "c"
    return block, state, out


def _bit_shape(axes_sorted, m: int, tail: int):
    """State reshape splitting out each gate bit: [2, g0, 2, g1, 2, ...,
    gk, tail]."""
    shape = [2]
    prev = -1
    for q in axes_sorted:
        shape += [1 << (q - prev - 1), 2]
        prev = q
    shape += [1 << (m - 1 - axes_sorted[-1]), tail]
    return tuple(shape)


def _block_perm(block, k: int, axes):
    """Permute a [..., 2, 2^k-as-bits..., 2, bits...] block's qubit slots
    to ascending axis order; ``block`` may carry a leading variant axis
    (ndim == 2k+3)."""
    order = sorted(range(k), key=lambda i: axes[i])
    if order == list(range(k)):
        return block
    lead = block.ndim - (2 * k + 2)  # 0 (const) or 1 (variant axis)
    perm = list(range(lead))
    perm += [lead] + [lead + 1 + p for p in order]
    perm += [lead + k + 1] + [lead + k + 2 + p for p in order]
    return block.permute(perm)


def apply_lane(state, block, axes, m: int, variant_axis: bool):
    """Apply one gate/slot block to a ``[2, 2^m, C]`` lane-layout state.

    ``block``: real block ``[2, d, 2, d]`` (a host constant) or ``[C, 2,
    d, 2, d]`` per-variant (``variant_axis=True``), d = 2^k."""
    k = len(axes)
    C = state.shape[-1]
    if isinstance(block, np.ndarray):
        block = torch.as_tensor(block, device=state.device)
    b = block.to(state.dtype).reshape(
        ((-1,) if variant_axis else ()) + (2,) + (2,) * k + (2,) + (2,) * k
    )
    b = _block_perm(b, k, axes)
    qs = sorted(axes)
    bsub, ssub, osub = _gate_subscripts(k)
    if variant_axis:
        bsub = "c" + bsub
    st = state.reshape(_bit_shape(qs, m, C))
    out = torch.einsum(f"{bsub},{ssub}->{osub}", b, st)
    return out.reshape(2, 1 << m, C)


def make_lane_sim(virt: VirtualCircuit, frag_name: str,
                  fuse_qubits: int = 3, device=None):
    """Build ``sim_chunk(slot_mats) -> [2^width, C]`` for one fragment.

    ``slot_mats``: per-slot ``(pre[C,2,2,2,2], m4[C,2,4,2,4],
    post[C,2,2,2,2])`` gathered variant tables, tensors on one device.
    Returns ``make_sim_fn``'s rows for the same gathered matrices,
    transposed.  A fragment without slots returns one column, on
    ``device`` (None = "cuda")."""
    from .variant_engine import make_sim_fn

    sim_fn, _, positions, flat_count = make_sim_fn(
        virt, frag_name, build_matrices=False, fuse_qubits=fuse_qubits
    )
    run_plan = sim_fn.run_plan
    m0 = sim_fn.prefix_width
    prefix = np.asarray(sim_fn.prefix_state)  # [2, 2^m0]
    active_final = sim_fn.active_final
    sources = sim_fn.sources

    # host-computed output-bit permutation: after the keep-only pairwise
    # marginalisation the kept bits are little-endian over
    # reversed(active-kept); the row is little-endian over ``sources``
    # (keep_axes order).  row_lane = marg[perm].
    act_sources = [q for q in sources if q in active_final]
    kept_desc = [
        q for q in reversed(sorted(active_final))
        if q in act_sources
    ]
    kk = len(act_sources)
    idx = np.arange(1 << kk)
    perm = np.zeros(1 << kk, np.int64)
    for j_out, q in enumerate(act_sources):
        j_in = kept_desc.index(q)
        perm += ((idx >> np.int64(j_out)) & 1) << np.int64(j_in)

    def sim_chunk(slot_mats):
        leaves = [t for tabs in slot_mats for t in tabs]
        if leaves:
            C, dev = leaves[0].shape[0], leaves[0].device
        else:
            C, dev = 1, resolve_device(device)
        state = to_device(prefix, dev)[:, :, None].expand(
            2, 1 << m0, C).contiguous()
        m = m0
        for stp in run_plan:
            kind = stp[0]
            if kind == "ins":
                pos = stp[1]
                r = state.reshape(2, 1 << pos, 1 << (m - pos), C)
                state = torch.stack(
                    [r, torch.zeros_like(r)], dim=2
                ).reshape(2, 1 << (m + 1), C)
                m += 1
            elif kind == "u":
                state = apply_lane(state, stp[1], stp[2], m, False)
            elif kind == "pauli":
                continue  # exact path
            else:
                pre, m4, post = slot_mats[stp[1]]
                blk = (
                    pre if kind == "slot_pre"
                    else m4 if kind == "slot_meas" else post
                )
                state = apply_lane(state, blk, stp[2], m, True)
        p = (state * state).sum(dim=0)  # [2^m, C]
        # pairwise marginalisation over non-kept qubits, trailing C intact
        kept = sorted(active_final)
        keep_q = set(act_sources)
        cur = m
        for pos in reversed(range(len(kept))):
            if kept[pos] in keep_q:
                continue
            p = p.reshape(1 << pos, 2, -1, C).sum(dim=1)
            p = p.reshape(1 << (cur - 1), C)
            kept.pop(pos)
            cur -= 1
        row = p.reshape(1 << kk, C)[torch.as_tensor(perm, device=dev)]
        # splice deterministic |0> bits of never-touched source qubits
        for j, q in enumerate(sources):
            if q not in active_final:
                r = row.reshape(-1, 1 << j, C)
                row = torch.stack([r, torch.zeros_like(r)], dim=1).reshape(
                    -1, C
                )
        return row

    return sim_chunk, positions, flat_count
