"""Knitting: reconstruct the uncut circuit's distribution by tensor
contraction, plus the simplex projection.

Port of the JAX package's ``ops/knit.py``.  One einsum over the variant
axes replaces the reference's dict algebra:

    knitted[bits] = sum_{v_1..v_k} prod_f E_f[v_{T_f}, bits_f]

where E_f folds the vgate knit coefficients ``coef[v, clbit]`` into the
fragment that measured the vgate's clbit.  Fragment rows are torch tensors
(``FragmentResult.values``) and the whole knit runs on the device that
holds them; the contraction is a plain ``torch.einsum`` outside any
kernel, as the JAX package leaves it to XLA, in full float32 (PyTorch's
default ``allow_tf32=False``; ops/streamed.py states the same rule).  The
fold weights are small host tables (numpy, as in the JAX package); the
simplex projection runs on the device that holds the knit result.
"""
from __future__ import annotations

import string

import numpy as np
import torch

from ..utils.profiling import spanned
from ..virt.virtual_circuit import VirtualCircuit
from .bits import permute_bits_flat
from .statevector import Distribution
from .variant_engine import FragmentResult


def fold_weights(virt: VirtualCircuit, frag_name: str) -> list[np.ndarray]:
    """Per-touching-vgate knit weight matrices W[v, b] this fragment
    applies (owner-side logic).  Exposed so callers can pass them as
    runtime arguments (parameter sweeps re-bind RZZ/CP coefficients
    without recompiling the knit)."""
    prog = virt.programs[frag_name]
    sides: dict[int, list[int]] = {g: [] for g in prog.touching}
    for slot in prog.slots:
        sides[slot.vgate_idx].append(slot.side)
    out = []
    for g in prog.touching:
        spec = virt.vgates[g].spec
        my_sides = sides[g]
        both = len(my_sides) == 2
        w = np.ones((spec.num_instantiations, 2), dtype=np.float64)
        for v in range(spec.num_instantiations):
            if both or spec.owner_side[v] in my_sides:
                w[v] = spec.coef[v]
        out.append(w)
    return out


def _split_bit(t: torch.Tensor, lead: int, j: int, k: int) -> torch.Tensor:
    """``t [..., 2^k]`` with bit ``j`` of its last axis split out:
    ``[..., 2^(k-1-j), 2, 2^j]`` (``lead`` leading axes)."""
    return t.reshape(tuple(t.shape[:lead]) + (1 << (k - 1 - j), 2, 1 << j))


def _fold_fragment(
    virt: VirtualCircuit, res: FragmentResult, keep_clbits=None,
    weights=None,
) -> tuple[torch.Tensor, list[int]]:
    """Apply per-vgate coefficient weights; return E_f with shape
    [n_v1, ..., n_vm, 2^d] plus the data-bit positions (remaining bits,
    flattened little-endian in ascending clbit order).

    Each vgate's clbit is contracted by splitting only *that* bit out of
    the flat outcome axis: ``E[.., v, .., hi, lo] = sum_b rows[.., v, ..,
    hi, b, lo] * W[v, b]``, two broadcast multiply-adds in float32.

    ``keep_clbits`` (set or None): if given, data clbits NOT in the set
    are summed out *before* the cross-fragment contraction.  This is the
    marginal knit: because fragments write disjoint clbits, marginalising
    each fragment first commutes with the knit product, so the
    reconstructed marginal is exact while the full 2^num_clbits
    distribution never materialises.

    NOTE: ops/qpd_sampling._fold_rows_per_label is this fold's per-label
    twin (Monte-Carlo estimator): semantic changes here (owner rule,
    zero-clbit branch, bit-split order) must be mirrored there.
    """
    touching = res.touching
    n_inst = [virt.vgates[g].num_instantiations for g in touching]
    nv = len(n_inst)
    positions = list(res.bit_positions)  # ascending; LSB-first in the rows
    k = len(positions)
    t = torch.as_tensor(res.values, dtype=torch.float32).reshape(
        tuple(n_inst) + (1 << k,)
    )

    if weights is None:
        weights = fold_weights(virt, res.name)

    for ti, g in enumerate(touching):
        w = weights[ti]
        w = torch.as_tensor(w if isinstance(w, torch.Tensor)
                            else np.asarray(w), dtype=t.dtype,
                            device=t.device)
        shape = [1] * (nv + 2)
        shape[ti] = n_inst[ti]
        cg = virt.num_clbits + g
        if cg in positions:
            j = positions.index(cg)          # LSB offset of this clbit
            t4 = _split_bit(t, nv, j, k)
            # contract the bit axis with W sharing the variant axis ti
            t = (t4[..., 0, :] * w[:, 0].reshape(shape)
                 + t4[..., 1, :] * w[:, 1].reshape(shape))
            positions.pop(j)
            k -= 1
            t = t.reshape(tuple(n_inst) + (1 << k,))
        else:
            # clbit structurally zero here: scalar weight per variant
            t = t * w[:, 0].reshape(shape[:-1])

    if keep_clbits is not None:
        for p in [p for p in positions if p not in keep_clbits]:
            j = positions.index(p)
            t = _split_bit(t, nv, j, k).sum(dim=nv + 1)
            positions.pop(j)
            k -= 1
            t = t.reshape(tuple(n_inst) + (1 << k,))

    return t, positions


def knit(
    virt: VirtualCircuit,
    results: list[FragmentResult],
    keep_clbits=None,
) -> Distribution:
    """Contract all fragment results into the reconstructed distribution
    over the original clbits (host wrapper around ``knit_values``: the
    values are fetched).  ``keep_clbits`` selects a marginal: see
    ``_fold_fragment``."""
    values, positions = knit_values(virt, results, keep_clbits)
    return Distribution(values.cpu().numpy(), positions, virt.num_clbits)


def knit_values(
    virt: VirtualCircuit,
    results: list[FragmentResult],
    keep_clbits=None,
    weights=None,
):
    """The knit on the device of the results' ``values``.  Returns (flat
    values over written data clbits little-endian, positions).

    ``weights``: optional per-fragment list of per-touching-vgate weight
    matrices replacing the constants from :func:`fold_weights`."""
    expr, operands, frag_positions = _knit_operands(
        virt, results, weights, keep_clbits
    )
    merged = torch.einsum(expr, *operands).reshape(-1)

    # merged axes: one per fragment, each holding that fragment's data
    # bits little-endian; the LAST fragment axis occupies the LOW bits of
    # the C-order flat index.  Interleave to global ascending clbit order
    # with a rank-bounded bit permutation.
    src_bits: list[int] = []
    for pos_list in reversed(frag_positions):
        src_bits.extend(pos_list)
    dst_bits = sorted(src_bits)
    merged = permute_bits_flat(merged, src_bits, dst_bits)
    return merged, dst_bits


def expectation_z(
    virt: VirtualCircuit,
    results: list[FragmentResult],
    z_clbits,
) -> float:
    """<prod_{c in z_clbits} Z_c> of the reconstructed distribution.

    The parity sign (-1)^{popcount(x & S)} factorises over the fragments'
    disjoint clbit sets, so each fragment contracts to ONE scalar per
    variant (bit c weighted (+1,-1) if c in S else summed (+1,+1)) and
    the observable is a contraction over the variant axes alone: no
    distribution of any size materialises.
    """
    return float(expectation_z_multi(virt, results, [z_clbits])[0])


def expectation_z_multi(
    virt: VirtualCircuit,
    results: list[FragmentResult],
    z_sets,
    weights=None,
):
    """Batch of <prod Z> observables: returns a tensor of ``len(z_sets)``
    expectations (see :func:`expectation_z` for why the parity contraction
    factorises over fragments).  The fragment fold runs ONCE; each z-set
    then reduces every data bit with its own (+1,+1) / (+1,-1) weights
    (per-set scalars per variant) and the cross-fragment contraction
    carries a shared set axis.  ``weights`` (per-fragment) may replace the
    constants from :func:`fold_weights`.
    """
    z_sets = [set(s) for s in z_sets]
    # every Z support bit must actually be WRITTEN by a measure: an
    # unmeasured clbit would silently contract as (+1,+1) and report 1.0
    # (a circuit from the zoo without terminal measures is the common
    # trap: add `circ.measure(q, c)` for every observable qubit)
    written = {
        p for res in results for p in res.bit_positions
        if p < virt.num_clbits
    }
    for z in z_sets:
        missing = z - written
        if missing:  # ValueError, not assert: must survive ``python -O``
            raise ValueError(
                f"z_clbits {sorted(missing)} are never measured "
                f"(written data clbits: {sorted(written)})"
            )
    letters = list(string.ascii_letters)
    vgate_letter = {g: letters.pop() for g in range(len(virt.vgates))}
    set_letter = letters.pop()

    operands = []
    subs = []
    for fi, res in enumerate(results):
        e, data_pos = _fold_fragment(
            virt, res, None, None if weights is None else weights[fi]
        )
        nv = e.dim() - 1
        per_set = []
        for z in z_sets:
            k = len(data_pos)
            pos = list(data_pos)
            t = e
            for p in list(pos):
                j = pos.index(p)
                t4 = _split_bit(t, nv, j, k)
                t = (t4[..., 0, :] - t4[..., 1, :] if p in z
                     else t4[..., 0, :] + t4[..., 1, :])
                pos.remove(p)
                k -= 1
                t = t.reshape(tuple(t.shape[:nv]) + (1 << k,))
            per_set.append(t.reshape(tuple(t.shape[:nv])))
        operands.append(torch.stack(per_set))
        subs.append(
            set_letter + "".join(vgate_letter[g] for g in res.touching)
        )

    expr = ",".join(subs) + "->" + set_letter
    return torch.einsum(expr, *operands)


@spanned("port.project")
def smolin_project(vals: torch.Tensor) -> torch.Tensor:
    """Smolin projection onto the probability simplex, in float64 on
    ``vals``' own device, numerically the reference's ascending scan
    (quasi_distr.py:28-43) without its O(2^n) Python loop.

    In the reference loop the discarded entries are exactly a *prefix* of
    the ascending value order (once one entry passes, beta and num freeze
    and every later, larger, entry passes too).  So the cut index k* is
    the first position where ``v[k] + cumsum(v)[:k]/(n-k) >= 0`` and the
    output is ``v + beta/(n-k*)`` on the kept set, 0 on the discarded
    set.  The JAX package selects the negative tail on the host before
    sorting it; here one stable sort of the whole vector runs where the
    knit left it, so a distribution on the card is projected there and
    only the result is fetched.

    Tie caveat: entries that share the exact boundary value are cut in
    stable-sort order; the reference's order there depends on dict
    insertion order, so the published scan is not tie-deterministic
    either."""
    v = vals.reshape(-1).to(torch.float64)
    n = v.numel()
    if not bool((v < 0).any()):
        return v.clone()
    sv, order = torch.sort(v, stable=True)
    csum = torch.cat([sv.new_zeros(1), torch.cumsum(sv[:-1], 0)])
    left = n - torch.arange(n, dtype=torch.float64, device=v.device)
    ok = sv + csum / left >= 0
    if not bool(ok.any()):
        return torch.zeros_like(v)  # everything discarded (degenerate input)
    k = int(ok.to(torch.int8).argmax())
    out = v + csum[k] / (n - k)
    out[order[:k]] = 0.0
    return out


def nearest_probability_distribution(dist: Distribution) -> Distribution:
    """Project a quasi-distribution onto the probability simplex, matching
    the reference's Smolin-style projection (quasi_distr.py:28-43)."""
    out = smolin_project(torch.as_tensor(np.asarray(dist.values)))
    return Distribution(
        out.to(torch.float32).numpy(), dist.bit_positions, dist.num_clbits
    )


def prune_distribution(dist: Distribution, accuracy: float = 1e-5) -> Distribution:
    """Reference-compatible support pruning: zero every entry with
    ``|value| <= accuracy``.

    The reference's QuasiDistr drops such entries at EVERY construction
    (quasi_distr.py:3 ``ACCURACY = 1e-5`` and the ``__init__`` filter at
    quasi_distr.py:8-10), which concentrates a finite-shot knit's support
    on its high-mass keys.  The exact dense path never needs this; it
    exists for shot-sampled parity experiments."""
    vals = np.asarray(dist.values)
    out = np.where(np.abs(vals) <= accuracy, 0.0, vals)
    return Distribution(
        out.astype(vals.dtype), dist.bit_positions, dist.num_clbits
    )


def _knit_operands(virt, results, weights=None, keep_clbits=None):
    """Shared setup of :func:`knit_values`'s einsum: returns
    (expr, es, frag_positions)."""
    letters = list(string.ascii_letters)
    vgate_letter = {g: letters.pop() for g in range(len(virt.vgates))}
    operands, subs, out_sub = [], [], ""
    frag_positions: list[list[int]] = []
    for fi, res in enumerate(results):
        e, data_pos = _fold_fragment(
            virt, res, keep_clbits,
            None if weights is None else weights[fi],
        )
        sub = "".join(vgate_letter[g] for g in res.touching)
        dl = letters.pop()
        subs.append(sub + dl)
        out_sub += dl
        operands.append(e)
        frag_positions.append(data_pos)
    return ",".join(subs) + "->" + out_sub, operands, frag_positions


def _knit_block_cols(frag_positions, max_elems: int) -> int:
    """Column-block width over the LAST fragment's data axis such that one
    output block holds <= max_elems floats.

    Only the last fragment's axis is blocked: if the OTHER fragments'
    joint width alone exceeds ``max_elems`` the bound cannot be met
    (bc floors at 1): that is logged loudly rather than silently
    allocating an over-budget buffer."""
    other = 1
    for pos in frag_positions[:-1]:
        other <<= len(pos)
    last = 1 << len(frag_positions[-1])
    bc = max(1, max_elems // other)
    while last % bc:
        bc >>= 1
    bc = max(1, bc)
    if other * bc > max_elems:
        from ..utils.logger import get_logger

        get_logger(__name__).warning(
            f"blocked knit cannot meet the {max_elems}-float buffer "
            f"budget: non-last fragments span 2^{other.bit_length() - 1} "
            "alone (consider keep_clbits/marginal knit)"
        )
    return bc


def knit_scalars_blocked(virt, results, max_elems: int = 1 << 20):
    """(total, negativity) of the knitted distribution, as 0-d tensors,
    WITHOUT ever materialising it: the last fragment's data axis is
    processed in column blocks, so the largest live buffer is
    ``max_elems`` floats instead of 2^num_clbits."""
    expr, es, frag_positions = _knit_operands(virt, results)
    bc = _knit_block_cols(frag_positions, max_elems)
    last = es[-1]
    total = torch.zeros((), dtype=torch.float32, device=last.device)
    neg = torch.zeros_like(total)
    for j in range(last.shape[-1] // bc):
        out = torch.einsum(expr, *es[:-1], last[..., j * bc:(j + 1) * bc])
        total = total + out.sum()
        neg = neg + out.clamp(max=0.0).sum()
    return total, neg


def make_blocked_knit(virt, results, max_elems: int = 1 << 20):
    """Build (block_fn, nb, bc, src_bits): ``block_fn(j)`` returns column
    block ``j`` of the knit einsum, shape ``[other_size, bc]``, with every
    buffer <= ``max_elems``.

    Assembly: concatenate the blocks along the column axis, flatten
    C-order, then reorder with ``ops.bits.permute_bits_flat(flat,
    src_bits, sorted(src_bits))`` to get :func:`knit_values`'s output."""
    expr, es, frag_positions = _knit_operands(virt, results)
    bc = _knit_block_cols(frag_positions, max_elems)
    last = es[-1]
    nb = last.shape[-1] // bc
    other = 1
    for pos in frag_positions[:-1]:
        other <<= len(pos)

    def block_fn(j):
        blk = last[..., j * bc:(j + 1) * bc]
        return torch.einsum(expr, *es[:-1], blk).reshape(other, bc)

    src_bits: list[int] = []
    for pos_list in reversed(frag_positions):
        src_bits.extend(pos_list)
    return block_fn, nb, bc, src_bits
