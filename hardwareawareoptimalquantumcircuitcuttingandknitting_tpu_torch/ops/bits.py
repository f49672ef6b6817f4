"""Bit-permutation primitives for flat probability tensors (torch).

Flat distributions index outcomes little-endian: bit ``j`` (LSB) of the
last-axis index carries the label ``bits[j]``.  Reordering bit labels is a
permutation of the 2^m entries.  Runs of bits that move together are
compressed, so block-structured permutations (two fragments' contiguous
clbit ranges) become rank-2/3 transposes; scattered permutations (full
bit reversal) fall back to a 1-D gather whose index vector is built with
shift arithmetic on the tensor's device (once, where the caller keeps a
``memo`` for it).
"""
from __future__ import annotations

import torch

_MAX_TRANSPOSE_RANK = 8


def _compress_runs(order: list[int]) -> tuple[list[tuple[int, int]], bool]:
    """Group a permutation into maximal runs of consecutive source axes.
    Returns (groups in target order as (start, length), is_identity)."""
    groups: list[tuple[int, int]] = []
    start, length = order[0], 1
    for idx in order[1:]:
        if idx == start + length:
            length += 1
        else:
            groups.append((start, length))
            start, length = idx, 1
    groups.append((start, length))
    return groups, groups == [(0, len(order))]


def permute_bits_flat(x: torch.Tensor, src_bits: list[int],
                      dst_bits: list[int], memo: dict | None = None
                      ) -> torch.Tensor:
    """Reorder the last axis of ``x`` (length 2^m) from little-endian bit
    labels ``src_bits`` to ``dst_bits`` (same label set).  Leading axes are
    untouched.  ``memo``: a dict the caller keeps, where the gather
    fallback's index is built once per permutation and device."""
    m = len(src_bits)
    assert sorted(src_bits) == sorted(dst_bits)
    if m == 0 or src_bits == dst_bits:
        return x

    # axis t (of a (2,)*m C-order split) is bit m-1-t
    src_axes = list(reversed(src_bits))
    dst_axes = list(reversed(dst_bits))
    pos_in_src = {b: t for t, b in enumerate(src_axes)}
    order = [pos_in_src[b] for b in dst_axes]
    groups, identity = _compress_runs(order)
    if identity:
        return x

    lead = tuple(x.shape[:-1])
    if len(groups) <= _MAX_TRANSPOSE_RANK:
        src_sorted = sorted(range(len(groups)), key=lambda g: groups[g][0])
        src_order_pos = {g: p for p, g in enumerate(src_sorted)}
        nlead = len(lead)
        shape = lead + tuple(1 << groups[g][1] for g in src_sorted)
        perm = tuple(range(nlead)) + tuple(
            nlead + src_order_pos[g] for g in range(len(groups))
        )
        y = x.reshape(shape).permute(perm)
        return y.reshape(lead + (1 << m,))

    # gather fallback: dst index d reads src index built by bit arithmetic
    key = (tuple(src_bits), tuple(dst_bits), x.device)
    s = None if memo is None else memo.get(key)
    if s is None:
        src_lsb = {b: j for j, b in enumerate(src_bits)}
        d = torch.arange(1 << m, dtype=torch.int64, device=x.device)
        s = torch.zeros_like(d)
        for j, b in enumerate(dst_bits):
            s = s | (((d >> j) & 1) << src_lsb[b])
        if memo is not None:
            memo[key] = s
    return torch.index_select(x, x.dim() - 1, s)
