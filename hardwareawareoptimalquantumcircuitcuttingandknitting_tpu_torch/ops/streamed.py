"""Streaming cut-simulate-knit over the global QPD label space.

Port of the JAX package's ``ops/streamed.py`` for the ``engine="pallas"``
exact path: the global labels (cartesian product over all vgates, last
vgate fastest — reference qvm/virtual_circuit.py:133-137) are processed in
fixed-size chunks, and per chunk

    carry[d1, ..., dF]  +=  sum_c  prod_f  E_f[c, d_f]

where each fragment's folded rows ``E_f`` come from a hand-written
kernel, routed by the fragment's simulated width as in the JAX package:
up to 20 qubits the fold-fused variant kernel (ops/variant_kernel.py,
rows arrive folded), 21..24 qubits the segmented blocked kernel
(ops/blocked_kernel.py, rows arrive unfolded and are folded here in
torch: vgate weights, dropped bits, z signs).  The chunk loop is a Python
loop over device work; the carry contraction is a plain ``torch.einsum``
outside the kernels, in float32 (PyTorch's default ``allow_tf32=False``
keeps it full precision).

Refused here with NotImplementedError (ROADMAP H100 port, queue A):
trajectory noise, certified truncation, shared-prefix ancestor banks,
bf16 states, shot sampling and fragments past 24 qubits (the sharded
engine).  The streamed scan without a kernel and carry checkpoints are
not ported either.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..convert import resolve_device, to_device
from ..utils.logger import get_logger
from ..virt.virtual_circuit import VirtualCircuit
from .bits import permute_bits_flat
from .blocked_kernel import MAX_BLOCKED_QUBITS, make_blocked_chunk_kernel
from .knit import fold_weights, smolin_project
from .statevector import Distribution
from .variant_engine import label_strides, variant_index_table
from .variant_kernel import make_folded_chunk_kernel

_ITEM = "ROADMAP H100 port, queue A, 'other engines'"


def _refuse(what: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to the torch package yet: {_ITEM}"
    )


def _fold_plan(virt: VirtualCircuit, name: str, positions, keep_clbits,
               z_clbits):
    """Fold plan for one fragment's UNFOLDED rows over ``positions``:
    ``(steps, w_tabs, kept)``.  Steps apply in order to rows ``[chunk,
    2^k]``: ``("w", j, k)`` contracts bit ``j`` (the vgate's measure
    clbit) with the label's weight pair (``j`` None: multiply by w0),
    ``("drop", j, k)`` sums bit ``j`` out, ``("z", j, k)`` takes the
    signed difference.  ``w_tabs``: per touching vgate ``(global vgate
    id, [nI, 2] float32)``; ``kept``: the data clbits left, ascending."""
    prog = virt.programs[name]
    pos = list(positions)
    k = len(pos)
    steps, w_tabs = [], []
    frag_weights = fold_weights(virt, name)
    for ti, g in enumerate(prog.touching):
        w_tabs.append((g, np.asarray(frag_weights[ti], np.float32)))
        cg = virt.num_clbits + g
        if cg in pos:
            j = pos.index(cg)
            steps.append(("w", j, k))
            pos.pop(j)
            k -= 1
        else:
            steps.append(("w", None, k))
    if z_clbits is not None:
        # observable mode: contract EVERY data bit, signed on the support
        for p in list(pos):
            j = pos.index(p)
            steps.append(("z" if p in z_clbits else "drop", j, k))
            pos.pop(j)
            k -= 1
    elif keep_clbits is not None:
        for p in [p for p in pos if p not in keep_clbits]:
            j = pos.index(p)
            steps.append(("drop", j, k))
            pos.pop(j)
            k -= 1
    return steps, w_tabs, pos


def _apply_fold(rows, steps, w_dev, vidx_chunk):
    """Fold ``rows [chunk, 2^k]`` by ``steps`` (see :func:`_fold_plan`);
    every step halves the rows, so the temporaries shrink as it goes."""
    c = rows.shape[0]
    w_iter = iter(w_dev)
    for kind, j, k in steps:
        if kind == "w":
            g, tab = next(w_iter)
            w_sel = tab[vidx_chunk[:, g]]
            if j is None:
                rows = rows * w_sel[:, :1]
                continue
        r4 = rows.reshape(c, 1 << (k - 1 - j), 2, 1 << j)
        if kind == "drop":
            rows = r4.sum(dim=2)
        elif kind == "z":
            rows = r4[:, :, 0] - r4[:, :, 1]
        else:
            rows = r4[:, :, 0] * w_sel[:, 0, None, None]
            rows.addcmul_(r4[:, :, 1], w_sel[:, 1, None, None])
        rows = rows.reshape(c, -1)
    return rows


def _fragment_rows(virt, name, chunk, keep_clbits, z_clbits, dev,
                   blocked_window):
    """Route one fragment to its kernel: ``(kernel name, rows_fn, kept,
    device plan)`` with ``rows_fn(vidx_chunk)`` -> folded rows ``[chunk,
    2^len(kept)]``."""
    if blocked_window is None:
        built = make_folded_chunk_kernel(
            virt, name, chunk, keep_clbits=keep_clbits, z_clbits=z_clbits,
            device=dev,
        )
        if built is not None:
            rows_fn, kept = built
            return "variant", rows_fn, kept, rows_fn.plan
        built = make_blocked_chunk_kernel(virt, name, chunk, device=dev)
    else:
        built = make_blocked_chunk_kernel(
            virt, name, chunk, window=blocked_window, force=True, device=dev
        )
    if built is None:
        n = virt.programs[name].num_sim_qubits
        raise NotImplementedError(
            f"fragment {name!r} simulates {n} qubits, outside the kernels' "
            f"gates (variant up to 20, blocked 21..{MAX_BLOCKED_QUBITS}): "
            "ROADMAP H100 port, queue A, 'other engines' (sharded "
            "fragments)"
        )
    rows_fn, positions = built
    steps, w_tabs, kept = _fold_plan(virt, name, positions, keep_clbits,
                                     z_clbits)
    w_dev = [(g, to_device(t, dev)) for g, t in w_tabs]

    def folded_rows(vidx_chunk):
        return _apply_fold(rows_fn(vidx_chunk), steps, w_dev, vidx_chunk)

    return "blocked", folded_rows, kept, rows_fn.plan


def make_streamed_knit(
    virt: VirtualCircuit, chunk: int = 512, keep_clbits=None,
    noise=None, z_clbits=None, share_prefix: bool = False, dtype=None,
    trunc_eps: float = 0.0, device=None, blocked_window: int | None = None,
):
    """Build ``(step_fn, xs, meta)``: ``step_fn(xs)`` runs every global
    label chunk and returns the flat knitted quasi-distribution values
    (a float32 tensor on ``device``, None = "cuda").

    ``xs`` = ``(vidx [n_chunks, chunk, num_vgates] int64, valid
    [n_chunks, chunk] float32)``, both on the device: per-label variant
    indices plus a validity mask for the padded tail.  Every fragment's
    rows come from a kernel (module docstring), folded in-kernel or here
    (``keep_clbits``: marginal knit; ``z_clbits``: every data bit
    contracted, signed on the support).  ``meta`` carries ``carry_shape``,
    ``segment_fn`` and ``finish_fn``: ``finish_fn(segment_fn(carry,
    xs_seg))`` == ``step_fn(xs)`` when the segments tile all chunks;
    ``pallas_fragments`` (fragment -> kernel-backed, always True here:
    a fragment no kernel serves raises), ``fragment_kernels`` (fragment
    -> ``"variant"`` | ``"blocked"``) and ``fragment_plans`` (fragment ->
    the kernel's device plan).

    ``blocked_window``: test hook: send EVERY fragment through the
    blocked kernel at this window, whatever its width."""
    if noise is not None:
        _refuse("noise=")
    if trunc_eps:
        _refuse("trunc_eps=")
    if share_prefix:
        _refuse("share_prefix=")
    if dtype is not None and dtype != torch.float32:
        _refuse("dtype= other than float32")
    dev = resolve_device(device)
    specs = [vg.spec for vg in virt.vgates]
    num_g = len(specs)
    gstride, n_inst, total = label_strides(specs, range(num_g))
    n_chunks = max(1, math.ceil(total / chunk))
    padded = n_chunks * chunk
    valid = (np.arange(padded) < total).astype(np.float32)
    vidx = variant_index_table(range(num_g), gstride, n_inst, padded)

    frag_names = [r.name for r in virt.fragments]
    rows_fns = []
    data_positions = []
    kernels, plans = {}, {}
    for name in frag_names:
        kernels[name], rows_fn, kept, plans[name] = _fragment_rows(
            virt, name, chunk, keep_clbits, z_clbits, dev, blocked_window
        )
        rows_fns.append(rows_fn)
        data_positions.append(kept)
    shape = tuple(1 << len(p) for p in data_positions)
    # 'z' is the chunk label — fragment labels must not collide with it
    letters = "abdefghijklm"
    assert len(frag_names) <= len(letters)
    expr = (
        ",".join(f"z{letters[i]}" for i in range(len(frag_names)))
        + "->" + letters[: len(frag_names)]
    )

    def segment_fn(carry, xs_seg):
        vidx_seg, valid_seg = xs_seg
        for c in range(vidx_seg.shape[0]):
            es = [fn(vidx_seg[c]) for fn in rows_fns]
            es[0] = es[0] * valid_seg[c][:, None]
            carry = carry + torch.einsum(expr, *es)
        return carry

    def finish_fn(carry):
        # interleave fragment bit groups to global ascending clbit order
        src_bits: list[int] = []
        for pos_list in reversed(data_positions):
            src_bits.extend(pos_list)
        return permute_bits_flat(
            carry.reshape(-1), src_bits, sorted(src_bits)
        )

    def step_fn(xs):
        carry0 = torch.zeros(shape, dtype=torch.float32, device=dev)
        return finish_fn(segment_fn(carry0, xs))

    xs = (
        to_device(vidx.reshape(n_chunks, chunk, -1), dev, torch.int64),
        to_device(valid.reshape(n_chunks, chunk), dev),
    )
    meta = {
        "positions": sorted(
            p for pos_list in data_positions for p in pos_list
        ),
        "global_labels": total,
        "n_chunks": n_chunks,
        "chunk": chunk,
        "carry_shape": shape,
        "segment_fn": segment_fn,
        "finish_fn": finish_fn,
        "pallas_fragments": {name: True for name in frag_names},
        "fragment_kernels": kernels,
        "fragment_plans": plans,
    }
    get_logger(__name__).info(
        "engine='pallas': " + "; ".join(
            f"{kind} kernel backs "
            f"{[n for n in frag_names if kernels[n] == kind]}"
            for kind in sorted(set(kernels.values()))
        )
    )
    return step_fn, xs, meta


# Per-buffer budget for one chunk's [chunk, 2, 2^n] states (the JAX
# package's bound, kept so both packages pick the same chunk).
_CHUNK_BYTES_BUDGET = 512 * 1024 * 1024


def auto_chunk(virt: VirtualCircuit, requested: int) -> int:
    """Cap the requested chunk so one chunk's states stay within the
    budget, and never pad a small fan-out up to a huge chunk."""
    max_n = max(
        (p.num_sim_qubits for p in virt.programs.values()), default=1
    )
    cap = max(8, _CHUNK_BYTES_BUDGET // (2 * (1 << max_n) * 4))
    total = 1
    for vg in virt.vgates:
        total *= vg.spec.num_instantiations
    return int(max(1, min(requested, cap, total)))


def run_virtual_circuit_streamed(
    virt: VirtualCircuit,
    chunk: int = 512,
    project: bool = False,
    noise=None,
    shots: int | None = None,
    share_prefix: bool = False,
    dtype=None,
    trunc_eps: float = 0.0,
    keep_clbits=None,
    device=None,
) -> Distribution:
    """End-to-end streamed execution on ``device`` (None = "cuda").
    ``chunk`` is capped by :func:`auto_chunk`.  ``keep_clbits``: marginal
    knit (the carry lives on the marginal).  ``project``: Smolin
    projection onto the simplex, on the device before the fetch."""
    if shots is not None:
        _refuse("shots=")
    chunk = auto_chunk(virt, chunk)
    step_fn, xs, meta = make_streamed_knit(
        virt, chunk, keep_clbits=keep_clbits, noise=noise,
        share_prefix=share_prefix, dtype=dtype, trunc_eps=trunc_eps,
        device=device,
    )
    values = step_fn(xs)
    if project:
        values = smolin_project(values).to(torch.float32)
    return Distribution(values.cpu().numpy(), meta["positions"],
                        virt.num_clbits)


def streamed_expectation_z(
    virt: VirtualCircuit, z_clbits, chunk: int = 512, noise=None,
    trajectories: int | None = None, share_prefix: bool = False,
    dtype=None, device=None,
) -> float:
    """<prod_{c in z_clbits} Z_c> of the reconstructed distribution,
    computed with a SCALAR carry: every data bit is contracted per
    fragment and label (signed on the Z support), so no distribution of
    any size materialises for any circuit width; one scalar fetch.  Exact,
    noise-free, float32 on ``device`` (None = "cuda")."""
    # every Z support bit must be WRITTEN by a measure — an unmeasured
    # clbit would silently contract as (+1,+1) and report 1.0
    written = {
        c for p in virt.programs.values() for c in p.clbit_sources
        if c < virt.num_clbits
    }
    missing = set(z_clbits) - written
    if missing:  # ValueError, not assert: must survive ``python -O``
        raise ValueError(
            f"z_clbits {sorted(missing)} are never measured "
            f"(written data clbits: {sorted(written)})"
        )
    if trajectories is not None:
        _refuse("trajectories=")
    step_fn, xs, _ = make_streamed_knit(
        virt, auto_chunk(virt, chunk), z_clbits=frozenset(z_clbits),
        noise=noise, share_prefix=share_prefix, dtype=dtype, device=device,
    )
    return float(step_fn(xs).reshape(()))
