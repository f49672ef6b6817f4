"""Streaming cut-simulate-knit over the global QPD label space.

Port of the JAX package's ``ops/streamed.py`` for the ``engine="pallas"``
exact path: the global labels (cartesian product over all vgates, last
vgate fastest — reference qvm/virtual_circuit.py:133-137) are processed in
fixed-size chunks, and per chunk

    carry[d1, ..., dF]  +=  sum_c  prod_f  E_f[c, d_f]

where each fragment's folded rows ``E_f`` come from the variant kernel
(ops/variant_kernel.py).  The chunk loop is a Python loop over device
work; the carry contraction is a plain ``torch.einsum`` outside the
kernel, in float32 (PyTorch's default ``allow_tf32=False`` keeps it full
precision).

Refused here with NotImplementedError (ROADMAP H100 port, queue A):
trajectory noise, certified truncation, shared-prefix ancestor banks,
bf16 states and shot sampling.  The streamed scan without the kernel and
carry checkpoints are not ported either.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..convert import resolve_device, to_device
from ..utils.logger import get_logger
from ..virt.virtual_circuit import VirtualCircuit
from .bits import permute_bits_flat
from .knit import smolin_project
from .statevector import Distribution
from .variant_engine import label_strides, variant_index_table
from .variant_kernel import make_folded_chunk_kernel

_ITEM = "ROADMAP H100 port, queue A, 'other engines'"


def _refuse(what: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to the torch package yet: {_ITEM}"
    )


def make_streamed_knit(
    virt: VirtualCircuit, chunk: int = 512, keep_clbits=None,
    noise=None, z_clbits=None, share_prefix: bool = False, dtype=None,
    trunc_eps: float = 0.0, device=None,
):
    """Build ``(step_fn, xs, meta)``: ``step_fn(xs)`` runs every global
    label chunk and returns the flat knitted quasi-distribution values
    (a float32 tensor on ``device``, None = "cuda").

    ``xs`` = ``(vidx [n_chunks, chunk, num_vgates] int64, valid
    [n_chunks, chunk] float32)``, both on the device: per-label variant
    indices plus a validity mask for the padded tail.  Every fragment's
    rows come from the variant kernel with the fold in-kernel
    (``keep_clbits``: marginal knit; ``z_clbits``: every data bit
    contracted, signed on the support).  ``meta`` carries ``carry_shape``,
    ``segment_fn`` and ``finish_fn``: ``finish_fn(segment_fn(carry,
    xs_seg))`` == ``step_fn(xs)`` when the segments tile all chunks."""
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
    for name in frag_names:
        rows_fn, kept = make_folded_chunk_kernel(
            virt, name, chunk, keep_clbits=keep_clbits, z_clbits=z_clbits,
            device=dev,
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
    }
    get_logger(__name__).info(
        f"engine='pallas': variant kernel backs {frag_names}"
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
