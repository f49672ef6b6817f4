"""Sharded cut-circuit execution: the multi-device path.

Port of the JAX package's ``parallel/sharded.py`` over a process-group
mesh (parallel/mesh.py).  One step computes every fragment's full QPD
variant fan-out and the knit contraction on a ``(dp, tp)`` mesh:

  * the per-label variant-index tables (leading variant axis, int32) are
    split over ``dp`` — each rank simulates a slice of the 6^g * 8^w
    instantiations, gathering its slot blocks on the device from
    per-instantiation tables — and a rank's slice is split again over
    ``tp`` where it divides evenly (else every ``tp`` rank of a ``dp``
    slice simulates all of it, as the JAX package leaves the rows
    unsplit when ``tp`` does not divide them);
  * the rows are gathered (``Mesh.all_gather`` over ``tp``, then ``dp``)
    and knitted on every rank.  The knit is multilinear across
    fragments, so the rows are gathered before the knit; no partial
    knits are added up.

:func:`streamed_values_dp` is the streamed scan's chunk axis over
``dp`` (the JAX package's GSPMD use of ``make_streamed_knit``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..convert import to_device
from ..ops.knit import knit_values
from ..ops.statevector import Distribution
from ..ops.variant_engine import (
    FragmentResult,
    _slot_tables,
    chunk_cap,
    gather_variant_rows,
    label_strides,
    make_sim_fn,
    variant_index_table,
)
from ..virt.virtual_circuit import VirtualCircuit
from .mesh import Mesh


def make_sharded_step(virt: VirtualCircuit, mesh: Mesh, dtype=None):
    """Build ``(step_fn, args, positions)``.  ``step_fn(*args)``
    — one ``[padded, n_touching]`` int32 variant-index array per fragment
    (the whole table, ``padded`` a multiple of dp; each rank reads its
    own rows) — returns the knitted quasi-distribution values on
    ``mesh.device``, on every rank of the mesh.

    ``dtype``: ``torch.bfloat16`` is the quantized serving mode — the
    per-variant statevectors at half the bytes (probability rows and the
    knit stay f32; same contract as the streamed engine)."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    d, t = mesh.index("dp"), mesh.index("tp")
    dev = mesh.device
    specs = [vg.spec for vg in virt.vgates]
    frag_meta = []
    flat_args: list[np.ndarray] = []
    for reg in virt.fragments:
        prog = virt.programs[reg.name]
        sim_one, _, positions, flat_count = make_sim_fn(
            virt, reg.name, build_matrices=False, fused_slots=True,
            dtype=dtype,
        )
        strides, n_inst, _fc = label_strides(specs, prog.touching)
        padded = -(-flat_count // dp) * dp
        touch_col = {g: i for i, g in enumerate(prog.touching)}
        vidx = variant_index_table(
            prog.touching, strides, n_inst, padded, clamp_to=flat_count
        )
        tables = [to_device(list(tabs), dev, dtype)
                  for tabs in _slot_tables(prog, specs, fused=True)]
        slot_cols = [touch_col[s.vgate_idx] for s in prog.slots]
        frag_meta.append((reg.name, sim_one, positions, flat_count, tables,
                          slot_cols, chunk_cap(prog.num_sim_qubits)))
        flat_args.append(vidx)

    def step_fn(*args):
        results = []
        for (name, sim_one, positions, flat_count, tables, slot_cols,
             cap), vidx in zip(frag_meta, args):
            if not slot_cols:
                row = sim_one([], dev)
                rows = row.expand(max(1, flat_count), row.shape[1])
            else:
                local = vidx.shape[0] // dp
                split = tp > 1 and local % tp == 0
                per = local // tp if split else local
                lo = d * local + (t * per if split else 0)
                mine = torch.as_tensor(vidx[lo:lo + per], device=dev)
                rows = gather_variant_rows(sim_one, tables, slot_cols,
                                           mine, cap)
                if split:
                    rows = mesh.all_gather(rows, "tp")
                rows = mesh.all_gather(rows, "dp")[:flat_count]
            results.append(FragmentResult(
                name, rows, positions, list(virt.programs[name].touching)
            ))
        values, _positions = knit_values(virt, results)
        return values

    # positions are static — recompute once for callers
    positions = _knit_positions(virt)
    return step_fn, flat_args, positions


def _knit_positions(virt: VirtualCircuit) -> list[int]:
    pos: set[int] = set()
    for reg in virt.fragments:
        for c in virt.programs[reg.name].clbit_sources:
            if c < virt.num_clbits:
                pos.add(c)
    return sorted(pos)


def run_virtual_circuit_sharded(
    virt: VirtualCircuit, mesh: Mesh
) -> Distribution:
    """Convenience wrapper: build, execute, fetch, wrap."""
    step_fn, args, positions = make_sharded_step(virt, mesh)
    values = step_fn(*args)
    return Distribution(values.cpu().numpy(), positions, virt.num_clbits)


def streamed_values_dp(meta, xs, mesh: Mesh) -> torch.Tensor:
    """The streamed scan with its chunk axis split over ``dp``: this
    rank runs its contiguous segment of the label chunks
    (``meta["segment_fn"]`` of ``ops.streamed.make_streamed_knit`` on
    the segment's slice of every entry of ``xs``, all of which have the
    chunk axis first), the carries are summed over ``dp``
    (``Mesh.all_reduce``) and finished into the flat knitted values on
    every rank.

    This stands for the JAX idiom ``jax.jit(step)(xs)`` with ``xs``
    sharded over "dp" on the chunk axis under GSPMD and the scan carry
    ``psum``-ed (JAX ``ops/streamed.py`` module docstring,
    ``tests/test_streamed_sharded.py``).  Works with the route without a
    kernel (ancestor banks on or off: a rank builds its own banks) and
    the kernel route (``pallas_variant=True``)."""
    n = meta["n_chunks"]
    dp = mesh.shape["dp"]
    per = math.ceil(n / dp)
    lo = min(n, mesh.index("dp") * per)
    hi = min(n, lo + per)
    carry = torch.zeros(meta["carry_shape"], dtype=torch.float32,
                        device=xs[0].device)
    if hi > lo:
        carry = meta["segment_fn"](carry, tuple(a[lo:hi] for a in xs))
    return meta["finish_fn"](mesh.all_reduce(carry, "dp"))
