"""Sharded fragment execution: variant x amplitude co-sharding.

Port of the JAX package's ``ops/sharded_fragment.py`` over a
process-group mesh (parallel/mesh.py) in place of ``shard_map``: one
fragment's whole QPD variant fan-out runs on a 2D mesh ``(dp, amp)``
with

  * the *variant* axis split over ``dp`` — each rank simulates a
    contiguous slice of the 6^g * 8^w instantiations;
  * the *amplitude* axis split over ``amp`` — each rank holds a ``[2,
    2^(n-k)]`` block of every variant's statevector, gates on global
    qubits exchanging partner blocks with another rank
    (ops/sharded_sv.ShardCtx).

Per-variant endpoint behaviour enters through data — an int32
variant-index row per label, this rank's dp slice of it; the slot
tables are small device tensors gathered by those indices — and the
clbit marginal is assembled per variant by ``ShardCtx.marginal`` (a
scatter and a sum over ``amp``), so the full per-variant 2^n vector
never leaves the blocks.  The rows of every dp slice are gathered on
every rank (``Mesh.all_gather``, the JAX caller's host pull of the
dp-sharded output).

The JAX package ``vmap``s every dp-local variant at once; here the same
per-variant function runs in chunks of variants bounded by bytes
(``variant_engine.chunk_cap`` of the local width), so a 26-qubit
fragment fits one device.  The variant-independent prefix runs once per
rank and call; the local block stays at its full 2^(n-k) width for the
whole program, as in the JAX package.

The port runs each rank as a process of a ``torch.distributed`` group;
on one device (no process group) the mesh is ``(1, 1)``.  Exchanges
between devices are only as checked as the backend that ran them: the
CPU tests run ``gloo`` worlds of 2 and 4 processes; NCCL exchanges
between cards have not run.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import to_device
from ..parallel.mesh import Mesh, world
from ..virt.virtual_circuit import VirtualCircuit
from .sharded_sv import ShardCtx
from .statevector import to_real_block
from .variant_engine import (
    FragmentResult,
    _slot_tables,
    chunk_cap,
    gather_variant_rows,
    label_strides,
    variant_index_table,
)


def make_sharded_fragment_fn(
    virt: VirtualCircuit,
    frag_name: str,
    mesh: Mesh,
    dp_axis: str = "dp",
    amp_axis: str = "amp",
    dtype=None,
):
    """Build the co-sharded variant-fan-out program for one fragment.

    Returns ``(fn, args, meta)``: ``fn(*args)`` (the args moved to
    ``mesh.device``) yields this rank's ``[V_padded / dp, 2^m]``
    probability rows — its dp slice of the variant axis, replicated over
    ``amp``.  ``args`` are this rank's blocks of the inputs: the |0...0>
    state block ``[2, 2^(n-k)]`` (split over ``amp``) and its rows of the
    per-label variant-index table (split over ``dp``).  ``meta`` carries (positions, flat_count, padded, chunk) for
    FragmentResult assembly; ``chunk`` is the variants a pass
    (``variant_engine.chunk_cap`` of the local width).

    ``dtype``: ``torch.bfloat16`` is the quantized serving mode — local
    state blocks AND the partner exchanges move half the bytes; the
    clbit marginal still accumulates in f32 (ShardCtx.marginal
    upcasts)."""
    prog = virt.programs[frag_name]
    specs = [vg.spec for vg in virt.vgates]

    strides, n_inst, flat_count = label_strides(specs, prog.touching)

    positions = sorted(prog.clbit_sources)
    sources = [prog.clbit_sources[c] for c in positions]
    n = prog.num_sim_qubits
    if amp_axis not in mesh.shape or dp_axis not in mesh.shape:
        raise ValueError(
            f"engine='sharded' needs a mesh with ({dp_axis!r}, "
            f"{amp_axis!r}) axes, got {tuple(mesh.shape)} — "
            "parallel.mesh.make_mesh builds the (dp, tp) KNIT mesh; use "
            "ops.sharded_fragment.fragment_mesh (or mesh=None) here"
        )
    amp = mesh.shape[amp_axis]
    dp = mesh.shape[dp_axis]
    if amp > (1 << n):
        raise ValueError(
            f"fragment {frag_name}: {amp} amp shards > 2^{n} amplitudes"
        )
    ctx = ShardCtx(n, mesh, amp_axis)
    _dt = torch.float32 if dtype is None else dtype
    dev = mesh.device

    # exact path: fuse contiguous fixed-gate runs between slots
    from .fusion import fused_stream

    skeleton, mats = fused_stream(prog.ops)
    prog_ops = []
    bi = 0
    for op in skeleton:
        if op[0] == "u":
            prog_ops.append(("u", to_real_block(mats[bi]), op[1]))
            bi += 1
        else:
            prog_ops.append(op)

    # prefix sharing: ops before the FIRST slot are identical across the
    # whole variant fan-out — applied once per rank per call (not per
    # variant), sharded like everything else
    first_slot = next(
        (i for i, op in enumerate(prog_ops) if op[0] != "u"),
        len(prog_ops),
    )
    prefix_ops, suffix_ops = prog_ops[:first_slot], prog_ops[first_slot:]

    def apply_prefix(local_state0, my_bits):
        state = local_state0
        for op in prefix_ops:
            state = ctx.apply(state, op[1], op[2], my_bits)
        return state

    # the slot tables: per slot (pre, meas4, post) [nI, 2, k, 2, k] in the
    # states' dtype, with each table's host-known nonzero pattern
    host_tables = _slot_tables(prog, specs)
    tables = [to_device(list(t), dev, _dt) for t in host_tables]
    masks = [tuple(np.any(np.asarray(m) != 0, axis=0) for m in t)
             for t in host_tables]
    kinds = {"slot_pre": 0, "slot_meas": 1, "slot_post": 2}

    def sim_one(slot_mats, prefix_state, my_bits):
        state = prefix_state
        for op in suffix_ops:
            if op[0] == "u":
                state = ctx.apply(state, op[1], op[2], my_bits)
            else:
                sid, j = op[1], kinds[op[0]]
                state = ctx.apply(state, slot_mats[sid][j], op[2], my_bits,
                                  masks[sid][j])
        return ctx.marginal(state, sources)  # summed over amp -> [V, 2^m]

    # per-label variant index of every touching vgate (the only sharded
    # payload: 4 B x #touching per label)
    padded = -(-flat_count // dp) * dp
    touch_col = {g: i for i, g in enumerate(prog.touching)}
    vidx = variant_index_table(
        prog.touching, strides, n_inst, padded, clamp_to=flat_count
    )
    slot_cols = [touch_col[slot.vgate_idx] for slot in prog.slots]
    local = padded // dp
    chunk = max(1, min(chunk_cap(n - ctx.k), local))

    n_slots = len(prog.slots)
    if mesh.member:
        d, a = mesh.index(dp_axis), mesh.index(amp_axis)
    else:
        d = a = 0
    state0 = np.zeros((2, 1 << (n - ctx.k)), dtype=np.float32)
    if a == 0:
        state0[0, 0] = 1.0
    vidx_local = vidx[d * local:(d + 1) * local]

    def per_device(state0_local, vidx_local):
        my_bits = ctx.my_bits()
        prefix = apply_prefix(state0_local.to(_dt)[None], my_bits)
        if not n_slots:
            row = ctx.marginal(prefix, sources)
            return row.expand(max(1, local), row.shape[1])
        return gather_variant_rows(
            lambda mats: sim_one(
                mats, prefix.expand(mats[0][0].shape[0], -1, -1), my_bits),
            tables, slot_cols, vidx_local, chunk)

    args = [state0, vidx_local]
    meta = {"positions": positions, "flat_count": flat_count,
            "padded": padded, "chunk": chunk}
    return per_device, args, meta


def run_fragment_sharded(
    virt: VirtualCircuit, frag_name: str, mesh: Mesh,
    dp_axis: str = "dp", amp_axis: str = "amp", dtype=None,
) -> FragmentResult:
    """Execute one fragment's full variant fan-out co-sharded over
    ``mesh`` and return its FragmentResult (rows on ``mesh.device``, on
    every rank of the world: a rank outside the mesh receives them from
    the mesh's first rank)."""
    fn, args, meta = make_sharded_fragment_fn(
        virt, frag_name, mesh, dp_axis, amp_axis, dtype=dtype,
    )
    prog = virt.programs[frag_name]
    width = 1 << len(meta["positions"])
    if mesh.member:
        local = fn(*(torch.as_tensor(a, device=mesh.device) for a in args))
        rows = mesh.all_gather(local.contiguous(), dp_axis)
    else:
        rows = torch.empty((meta["padded"], width), dtype=torch.float32,
                           device=mesh.device)
    rows = mesh.share(rows)[: meta["flat_count"]]
    return FragmentResult(
        frag_name, rows, meta["positions"], list(prog.touching)
    )


def fragment_mesh(
    n_frag_qubits: int,
    max_local_qubits: int | None = None,
    devices=None,
    dp_axis: str = "dp",
    amp_axis: str = "amp",
    device=None,
) -> Mesh:
    """Pick a (dp, amp) mesh for one fragment: shard amplitudes just enough
    that each rank holds <= 2^max_local_qubits of them, and spend the
    remaining ranks on the variant axis.  ``devices``: the world's ranks
    to draw from (default all); the mesh takes the largest power of two
    of them, so one device gives ``(1, 1)`` whatever
    ``max_local_qubits`` is."""
    devices = list(devices if devices is not None else range(world()[0]))
    total = 1 << (len(devices).bit_length() - 1)  # largest power of 2
    if max_local_qubits is None:
        amp = 1
    else:
        amp = 1 << max(0, n_frag_qubits - max_local_qubits)
        amp = min(amp, total)
    dp = total // amp
    arr = np.array(devices[: dp * amp]).reshape(dp, amp)
    return Mesh(arr, (dp_axis, amp_axis), device)


def run_all_fragments_sharded(
    virt: VirtualCircuit,
    max_local_qubits: int | None = None,
    mesh: Mesh | None = None,
    devices=None,
    dtype=None,
    device=None,
) -> list[FragmentResult]:
    """Run every fragment co-sharded.  With ``mesh=None``, each fragment
    gets its own (dp, amp) split from :func:`fragment_mesh` — amplitude
    shards only as deep as its size requires, variants over the rest —
    on ``device`` (the mesh's default when None)."""
    out = []
    for reg in virt.fragments:
        prog = virt.programs[reg.name]
        m = mesh if mesh is not None else fragment_mesh(
            prog.num_sim_qubits, max_local_qubits, devices, device=device
        )
        out.append(run_fragment_sharded(virt, reg.name, m, dtype=dtype))
    return out
