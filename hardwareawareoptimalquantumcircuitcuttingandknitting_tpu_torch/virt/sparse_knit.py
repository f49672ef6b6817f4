"""Sparse dict-algebra knit — the reference's knitting algorithm, 1:1.

The TPU pipeline knits with dense tensor contractions (ops/knit.py); this
module reproduces the reference's host-side algorithm on the sparse
:class:`QuasiDistr` (qvm/virtual_circuit.py:50-68 + quasi_distr.py:45-60):
per global label, XOR-merge the fragments' variant distributions, then
reduce vgate-by-vgate in reverse order, splitting on the vgate's clbit
and summing with the signed knit coefficients.  It exists for API parity
and as an independent differential oracle for the tensor path.

Port of the JAX package's ``virt/sparse_knit.py``: the knit is its host
code; the sampled rows come from the card (see
:func:`sampled_sparse_fragment_rows`).
"""
from __future__ import annotations

import numpy as np

from .quasi_distr import QuasiDistr
from .virtual_circuit import VirtualCircuit


def _fragment_sparse_rows(res, prune: float) -> list[QuasiDistr]:
    """FragmentResult rows (numpy, or a tensor on any device) -> sparse
    distrs keyed on *global* clbits."""
    rows = []
    values = res.values
    values = values.cpu().numpy() if hasattr(values, "cpu") else \
        np.asarray(values)
    for v in range(values.shape[0]):
        pairs = {}
        row = values[v]
        for i in np.nonzero(np.abs(row) > prune)[0]:
            key = 0
            for j, p in enumerate(res.bit_positions):
                if (int(i) >> j) & 1:
                    key |= 1 << p
            pairs[key] = float(row[i])
        rows.append(QuasiDistr.from_pairs(pairs, prune=0.0))
    return rows


def sampled_sparse_fragment_rows(
    virt: VirtualCircuit,
    frag_name: str,
    shots: int,
    seed: int = 0,
    chunk_size: int = 256,
    device=None,
) -> list[QuasiDistr]:
    """Stream one fragment's variant rows chunk-by-chunk, multinomially
    sample each at ``shots``, and return global-clbit-keyed sparse rows.

    Constant memory in the variant count — for sup-25-class fragments the
    dense ``[V, 2^18]`` row matrix cannot materialise, but each sampled
    row carries at most ``shots`` keys.  This is bit-for-bit the
    reference's data path: per-instance Aer ``counts`` ->
    ``QuasiDistr.from_counts`` (qvm/run.py:42-57).

    The rows of a chunk are computed on ``device`` (None = "cuda", raises
    without a card): kernel 2's full rows (``ops/variant_kernel.
    make_chunk_kernel``) where the fragment fits the kernel (at most 20
    simulated qubits), otherwise ``variant_engine.gather_variant_rows``
    over ``make_sim_fn`` without a kernel, a route the log names (the
    sampled engine's rule).  Each chunk's rows are fetched and drawn on
    the host from ``default_rng(seed)`` in the JAX package's order."""
    import torch

    from ..convert import resolve_device, to_device
    from ..ops.variant_engine import (
        _slot_tables,
        chunk_cap,
        gather_variant_rows,
        label_strides,
        make_sim_fn,
        variant_index_table,
    )
    from ..ops.variant_kernel import make_chunk_kernel
    from ..utils.logger import get_logger

    dev = resolve_device(device)
    # build_matrices=False: the O(flat_count x slots x ~384 B) host
    # gather would be hundreds of MB for the sup-25-class fan-outs this
    # function exists for — gather per chunk instead (chunk x slots)
    sim_fn, _, positions, flat_count = make_sim_fn(
        virt, frag_name, build_matrices=False
    )
    prog = virt.programs[frag_name]
    rng = np.random.default_rng(seed)
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, _fc = label_strides(specs, prog.touching)
    slot_g = [slot.vgate_idx for slot in prog.slots]

    chunk = min(chunk_size, flat_count, chunk_cap(prog.num_sim_qubits))
    n_chunks = -(-flat_count // chunk)
    padded = n_chunks * chunk
    vidx = variant_index_table(
        prog.touching, strides, n_inst, padded, clamp_to=flat_count
    )
    touch_col = {g: i for i, g in enumerate(prog.touching)}
    bit_masks = np.array(
        [sum(1 << p for j, p in enumerate(positions) if (i >> j) & 1)
         for i in range(1 << len(positions))],
        dtype=np.int64,
    ) if positions else np.zeros(1, np.int64)

    def _sample_row(r: np.ndarray) -> QuasiDistr:
        p = np.clip(np.asarray(r, dtype=np.float64), 0.0, None)
        counts = rng.multinomial(shots, p / p.sum())
        nz = np.nonzero(counts)[0]
        keys = bit_masks[nz]
        order = np.argsort(keys, kind="stable")
        return QuasiDistr(keys[order], (counts[nz] / shots)[order])

    rows: list[QuasiDistr] = []
    if not prog.slots:
        row = sim_fn([], dev)[0].cpu().numpy()
        return [_sample_row(row) for _ in range(flat_count)]

    built = make_chunk_kernel(virt, frag_name, chunk, device=dev)
    vidx_dev = torch.as_tensor(vidx, dtype=torch.int64, device=dev)
    if built is not None:
        rows_fn = built[0]
        cols = torch.as_tensor(list(prog.touching), dtype=torch.int64,
                               device=dev)
        lab = torch.zeros((chunk, len(specs)), dtype=torch.int64,
                          device=dev)

        def chunk_rows(v):
            # the kernel reads a label matrix over every vgate column
            lab[:, cols] = v
            return rows_fn(lab)
    else:
        get_logger(__name__).info(
            f"sparse rows of {frag_name}: {prog.num_sim_qubits} simulated "
            "qubits, past the variant kernel's gate: rows without a kernel"
        )
        tables = [to_device(list(t), dev)
                  for t in _slot_tables(prog, specs)]
        slot_cols = [touch_col[g] for g in slot_g]

        def chunk_rows(v):
            return gather_variant_rows(sim_fn, tables, slot_cols, v, chunk)

    for i in range(n_chunks):
        vals = chunk_rows(vidx_dev[i * chunk:(i + 1) * chunk]).cpu().numpy()
        for r in vals:
            if len(rows) >= flat_count:
                break
            rows.append(_sample_row(r))
    return rows


def sparse_knit(
    virt: VirtualCircuit, results: list = None, prune: float = 0.0,
    rows: dict | None = None,
) -> QuasiDistr:
    """Knit fragment results with the reference's sparse algorithm.

    ``results``: FragmentResults from the variant engine (exact rows or
    shot-sampled); alternatively ``rows`` maps fragment name -> prebuilt
    sparse rows (see :func:`sampled_sparse_fragment_rows`).  Returns the
    quasi-distribution over the original clbits, keys little-endian over
    global clbit positions.
    """
    from ..ops.variant_engine import label_strides

    specs = [vg.spec for vg in virt.vgates]
    num_g = len(specs)
    # global label order: all-vgate cartesian product, last fastest
    gstride, _gn, total = label_strides(specs, range(num_g))

    frag_rows = []
    frag_meta = []
    if rows is not None:
        missing = [
            reg.name for reg in virt.fragments if reg.name not in rows
        ]
        assert not missing, f"rows missing fragments: {missing}"
        names = [reg.name for reg in virt.fragments]
    else:
        if results is None:
            raise ValueError("sparse_knit needs either results or rows")
        names = [res.name for res in results]
        missing = [
            reg.name for reg in virt.fragments if reg.name not in names
        ]
        # a fragment absent from results would silently drop its clbits
        # from every merged key (cf. the rows-path assert above)
        assert not missing, f"results missing fragments: {missing}"
    for idx, name in enumerate(names):
        if rows is not None:
            frag_rows.append(rows[name])
        else:
            frag_rows.append(_fragment_sparse_rows(results[idx], prune))
        prog = virt.programs[name]
        strides, _n_inst, _ = label_strides(specs, prog.touching)
        frag_meta.append((list(prog.touching), strides))

    # merge across fragments per global label (quasi_distr.py:55-60)
    merged: list[QuasiDistr] = []
    for label in range(total):
        distr: QuasiDistr | None = None
        for frow, (touching, strides) in zip(frag_rows, frag_meta):
            local = 0
            for g in touching:
                digit = (
                    label // gstride[g]
                ) % specs[g].num_instantiations
                local += digit * strides[g]
            distr = (
                frow[local] if distr is None else distr.merge(frow[local])
            )
        merged.append(distr if distr is not None else QuasiDistr.from_pairs({}))

    # reverse per-vgate signed reduction (virtual_circuit.py:50-68)
    for g in reversed(range(num_g)):
        spec = specs[g]
        clbit = virt.num_clbits + g
        n = spec.num_instantiations
        reduced: list[QuasiDistr] = []
        for start in range(0, len(merged), n):
            acc: QuasiDistr | None = None
            for v in range(n):
                zeros, ones = merged[start + v].split(clbit)
                c0, c1 = spec.coef[v]
                term = zeros * float(c0) + ones * float(c1)
                acc = term if acc is None else acc + term
            reduced.append(acc)
        merged = reduced

    assert len(merged) == 1
    return merged[0]
