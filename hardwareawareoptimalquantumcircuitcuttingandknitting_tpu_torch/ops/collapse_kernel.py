"""Collapse-mode whole-variant kernel for the sampled engine.

Counterpart of the JAX package's ``ops/pallas_variant.py`` collapse kernel
(``_build_call_collapse``, entered through ``make_collapse_chunk_kernel``).
Per sampled QPD label of a block: shared prefix state -> suffix of fixed
1q/2q gates, 1q slot gates with the label's own entries, and collapse
sites (the vgate measurement done in the simulation: Born sums, a branch
picked by the label's uniform draw, projection, rescale, fold weight) ->
``|psi|^2`` times the product of the picked weights, as full rows, as the
marginal over kept clbits, or as signed Z-parity sums.  The state stays at
the fragment's active qubits however many cuts measure (the deferral
ancillas never appear).

Three layers, as in ``ops/variant_kernel.py``:

* the host build (:func:`build_plan`): the collapse stream of
  ``variant_engine.collapse_stream`` at full width, the prefix run once on
  the host, the suffix as an op table (``variant_kernel.OpTable`` rows,
  one extra row kind for a collapse site), that table rewritten by
  ``ops/op_rewrite`` for the kernel (identities dropped, diagonal runs
  merged, each site fused with its slot gates) and the epilogue's bit
  maps;
* :func:`collapse_rows`, the wrapper: on CUDA tensors it finds the block's
  replica runs (:func:`find_runs`) and launches the hand-written kernel in
  ``csrc/collapse_kernel.cu`` (built with ``nvcc`` for ``sm_90a`` at first
  use into ``build/``, loaded with ``ctypes``) and counts the launch; on
  CPU tensors it runs :func:`plain_collapse_rows`;
* :func:`plain_collapse_rows`, the plain PyTorch version of the same
  function (the original table, every label from the prefix; the
  kernel's formula: ``p0 = tot - p1``), used on the CPU and as the
  kernel's reference on the card.

Not carried over from the TPU kernel, because they are artefacts of its
lanes: the ``n >= 8`` gate (128 lanes), the ``batch`` argument (labels
stacked on row bits) and the staged lane broadcasts.  One CUDA launch
covers every label of a block at any width from 1 to 20 qubits, so this
kernel serves every collapse-mode fragment: up to 14 qubits in one CTA's
shared memory, 15 in a cluster of two, 16 to 20 in global scratch.  Kept as the contract: the
in-kernel marginal and the Z columns exist up to 128 outcomes / columns;
past that the caller takes full rows and reduces them in torch.

What bounds the kernel on an H100 and what its design does about it is
written at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import resolve_device, to_device
from ..utils.profiling import span
from ..virt.virtual_circuit import VirtualCircuit
from . import op_rewrite
from .kernel_build import KernelLibrary, check_tensor
from .op_rewrite import OP_SITE_A, OP_SITE_B
from .statevector import apply_matrix_host, marginalize_flat
from .variant_engine import collapse_stream, splice_zero_bits
from .variant_kernel import (
    OpTable,
    SlotEntries,
    apply_op_plain,
    generic_ops,
    launch_geometry,
    op_costs,
)

MAX_QUBITS = 20      # per-block state in global scratch: 8 MB at n = 20
MAX_OUTCOMES = 128   # in-kernel marginal outcomes / z columns (the contract)
RUN_CAP = 64         # replicas a run holds: a heavy label spreads over CTAs
_MODES = {"rows": 0, "marginal": 1, "z": 2}


@dataclass
class CollapsePlan:
    """Host build of one fragment's collapse kernel.

    ``ops`` / ``fixed`` / the entry tables are an :class:`OpTable`'s
    (collapse rows: ``(0, flat bit, site index, 0)``).  ``site_meta`` lists
    ``(slot id, global vgate id)`` per collapse site in op order: the
    order of the per-label scalar block ``[C, n_sites, 4]`` (u, mflag, w0,
    w1) and of the picked bits.  ``active``: the fragment qubits that occur
    in an op, ascending (active qubit ``i`` sits on flat bit ``n-1-i``);
    ``positions`` / ``sources``: the data clbits written here and their
    qubits.  ``mode``: ``"rows"`` (full ``[2^n]`` rows), ``"marginal"``
    (``kept`` clbits, ``marg_bits[j]`` = flat bit of ``kept[j]`` or None
    for a source that saw no op) or ``"z"`` (``z_masks[i]`` = flat-bit
    mask of z-set ``i``; the last column is the plain total).  ``table``:
    what the kernel interprets, the suffix rewritten by ``ops/op_rewrite``;
    ``site_rows[s]``: the row of its ``OP_SITE_B`` for site ``s``."""

    n: int
    prefix: np.ndarray
    ops: np.ndarray
    fixed: np.ndarray
    entry_tables: list
    entry_gids: list
    entry_stride: int
    site_meta: list
    active: list
    positions: list
    sources: list
    mode: str
    table: op_rewrite.Table
    site_rows: list
    kept: list | None = None
    marg_bits: list | None = None
    z_masks: list | None = None

    @property
    def n_sites(self) -> int:
        return max(1, len(self.site_meta))

    @property
    def real_bits(self) -> list:
        """Marginal mode: the kept clbits' flat bits that exist."""
        return [b for b in self.marg_bits if b is not None]

    @property
    def out_width(self) -> int:
        if self.mode == "rows":
            return 1 << self.n
        if self.mode == "marginal":
            return 1 << len(self.kept)
        return len(self.z_masks) + 1


def build_plan(virt: VirtualCircuit, frag_name: str, keep_clbits=None,
               z_sets=None) -> CollapsePlan | None:
    """Host build of the collapse kernel for one fragment.
    ``keep_clbits``: the in-kernel marginal over the fragment's data
    clbits in the set; ``z_sets``: the in-kernel Z columns (exclusive).
    Returns None where the kernel does not serve the request: more than
    ``MAX_OUTCOMES`` kept outcomes or z columns, or a state past
    ``MAX_QUBITS``."""
    if keep_clbits is not None and z_sets is not None:
        raise ValueError("keep_clbits and z_sets are exclusive")
    prefix_ops, suffix, active, positions, sources = collapse_stream(
        virt, frag_name
    )
    prog = virt.programs[frag_name]
    n = len(active)
    if n > MAX_QUBITS:
        return None
    index = {q: i for i, q in enumerate(active)}

    def flat_of(q):
        return n - 1 - index[q] if q in index else None

    mode, kept, marg_bits, z_masks = "rows", None, None, None
    if keep_clbits is not None:
        keep_set = set(keep_clbits)
        kept = [p for p in positions if p in keep_set]
        if (1 << len(kept)) > MAX_OUTCOMES:
            return None
        mode = "marginal"
        marg_bits = [flat_of(sources[positions.index(p)]) for p in kept]
    elif z_sets is not None:
        if len(z_sets) + 1 > MAX_OUTCOMES:
            return None
        mode = "z"
        z_masks = []
        for s_z in z_sets:
            s_z = set(s_z)
            mask = 0
            for j, p in enumerate(positions):
                fb = flat_of(sources[j])
                if p in s_z and fb is not None:
                    mask |= 1 << fb
            z_masks.append(mask)

    with span("port.build.prefix"):
        st = np.zeros((2, 1 << n), np.float32)
        st[0, 0] = 1.0
        for _, mat, axes in prefix_ops:
            st = apply_matrix_host(st, mat, tuple(index[q] for q in axes),
                                   n)

    table = OpTable(prog, [vg.spec for vg in virt.vgates])
    for op in suffix:
        table.add(op, [n - 1 - index[q] for q in op[2]])
    site_meta = [(sid, prog.slots[sid].vgate_idx) for sid in table.sites]
    ops, fixed = table.ops_array(), table.fixed_array()
    ktable = op_rewrite.rewrite(generic_ops(ops, fixed))
    site_rows = [0] * len(site_meta)
    for i, row in enumerate(ktable.rows.tolist()):
        if row[0] == OP_SITE_B:
            site_rows[row[2]] = i
    return CollapsePlan(
        n=n, prefix=st, ops=ops, fixed=fixed,
        entry_tables=table.entry_tables, entry_gids=table.entry_gids,
        entry_stride=table.entry_stride, site_meta=site_meta,
        active=list(active), positions=list(positions),
        sources=list(sources), mode=mode, table=ktable,
        site_rows=site_rows, kept=kept, marg_bits=marg_bits,
        z_masks=z_masks,
    )


class CollapseDevicePlan:
    """A :class:`CollapsePlan` with its tables on one device."""

    def __init__(self, plan: CollapsePlan, device):
        self.plan = plan
        self.device = torch.device(device)
        self.prefix = to_device(plan.prefix, device)
        self.ops = to_device(
            plan.ops if len(plan.ops) else np.zeros((1, 4), np.int32), device
        )
        self.fixed = to_device(
            plan.fixed if plan.fixed.size else np.zeros(1, np.float32),
            device,
        )
        self._entries = SlotEntries(plan.entry_tables, plan.entry_gids,
                                    device)
        self.rows = to_device(
            plan.table.rows if len(plan.table.rows)
            else np.zeros((1, op_rewrite.ROW), np.int32), device)
        self.pool = to_device(
            plan.table.pool if plan.table.pool.size
            else np.zeros(1, np.float32), device)
        # the resume row of a run: its first measuring site's OP_SITE_B,
        # or past the table when it measures nowhere (first site index
        # n_sites, which is 1 for the dummy column of a siteless plan)
        end = [len(plan.table.rows)] * (plan.n_sites + 1
                                        - len(plan.site_rows))
        self.site_rows = to_device(
            np.asarray(plan.site_rows + end, np.int64), device)
        if plan.mode == "marginal":
            real = plan.real_bits
            epi = real + [b for b in range(plan.n) if b not in real]
        elif plan.mode == "z":
            epi = list(plan.z_masks)
        else:
            epi = []
        self.epi = to_device(np.asarray(epi or [0], np.int32), device)

    def gather_entries(self, lab_chunk: torch.Tensor) -> torch.Tensor:
        """``[C, entry_stride]`` per-label slot entries for a ``[C,
        num_vgates]`` label block (global vgate columns)."""
        return self._entries(lab_chunk)


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def _epilogue_plain(st, weight, plan: CollapsePlan):
    n = plan.n
    sq = (st * st).sum(dim=1)  # [C, 2^n]
    if plan.mode == "rows":
        return sq * weight[:, None]
    if plan.mode == "marginal":
        # flat bit j is qubit n-1-j; marginalize_flat puts axes[0] on the
        # LSB, which is the kept order
        out = marginalize_flat(sq, n, [n - 1 - b for b in plan.real_bits])
        return out * weight[:, None]
    f = torch.arange(1 << n, device=sq.device)
    cols = []
    for mask in plan.z_masks:
        par = torch.zeros_like(f)
        for j in range(n):
            if (mask >> j) & 1:
                par = par ^ ((f >> j) & 1)
        cols.append((sq * (1 - 2 * par).to(sq.dtype)).sum(dim=1))
    cols.append(sq.sum(dim=1))
    return torch.stack(cols, dim=1) * weight[:, None]


def _compact_width(plan: CollapsePlan) -> int:
    """Columns the kernel itself writes: marginal rows come back over
    the kept bits that exist; :func:`_finish` splices the rest."""
    if plan.mode == "marginal":
        return 1 << len(plan.real_bits)
    return plan.out_width


def _finish(out, plan: CollapsePlan):
    if plan.mode == "marginal":
        return splice_zero_bits(out, [b is not None for b in plan.marg_bits])
    return out


def plain_collapse_rows(dp: CollapseDevicePlan, entries, cscal,
                        with_margins: bool = False):
    """The plain PyTorch version of the kernel, on any device:
    ``(rows [C, out_width], bits [C, n_sites] int32)``.  Every label of
    the block runs the suffix from the shared prefix in one batch; a
    collapse site follows the kernel's formula (``tot``, ``p1``, ``p0 =
    tot - p1``, ``b = u * tot >= p0``).  ``bits`` holds the picked branch
    per site, -1 where the label's variant does not measure there.
    ``with_margins``: a third result ``[C, n_sites]``, the distance of
    each pick from its threshold, ``|u * tot - p0| / tot`` (see
    :func:`compare_picks`)."""
    plan = dp.plan
    n, big = plan.n, 1 << plan.n
    c = entries.shape[0]
    dev = entries.device
    st = dp.prefix.to(dev).expand(c, 2, big)
    weight = torch.ones(c, dtype=torch.float32, device=dev)
    bits = torch.full((c, plan.n_sites), -1, dtype=torch.int32, device=dev)
    margins = torch.full((c, plan.n_sites), float("inf"),
                         dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    for row in plan.ops:
        nq, ja, jb, _ = (int(v) for v in row)
        if nq != 0:
            st = apply_op_plain(st, row, n, plan.fixed, entries)
            continue
        sq = (st * st).sum(dim=1)
        tot = sq.sum(dim=1)
        p1 = sq.reshape(c, big >> (ja + 1), 2, 1 << ja)[:, :, 1].sum(
            dim=(1, 2)
        )
        p0 = tot - p1
        u, mflag, w0, w1 = cscal[:, jb].unbind(dim=1)
        pick = u * tot >= p0
        bf = pick.to(torch.float32)
        pb = p0 + bf * (p1 - p0)
        scale = torch.sqrt(tot / torch.clamp(pb, min=1e-30))
        on = mflag > 0
        bitval = ((torch.arange(big, device=dev) >> ja) & 1).bool()
        keep = (bitval[None, :] == pick[:, None]).to(torch.float32)
        fac = torch.where(on[:, None], keep * scale[:, None], one)
        st = st * fac[:, None, :]
        weight = weight * torch.where(on, w0 + bf * (w1 - w0), one)
        bits[:, jb] = torch.where(on, pick.to(torch.int32),
                                  torch.full_like(bits[:, jb], -1))
        margins[:, jb] = (u * tot - p0).abs() / torch.clamp(tot, min=1e-30)
    rows = _finish(_epilogue_plain(st, weight, plan), plan)
    return (rows, bits, margins) if with_margins else (rows, bits)


def compare_picks(bits, plain_bits, margins, tol: float = 1e-6):
    """Hold a kernel's picked branches against the plain version's:
    ``(agree [C] bool, near, far)``.  The two sum ``|psi|^2`` in different
    orders, so a label whose draw lies within rounding of a threshold can
    take the other branch, and then its whole row differs.  ``agree``
    marks the labels whose picks are all equal (their rows are compared
    to the tolerance); ``near`` counts the others whose first differing
    site lies within ``tol`` of its threshold (``margins`` from
    :func:`plain_collapse_rows`), ``far`` those that do not: a fault."""
    differ = bits != plain_bits
    agree = ~differ.any(dim=1)
    first = differ.to(torch.int8).argmax(dim=1)
    at_first = margins.gather(1, first[:, None])[:, 0]
    near = int((~agree & (at_first <= tol)).sum())
    far = int((~agree & (at_first > tol)).sum())
    return agree, near, far


def _entry_gate(st, j: int, off: int, n: int, entries):
    """The 1q gate at entry offset ``off`` of each label's row, on bit
    ``j``."""
    return op_rewrite.apply_row(st, (op_rewrite.OP_GATE1, j, 0, -1 - off),
                                n, None, entries)


def replay_kernel_table(dp: CollapseDevicePlan, entries, cscal):
    """What the kernel computes, replayed in plain PyTorch: every label
    from the prefix through the rewritten table (``plan.table``), with the
    kernel's formula at each ``OP_SITE_A`` / ``OP_SITE_B`` pair.  Returns
    ``(rows, bits)`` like :func:`plain_collapse_rows`; tests hold the two
    together, which replay different tables."""
    plan = dp.plan
    n, big = plan.n, 1 << plan.n
    c = entries.shape[0]
    dev = entries.device
    st = dp.prefix.to(dev).expand(c, 2, big)
    weight = torch.ones(c, dtype=torch.float32, device=dev)
    bits = torch.full((c, plan.n_sites), -1, dtype=torch.int32, device=dev)
    sums = {}
    one = torch.ones((), dtype=torch.float32, device=dev)

    def site(st, row):
        nonlocal weight
        kind, j, s, pre, post = (int(v) for v in row[:5])
        u, mflag, w0, w1 = cscal[:, s].unbind(dim=1)
        on = (mflag > 0)[:, None, None]
        if kind == OP_SITE_A:
            x = st if pre < 0 else _entry_gate(st, j, pre, n, entries)
            y = x if post < 0 else _entry_gate(x, j, post, n, entries)
            sq = (x * x).sum(dim=1)
            sums["tot"] = sq.sum(dim=1)
            sums["p1"] = sq.reshape(c, big >> (j + 1), 2, 1 << j)[
                :, :, 1].sum(dim=(1, 2))
            return torch.where(on, x, y)
        tot, p1 = sums["tot"], sums["p1"]
        p0 = tot - p1
        pick = u * tot >= p0
        bf = pick.to(torch.float32)
        scale = torch.sqrt(tot / torch.clamp(p0 + bf * (p1 - p0), min=1e-30))
        bitval = ((torch.arange(big, device=dev) >> j) & 1).bool()
        keep = (bitval[None, :] == pick[:, None]).to(torch.float32)
        x = st * (keep * scale[:, None])[:, None, :]
        if post >= 0:
            x = _entry_gate(x, j, post, n, entries)
        m = mflag > 0
        weight = weight * torch.where(m, w0 + bf * (w1 - w0), one)
        bits[:, s] = torch.where(m, pick.to(torch.int32),
                                 torch.full_like(bits[:, s], -1))
        return torch.where(on, x, st)

    st = op_rewrite.replay(st, plan.table, n, entries=entries, special=site)
    return _finish(_epilogue_plain(st, weight, plan), plan), bits


def _run_heads(entries, cscal, cap: int) -> torch.Tensor:
    """``[C]`` bool: the rows that open a replica run (see
    :func:`find_runs`)."""
    c = cscal.shape[0]
    dev = entries.device
    key = torch.cat([entries, cscal[:, :, 1:].reshape(c, -1)], dim=1)
    new = torch.ones(c, dtype=torch.bool, device=dev)
    new[1:] = (key[1:] != key[:-1]).any(dim=1)
    idx = torch.arange(c, device=dev)
    head = torch.cummax(torch.where(new, idx, torch.zeros_like(idx)),
                        dim=0).values
    return new | ((idx - head) % cap == 0)


def _first_sites(cscal, starts) -> torch.Tensor:
    """Per run start, its first site with ``mflag > 0`` (``n_sites``
    where none is)."""
    meas = cscal[starts, :, 1] > 0
    return torch.where(meas.any(dim=1), meas.to(torch.int8).argmax(dim=1),
                       torch.full_like(starts, cscal.shape[1]))


def find_runs(entries, cscal, cap: int = RUN_CAP):
    """The replica runs of a label block, on its device: ``[R, 3]`` int64
    rows ``(first row, length, first measuring site)``.  A run is adjacent
    rows with equal entries and equal site scalars but the draw ``u``
    (``mflag``, ``w0``, ``w1``), at most ``cap`` long; its first measuring
    site is the first with ``mflag > 0`` (``n_sites`` where none is)."""
    c = cscal.shape[0]
    starts = torch.nonzero(_run_heads(entries, cscal, cap))[:, 0]
    lens = torch.diff(starts, append=torch.full((1,), c,
                                                device=starts.device))
    return torch.stack([starts, lens, _first_sites(cscal, starts)], dim=1)


def run_table(dp: CollapseDevicePlan, entries, cscal, cap: int = RUN_CAP):
    """The kernel's run table, built on the device with no wait for it:
    ``(table [C, 3] int32, count [1] int32)``.  The first ``count`` rows
    hold the runs of :func:`find_runs`, largest first (the kernel hands
    them out in that order with a grid stride): first row, length, and
    the table row the run resumes at, the ``OP_SITE_B`` of its first
    measuring site (past the table where none measures).  The rest are
    empty runs."""
    c = cscal.shape[0]
    dev = entries.device
    new = _run_heads(entries, cscal, cap)
    rid = torch.cumsum(new, dim=0) - 1
    idx = torch.arange(c, device=dev)
    # run r's first row at starts[r]; rows that open no run land past the
    # end, and starts[R] keeps its fill c, the end of the last run
    starts = torch.full((c + 2,), c, dtype=torch.int64, device=dev)
    starts.scatter_(0, torch.where(new, rid, c + 1), idx)
    starts = starts[:c + 1]
    lens = starts[1:] - starts[:-1]                 # 0 past the last run
    first = _first_sites(cscal, starts[:-1].clamp(max=c - 1))
    order = torch.argsort(lens, descending=True, stable=True)
    table = torch.stack([starts[:-1][order], lens[order],
                         dp.site_rows[first[order]]], dim=1)
    return table.to(torch.int32).contiguous(), (rid[-1:] + 1).to(torch.int32)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.collapse_rows_launch.argtypes = [p] * 11 + [i] * 11 + [p]
    lib.collapse_rows_launch.restype = i
    lib.collapse_kernel_capacity.argtypes = [i] * 3
    lib.collapse_kernel_capacity.restype = i


# csrc/collapse_kernel.cu, built for sm_90a at first launch
LIBRARY = KernelLibrary("collapse_kernel", _bind,
                        "collapse_kernel_error_string")


def _launch(dp: CollapseDevicePlan, entries, cscal):
    lib = LIBRARY.load()
    plan = dp.plan
    dev = entries.device
    c = entries.shape[0]
    check_tensor(entries, "entries", torch.float32,
                 (c, max(1, plan.entry_stride)), dev)
    check_tensor(cscal, "cscal", torch.float32, (c, plan.n_sites, 4), dev)
    for name in ("prefix", "rows", "pool", "site_rows", "epi"):
        if getattr(dp, name).device != dev:
            raise ValueError(f"plan table {name} is not on {dev}")
    if c < 1:
        raise ValueError("an empty label block")
    threads, csize, use_smem = launch_geometry(plan.n)
    big = 1 << plan.n
    smem = (8 * big) // csize if use_smem else 0
    capacity = lib.collapse_kernel_capacity(threads, smem, csize)
    if capacity < 1:
        raise RuntimeError(f"the collapse kernel cannot run at n = {plan.n} "
                           f"({threads} threads, {smem} B of shared memory)")
    # runs no longer than the block spread over every CTA (or cluster)
    # the card holds: a few long runs would leave most of them idle
    cap = max(1, min(RUN_CAP, -(-c // capacity)))
    table, count = run_table(dp, entries, cscal, cap)
    grid = min(c, capacity) * csize
    scratch = None if use_smem else torch.empty(
        (grid * 4 * big,), dtype=torch.float32, device=dev)
    out = torch.empty((c, _compact_width(plan)), dtype=torch.float32,
                      device=dev)
    bits = torch.full((c, plan.n_sites), -1, dtype=torch.int32, device=dev)
    if plan.mode == "marginal":
        n_epi = len(plan.real_bits)
    else:
        n_epi = len(plan.z_masks) if plan.mode == "z" else 0
    rc = lib.collapse_rows_launch(
        dp.prefix.data_ptr(), dp.rows.data_ptr(), dp.pool.data_ptr(),
        entries.data_ptr(), cscal.data_ptr(), dp.epi.data_ptr(),
        table.data_ptr(), count.data_ptr(),
        0 if scratch is None else scratch.data_ptr(),
        out.data_ptr(), bits.data_ptr(), plan.n, len(plan.table.rows), c,
        plan.entry_stride, plan.n_sites, _MODES[plan.mode], n_epi,
        csize, int(use_smem), grid, threads,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "collapse kernel launch failed: " + LIBRARY.error_text(rc)
        )
    collapse_rows.launches += 1
    collapse_rows.last_launch = {"runs": count, "cap": cap, "grid": grid,
                                 "threads": threads, "cluster": csize,
                                 "scratch_bytes": 0 if scratch is None
                                 else 4 * scratch.numel()}
    return _finish(out, plan), bits


def collapse_rows(dp: CollapseDevicePlan, entries, cscal):
    """``(rows [C, out_width], bits [C, n_sites] int32)`` for a block of
    labels.  CUDA tensors launch the hand-written kernel (counted in
    ``collapse_rows.launches``); CPU tensors run
    :func:`plain_collapse_rows`.  Either way ``collapse_rows.rows``
    counts the C trajectory rows computed.  ``entries [C, entry_stride]``
    (from :meth:`CollapseDevicePlan.gather_entries`), ``cscal [C,
    n_sites, 4]`` f32 (u, mflag, w0, w1 per site, in ``plan.site_meta``
    order)."""
    if entries.is_cuda:
        out = _launch(dp, entries, cscal)
    elif entries.device.type != "cpu":
        raise ValueError(f"unsupported device {entries.device}")
    else:
        out = plain_collapse_rows(dp, entries, cscal)
    collapse_rows.rows += entries.shape[0]
    return out


collapse_rows.launches = 0
collapse_rows.rows = 0
collapse_rows.last_launch = None


# ---------------------------------------------------------------------------
# Sampled-engine integration point (the JAX make_collapse_chunk_kernel)
# ---------------------------------------------------------------------------

def make_collapse_chunk_kernel(
    virt: VirtualCircuit, frag_name: str, keep_clbits=None, z_sets=None,
    device=None,
):
    """``(rows_fn, positions, site_meta)``: ``rows_fn(lab_chunk,
    cscal_chunk)`` maps a ``[C, G]`` global label block (on ``device``)
    plus its ``[C, n_sites, 4]`` collapse scalars (u, mflag, w0, w1 per
    site, order = ``site_meta``) to weight-folded rows over the DATA
    clbits ``positions``, ``[C, 2^len(positions)]`` (the JAX
    ``make_collapse_chunk_kernel`` row contract).  ``keep_clbits``: rows
    ``[C, 2^|kept|]`` from the in-kernel marginal, ``positions`` = the
    kept clbits.  ``z_sets``: rows ``[C, len(z_sets) + 1]``, column ``i``
    the signed contribution to z-set ``i``, the last the plain total;
    ``positions`` stays the full data-clbit list.  A launch takes any
    number of labels, so there is no chunk argument.  ``rows_fn.plan`` is the :class:`CollapseDevicePlan`,
    ``rows_fn.last_bits`` the picked bits of the last call.  Returns None
    where the kernel does not serve the request (see
    :func:`build_plan`)."""
    dev = resolve_device(device)
    plan = build_plan(virt, frag_name, keep_clbits=keep_clbits,
                      z_sets=z_sets)
    if plan is None:
        return None
    dp = CollapseDevicePlan(plan, dev)
    n = plan.n
    index = {q: i for i, q in enumerate(plan.active)}
    present = [q in index for q in plan.sources]
    act_axes = [index[q] for q in plan.sources if q in index]

    def rows_fn(lab_chunk, cscal_chunk):
        rows, bits = collapse_rows(dp, dp.gather_entries(lab_chunk),
                                   cscal_chunk)
        rows_fn.last_bits = bits
        if plan.mode != "rows":
            return rows
        # onto the data clbits; sources with no op read a deterministic 0
        return splice_zero_bits(marginalize_flat(rows, n, act_axes), present)

    rows_fn.plan = dp
    rows_fn.last_bits = None
    positions = list(plan.kept) if plan.mode == "marginal" \
        else list(plan.positions)
    return rows_fn, positions, list(plan.site_meta)


# ---------------------------------------------------------------------------
# Work counts for the roofline bound (bytes and f32 operations)
# ---------------------------------------------------------------------------

def work_counts(plan: CollapsePlan, entries, cscal) -> dict:
    """Work of one block (``entries [C, entry_stride]``, ``cscal [C,
    n_sites, 4]``, numpy or tensors), whatever implements the function.

    ``bytes``/``flops`` define the roofline bound: the bytes the function
    must move (each input read once, each output written once) and the
    f32 operations these labels need.  Each gate costs what its matrix
    needs (``variant_kernel.op_costs``: nothing for an identity or a
    permutation, one complex entry for a ``cp``; slot gates from each
    label's own entries).  Rows that differ only in ``u`` share every op
    before their first measuring site: a replica run (:func:`find_runs`,
    uncapped) counts those once, and the Born sums at that site (5 an
    amplitude) once; a run that measures nowhere counts everything, its
    epilogue included, once.  Per row: the ops after the run's first
    measuring site, 2 an amplitude for its rescale, 7 for each later
    measuring site, and the epilogue: ``|psi|^2`` 3 plus 1 for the
    weight or the marginal's sum, or 1 per z column (the total included).

    ``passes`` counts the passes over the state the redesigned kernel
    makes (rewritten rows per label or per run, one per epilogue column;
    a site it does not measure costs none, or one for its slot gates),
    ``passes_before`` those of a kernel that runs every label from the
    prefix (every original gate row, two per measuring site);
    ``pass_bytes`` = ``passes`` x a read and a write of the f32 state."""
    entries = np.asarray(entries.cpu() if torch.is_tensor(entries)
                         else entries, np.float32)
    cscal = np.asarray(cscal.cpu() if torch.is_tensor(cscal) else cscal,
                       np.float32)
    c = entries.shape[0]
    big = 1 << plan.n
    runs = find_runs(torch.as_tensor(entries), torch.as_tensor(cscal),
                     cap=c).numpy()
    cost = op_costs(plan.ops, plan.fixed, plan.n, entries)
    tail = np.cumsum(cost[:, ::-1], axis=1)[:, ::-1]       # from op i on
    tail = np.concatenate([tail, np.zeros((c, 1), np.int64)], axis=1)
    site_op = [i for i, r in enumerate(plan.ops.tolist()) if r[0] == 0]
    meas = cscal[:, :len(site_op), 1] > 0
    epi_cols = len(plan.z_masks) + 1 if plan.mode == "z" else 1
    epi = (3 + epi_cols) * big

    # the rewritten table's passes for each label: a row is a pass but a
    # site the label does not measure (none for OP_SITE_B, none for
    # OP_SITE_A without slot gates)
    rows = plan.table.rows
    k_pass = np.ones((c, len(rows)), np.int64)
    for i, (kind, _, s, pre, post, _) in enumerate(rows.tolist()):
        if kind == OP_SITE_B:
            k_pass[:, i] = meas[:, s]
        elif kind == OP_SITE_A and pre < 0 and post < 0:
            k_pass[:, i] = meas[:, s]
    k_tail = np.concatenate(
        [np.cumsum(k_pass[:, ::-1], axis=1)[:, ::-1],
         np.zeros((c, 1), np.int64)], axis=1)

    flops = passes = 0
    for start, length, first in runs.tolist():
        span = slice(start, start + length)
        if first >= len(site_op):          # measures nowhere: once
            flops += int(tail[start, 0]) + epi
            passes += int(k_tail[start, 0]) + epi_cols
            continue
        at = site_op[first]
        resume = plan.site_rows[first]
        flops += int(tail[start, 0] - tail[start, at]) + 5 * big
        flops += int((tail[span, at + 1]).sum()) + length * (2 * big + epi)
        flops += int(meas[span, first + 1:].sum()) * 7 * big
        passes += int(k_tail[start, 0] - k_tail[start, resume])
        passes += int(k_tail[span, resume].sum()) + length * epi_cols
    n_epi = {"rows": 0, "marginal": plan.n, "z": epi_cols - 1}[plan.mode]
    nbytes = 4 * (
        plan.prefix.size + plan.ops.size + plan.fixed.size + n_epi
        + c * (max(1, plan.entry_stride) + 5 * plan.n_sites
               + plan.out_width)
    )
    gates = int((plan.ops[:, 0] > 0).sum()) if len(plan.ops) else 0
    before = c * (gates + epi_cols) + 2 * int(meas.sum())
    return {"bytes": int(nbytes), "flops": int(flops),
            "pass_bytes": int(passes) * 16 * big, "passes": int(passes),
            "passes_before": int(before), "runs": len(runs)}
