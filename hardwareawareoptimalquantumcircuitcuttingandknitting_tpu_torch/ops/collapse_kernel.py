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
  one extra row kind for a collapse site) and the epilogue's bit maps;
* :func:`collapse_rows`, the wrapper: on CUDA tensors it launches the
  hand-written kernel in ``csrc/collapse_kernel.cu`` (built with ``nvcc``
  for ``sm_90a`` at first use into ``build/``, loaded with ``ctypes``) and
  counts the launch; on CPU tensors it runs :func:`plain_collapse_rows`;
* :func:`plain_collapse_rows`, the plain PyTorch version of the same
  function (the kernel's formula: ``p0 = tot - p1``), used on the CPU and
  as the kernel's reference on the card.

Not carried over from the TPU kernel, because they are artefacts of its
lanes: the ``n >= 8`` gate (128 lanes), the ``batch`` argument (labels
stacked on row bits) and the staged lane broadcasts.  One CUDA launch
covers every label of a block at any width from 1 to 20 qubits, so this
kernel serves every collapse-mode fragment.  Kept as the contract: the
in-kernel marginal and the Z columns exist up to 128 outcomes / columns;
past that the caller takes full rows and reduces them in torch.

What bounds the kernel on an H100 and what its design does about it is
written at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import resolve_device, to_device
from ..virt.virtual_circuit import VirtualCircuit
from .kernel_build import KernelLibrary, check_tensor
from .statevector import apply_matrix_host, marginalize_flat
from .variant_engine import collapse_stream
from .variant_kernel import OpTable, apply_op_plain, gather_slot_entries

MAX_QUBITS = 20      # per-block state in global scratch: 8 MB at n = 20
MAX_OUTCOMES = 128   # in-kernel marginal outcomes / z columns (the contract)
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
    mask of z-set ``i``; the last column is the plain total)."""

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

    st = np.zeros((2, 1 << n), np.float32)
    st[0, 0] = 1.0
    for _, mat, axes in prefix_ops:
        st = apply_matrix_host(st, mat, tuple(index[q] for q in axes), n)

    table = OpTable(prog, [vg.spec for vg in virt.vgates])
    for op in suffix:
        table.add(op, [n - 1 - index[q] for q in op[2]])
    site_meta = [(sid, prog.slots[sid].vgate_idx) for sid in table.sites]
    return CollapsePlan(
        n=n, prefix=st, ops=table.ops_array(), fixed=table.fixed_array(),
        entry_tables=table.entry_tables, entry_gids=table.entry_gids,
        entry_stride=table.entry_stride, site_meta=site_meta,
        active=list(active), positions=list(positions),
        sources=list(sources), mode=mode, kept=kept, marg_bits=marg_bits,
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
        self.entry_tables = to_device(plan.entry_tables, device)
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
        return gather_slot_entries(self.entry_tables, self.plan.entry_gids,
                                   lab_chunk)


def splice_zero_bits(rows: torch.Tensor, present) -> torch.Tensor:
    """Rows over the bits with ``present[j]`` true (little-endian, in
    order) widened to all ``len(present)`` bits: an absent bit is a
    deterministic 0, so its half of the row is zero (the JAX package's
    ``finish_row`` zero-bit rule)."""
    c = rows.shape[0]
    for j, ok in enumerate(present):
        if not ok:
            r = rows.reshape(c, -1, 1 << j)
            rows = torch.stack([r, torch.zeros_like(r)], dim=2).reshape(c, -1)
    return rows


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


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.collapse_rows_launch.argtypes = [p] * 9 + [i] * 11 + [p]
    lib.collapse_rows_launch.restype = i
    lib.collapse_kernel_max_smem_qubits.restype = i


# csrc/collapse_kernel.cu, built for sm_90a at first launch
LIBRARY = KernelLibrary("collapse_kernel", _bind,
                        "collapse_kernel_error_string")


def launch_geometry(n: int, c: int, device) -> tuple[int, int]:
    """``(threads, labels_per_cta)`` of a launch: a block of up to 1024
    threads (at least 32, one per amplitude pair), and as many blocks in
    flight as the SMs hold (one of 1024 threads, up to 16 small ones),
    each looping over a contiguous run of the block's labels."""
    threads = min(1024, max(32, (1 << n) // 2))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ctas = sms * max(1, min(16, 1024 // threads))
    return threads, max(1, math.ceil(c / ctas))


def _launch(dp: CollapseDevicePlan, entries, cscal):
    lib = LIBRARY.load()
    plan = dp.plan
    dev = entries.device
    c = entries.shape[0]
    check_tensor(entries, "entries", torch.float32,
                 (c, max(1, plan.entry_stride)), dev)
    check_tensor(cscal, "cscal", torch.float32, (c, plan.n_sites, 4), dev)
    for name in ("prefix", "ops", "fixed", "epi"):
        if getattr(dp, name).device != dev:
            raise ValueError(f"plan table {name} is not on {dev}")
    if c < 1:
        raise ValueError("an empty label block")
    threads, span = launch_geometry(plan.n, c, dev)
    grid = math.ceil(c / span)
    big = 1 << plan.n
    use_smem = plan.n <= lib.collapse_kernel_max_smem_qubits()
    scratch = torch.empty((1 if use_smem else grid * 2 * big,),
                          dtype=torch.float32, device=dev)
    out = torch.empty((c, _compact_width(plan)), dtype=torch.float32,
                      device=dev)
    bits = torch.full((c, plan.n_sites), -1, dtype=torch.int32, device=dev)
    if plan.mode == "marginal":
        n_epi = len(plan.real_bits)
    else:
        n_epi = len(plan.z_masks) if plan.mode == "z" else 0
    rc = lib.collapse_rows_launch(
        dp.prefix.data_ptr(), dp.ops.data_ptr(), dp.fixed.data_ptr(),
        entries.data_ptr(), cscal.data_ptr(), dp.epi.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), bits.data_ptr(), plan.n,
        len(plan.ops), c, span, plan.entry_stride, plan.n_sites,
        _MODES[plan.mode], n_epi, int(use_smem), grid, threads,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "collapse kernel launch failed: " + LIBRARY.error_text(rc)
        )
    collapse_rows.launches += 1
    return _finish(out, plan), bits


def collapse_rows(dp: CollapseDevicePlan, entries, cscal):
    """``(rows [C, out_width], bits [C, n_sites] int32)`` for a block of
    labels.  CUDA tensors launch the hand-written kernel (counted in
    ``collapse_rows.launches``); CPU tensors run
    :func:`plain_collapse_rows`.  ``entries [C, entry_stride]`` (from
    :meth:`CollapseDevicePlan.gather_entries`), ``cscal [C, n_sites, 4]``
    f32 (u, mflag, w0, w1 per site, in ``plan.site_meta`` order)."""
    if entries.is_cuda:
        return _launch(dp, entries, cscal)
    if entries.device.type != "cpu":
        raise ValueError(f"unsupported device {entries.device}")
    return plain_collapse_rows(dp, entries, cscal)


collapse_rows.launches = 0


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

def work_counts(plan: CollapsePlan, labels: int,
                measuring_sites: int | None = None) -> dict:
    """Work of one block of ``labels`` labels.  ``measuring_sites``: how
    many (label, site) pairs have ``mflag > 0`` in this block's scalars
    (data-dependent: only those sum, project and rescale; default every
    pair).

    ``bytes``/``flops`` define the roofline bound: the bytes the function
    must move (each input read once, each output written once) and the
    f32 operations it performs: a 1q gate 14 per amplitude, a 2q gate
    30, a measuring collapse site 7 (``|psi|^2`` 3, the two sums 2, the
    rescale 2), the epilogue ``|psi|^2`` 3 once plus 1 for the weight or
    the marginal's sum, or 1 per z column (the total included).  ``pass_bytes`` is the state
    traffic this design adds on top: the prefix copy, a read and a write
    of the ``[2, 2^n]`` f32 state per gate, a read and a read-write per
    measuring site, one read per epilogue pass."""
    big = 1 << plan.n
    kinds = plan.ops[:, 0] if len(plan.ops) else np.zeros(0, np.int32)
    n_1q, n_2q = int((kinds == 1).sum()), int((kinds == 2).sum())
    if measuring_sites is None:
        measuring_sites = labels * len(plan.site_meta)
    epi_passes = len(plan.z_masks) + 1 if plan.mode == "z" else 1
    epi = (3 + epi_passes) * big
    flops = (labels * ((14 * n_1q + 30 * n_2q) * big + epi)
             + measuring_sites * 7 * big)
    n_epi = {"rows": 0, "marginal": plan.n, "z": epi_passes - 1}[plan.mode]
    nbytes = 4 * (
        plan.prefix.size + plan.ops.size + plan.fixed.size + n_epi
        + labels * (max(1, plan.entry_stride) + 5 * plan.n_sites
                    + plan.out_width)
    )
    passes = (labels * (16 * (n_1q + n_2q) + 16 + 8 * epi_passes)
              + measuring_sites * 24) * big
    return {"bytes": int(nbytes), "flops": int(flops),
            "pass_bytes": int(passes)}
