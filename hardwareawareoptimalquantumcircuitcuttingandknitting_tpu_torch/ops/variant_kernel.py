"""Whole-variant statevector kernel for the ``engine="pallas"`` label scan.

Counterpart of the JAX package's ``ops/pallas_variant.py`` (the Pallas
kernel built by ``_build_call`` and entered through
``make_folded_chunk_kernel`` and ``make_chunk_kernel``).  Per QPD label of
a chunk: shared prefix state -> fused suffix (fixed 1q/2q gates, slot
gates with the label's own entries) -> epilogue, either the fold (vgate
weights, z signs and dropped bits contracted into a ``[2^d]`` knit row) or
full ``|psi|^2`` rows.

Three layers:

* the host build (:func:`build_plan`): the same fused op stream the JAX
  kernel runs, split at the first slot; the prefix runs once on the host;
  the suffix becomes an integer op table over flat bits plus a fixed-
  coefficient pool, grouped into one segment per slot (staged mode);
* :func:`variant_rows`, the wrapper: on CUDA tensors it launches the
  hand-written kernel in ``csrc/variant_kernel.cu`` (built with ``nvcc``
  for ``sm_90a`` at first use into ``build/``, loaded with ``ctypes``) and
  counts the launch; on CPU tensors it runs :func:`plain_variant_rows`;
* :func:`plain_variant_rows`, the plain PyTorch version of the same
  function (same op list and epilogue, every label replayed in full with
  no staging), used on the CPU and as the kernel's reference on the card.

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
from .statevector import apply_matrix_host, apply_slices, marginalize_flat
from .variant_engine import _slot_tables, _fuse_slot_ops

# Port's own width gate: state and checkpoints live in global memory, so
# the limit is device memory for [blocks, segments, 2, 2^n] f32 scratch,
# not on-chip memory.  Wider fragments need the segmented blocked kernel.
MAX_QUBITS = 20
_BLOCKED_ITEM = (
    "the segmented blocked kernel serves 21..24 qubits "
    "(ops/blocked_kernel.make_blocked_chunk_kernel; ROADMAP H100 port, "
    "queue B, kernel 4)"
)


def _to_complex(block: np.ndarray) -> np.ndarray:
    """Real (2, m, 2, m) block -> complex (m, m)."""
    return block[0, :, 0, :] + 1j * block[1, :, 0, :]


def _plan_ops(virt: VirtualCircuit, frag_name: str):
    """(prefix_ops, suffix_steps, prog) — the fused-slot op stream the JAX
    engines execute, split at the first slot.  Suffix steps:
    ("u", complex mat, axes) | ("slot", slot_id, axes)."""
    from .fusion import fused_stream

    prog = virt.programs[frag_name]
    skeleton, mats = fused_stream(_fuse_slot_ops(prog.ops), max_qubits=2)
    ops = []
    bi = 0
    for op in skeleton:
        if op[0] == "u":
            ops.append(("u", np.asarray(mats[bi], complex), op[1]))
            bi += 1
        else:  # ("slot", sid, axes)
            ops.append(op)
    first = next((i for i, op in enumerate(ops) if op[0] != "u"), len(ops))
    return ops[:first], ops[first:], prog


class OpTable:
    """Accumulates a kernel's op table: rows ``(nq, ja, jb, coef)`` over
    flat bits (``ja`` = the gate-index MSB), the fixed-coefficient pool
    and the per-slot entry tables.  ``coef >= 0`` is an offset into the
    pool (re ``[m*m]`` then im ``[m*m]``), ``coef < 0`` is ``-1 -
    offset`` into the label's entry row (the concatenated per-slot ``[2,
    m, m]`` entries).  A row with ``nq == 0`` is a collapse site on flat
    bit ``ja`` whose per-label scalars sit at site index ``jb`` (the
    collapse kernel alone reads such rows; ``sites`` lists their slot
    ids in row order).  One table format serves every circuit, so one
    build of a kernel does too."""

    def __init__(self, prog, specs):
        self._prog = prog
        self._specs = specs
        self._tabs: dict = {}          # fused? -> _slot_tables(...)
        self.sites: list = []          # slot id per collapse row
        self.ops: list = []
        self.fixed: list = []
        self.entry_tables: list = []   # per slot [nI, 2*m*m] float32
        self.entry_gids: list = []     # per slot: global vgate id
        self.entry_stride = 0          # floats per label entry row
        self.slot_rows: list = []      # op rows that are slots

    def _slot_table(self, sid: int, kind: str) -> np.ndarray:
        """``[nI, 2, m, 2, m]`` real blocks of one slot op: the composed
        block (``"slot"``) or the unfused pre / post endpoint gate."""
        fused = kind == "slot"
        if fused not in self._tabs:
            self._tabs[fused] = _slot_tables(self._prog, self._specs,
                                             fused=fused)
        return self._tabs[fused][sid][{"slot": 0, "slot_pre": 0,
                                       "slot_post": 2}[kind]]

    def add(self, op, js) -> None:
        """Append ``("u", complex mat, axes)``, ``("slot" | "slot_pre" |
        "slot_post", slot_id, axes)`` or ``("collapse", slot_id, axes)``
        acting on flat bits ``js``."""
        if op[0] == "collapse":
            self.ops.append((0, js[0], len(self.sites), 0))
            self.sites.append(op[1])
            return
        if len(js) not in (1, 2):
            raise NotImplementedError(
                f"{len(js)}-qubit op in the fused suffix: the kernels "
                "apply 1q and 2q gates only"
            )
        ja, jb = js[0], (js[1] if len(js) == 2 else 0)
        if op[0] == "u":
            mat = np.asarray(op[1], complex)
            coef = len(self.fixed)
            self.fixed.extend(mat.real.astype(np.float32).ravel())
            self.fixed.extend(mat.imag.astype(np.float32).ravel())
        else:
            self.slot_rows.append(len(self.ops))
            tab = self._slot_table(op[1], op[0])
            cx = np.stack([_to_complex(t) for t in tab])  # [nI, m, m]
            ent = np.stack([cx.real, cx.imag], axis=1).astype(np.float32)
            self.entry_tables.append(ent.reshape(ent.shape[0], -1))
            self.entry_gids.append(self._prog.slots[op[1]].vgate_idx)
            coef = -1 - self.entry_stride
            self.entry_stride += self.entry_tables[-1].shape[1]
        self.ops.append((len(js), ja, jb, coef))

    def ops_array(self) -> np.ndarray:
        return np.asarray(self.ops, np.int32).reshape(-1, 4)

    def fixed_array(self) -> np.ndarray:
        return np.asarray(self.fixed, np.float32)


def gather_slot_entries(entry_tables, entry_gids, vidx_chunk):
    """``[C, entry_stride]`` per-label slot entries for a ``[C,
    num_vgates]`` block of variant indices (global vgate columns), from
    per-slot device tables; ``[C, 1]`` zeros when there is no slot."""
    if not entry_tables:
        return torch.zeros((vidx_chunk.shape[0], 1), dtype=torch.float32,
                           device=vidx_chunk.device)
    return torch.cat([
        tab[vidx_chunk[:, gid]] for tab, gid in zip(entry_tables, entry_gids)
    ], dim=1).contiguous()


@dataclass
class VariantPlan:
    """Host build of one fragment's kernel (the JAX ``_build_call``).

    ``ops``, ``fixed`` and the entry tables are an :class:`OpTable`'s.
    ``segments`` are op ranges: one per slot when staged, else
    one covering the whole suffix (none when the fragment has no slot).
    ``fold`` is None (full rows) or ``(wbits, zmask, d)``."""

    n: int
    prefix: np.ndarray             # [2, 2^n] float32, shared by all labels
    ops: np.ndarray                # [n_ops, 4] int32
    fixed: np.ndarray              # float32 coefficient pool
    segments: list                 # [(start, end)] op ranges
    entry_tables: list             # per slot [nI, 2*m*m] float32
    entry_gids: list               # per slot: global vgate id
    entry_stride: int              # floats per label entry row
    fold: tuple | None             # (wbits list, zmask, d) or None
    staged: bool                   # one segment per slot

    @property
    def out_width(self) -> int:
        return 1 << (self.fold[2] if self.fold is not None else self.n)


def build_plan(virt: VirtualCircuit, frag_name: str, fold=None,
               staged: bool = True) -> VariantPlan:
    """Host build of the kernel for one fragment.  ``fold`` follows the
    JAX ``_build_call`` contract: ``{"w": [(clbit | None, ti)], "z":
    [clbits], "keep": [clbits ascending]}``.  Raises NotImplementedError
    past the port's width gate."""
    prefix_ops, suffix, prog = _plan_ops(virt, frag_name)
    specs = [vg.spec for vg in virt.vgates]
    n = prog.num_sim_qubits
    if n > MAX_QUBITS:
        raise NotImplementedError(
            f"fragment {frag_name!r} simulates {n} qubits, past the "
            f"variant kernel's {MAX_QUBITS}-qubit width gate: "
            f"{_BLOCKED_ITEM}"
        )

    # ---- flat-bit layout (permuted for the fold epilogue) -------------
    fold_desc = None
    if fold is None:
        flat_of_q = {q: n - 1 - q for q in range(n)}
    else:
        kept = list(fold["keep"])
        d_keep = len(kept)
        flat_of_q = {}
        for j, c in enumerate(kept):
            flat_of_q[prog.clbit_sources[c]] = j
        nxt = d_keep
        for q in range(n):
            if q not in flat_of_q:
                flat_of_q[q] = nxt
                nxt += 1
        assert nxt == n, (nxt, n)
        wbits = []
        for ti, (c, t) in enumerate(fold["w"]):
            assert t == ti, (t, ti)
            wbits.append(-1 if c is None else flat_of_q[prog.clbit_sources[c]])
        zmask = 0
        for c in fold.get("z", ()):
            zmask |= 1 << flat_of_q[prog.clbit_sources[c]]
        assert all(fb < 0 or fb >= d_keep for fb in wbits)
        assert zmask & ((1 << d_keep) - 1) == 0
        fold_desc = (wbits, zmask, d_keep)

    # host-shared prefix at full width (apply_matrix_host's qubit q' sits
    # on flat bit n-1-q')
    st = np.zeros((2, 1 << n), np.float32)
    st[0, 0] = 1.0
    for op in prefix_ops:
        st = apply_matrix_host(
            st, op[1], tuple(n - 1 - flat_of_q[q] for q in op[2]), n
        )

    table = OpTable(prog, specs)
    for op in suffix:
        table.add(op, [flat_of_q[q] for q in op[2]])
    ops, seg_starts = table.ops, table.slot_rows

    assert not seg_starts or seg_starts[0] == 0, "suffix must start at a slot"
    if not seg_starts:
        segments = []
    elif staged:
        segments = list(zip(seg_starts, seg_starts[1:] + [len(ops)]))
    else:
        segments = [(0, len(ops))]
    return VariantPlan(
        n=n, prefix=st,
        ops=table.ops_array(), fixed=table.fixed_array(),
        segments=segments, entry_tables=table.entry_tables,
        entry_gids=table.entry_gids, entry_stride=table.entry_stride,
        fold=fold_desc, staged=staged,
    )


class DevicePlan:
    """A :class:`VariantPlan` with its tables on one device."""

    def __init__(self, plan: VariantPlan, device):
        self.plan = plan
        self.device = torch.device(device)
        self.prefix = to_device(plan.prefix, device)
        self.ops = to_device(plan.ops, device)
        self.fixed = to_device(
            plan.fixed if plan.fixed.size else np.zeros(1, np.float32),
            device,
        )
        bounds = [s for s, _ in plan.segments] + (
            [plan.segments[-1][1]] if plan.segments else [0]
        )
        self.seg_start = to_device(np.asarray(bounds, np.int32), device)
        self.entry_tables = to_device(plan.entry_tables, device)
        wbits = plan.fold[0] if plan.fold is not None else []
        self.wbits = to_device(
            np.asarray(wbits or [0], np.int32), device
        )

    def gather_entries(self, vidx_chunk: torch.Tensor) -> torch.Tensor:
        """``[C, entry_stride]`` per-label slot entries for a ``[C,
        num_vgates]`` block of variant indices (global vgate columns)."""
        return gather_slot_entries(self.entry_tables, self.plan.entry_gids,
                                   vidx_chunk)

    def stages(self, vidx_chunk: torch.Tensor) -> torch.Tensor:
        """Per-label resume stage: the first chain-order slot whose variant
        differs from the PREVIOUS row (row 0: 0; all slots when nothing
        changed).  Unstaged plans replay everything (all zeros)."""
        c = vidx_chunk.shape[0]
        k = len(self.plan.entry_gids)
        if not self.plan.staged or k == 0:
            return torch.zeros(c, dtype=torch.int32, device=self.device)
        comp = vidx_chunk[:, self.plan.entry_gids]
        prev = torch.cat(
            [torch.full((1, k), -1, dtype=comp.dtype, device=comp.device),
             comp[:-1]], dim=0,
        )
        dif = comp != prev
        first = dif.to(torch.int8).argmax(dim=1)
        return torch.where(dif.any(dim=1), first,
                           torch.full_like(first, k)).to(torch.int32)


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def apply_op_plain(state, row, n: int, fixed: np.ndarray, entries):
    """One op-table row applied to ``state [B, 2, 2^n]`` with
    ``apply_slices`` (flat bit j is qubit n-1-j)."""
    nq, ja, jb, coef = (int(v) for v in row)
    m = 1 << nq
    js = (ja, jb)[:nq]
    axes = tuple(n - 1 - j for j in js)  # flat bit j <-> qubit n-1-j
    if coef >= 0:
        blk = fixed[coef:coef + 2 * m * m]
        ur = lambda r, c: float(blk[r * m + c])  # noqa: E731
        ui = lambda r, c: float(blk[m * m + r * m + c])  # noqa: E731
    else:
        off = -1 - coef
        ur = lambda r, c: entries[:, off + r * m + c]  # noqa: E731
        ui = lambda r, c: entries[:, off + m * m + r * m + c]  # noqa: E731
    return apply_slices(state, ur, ui, axes, n)


def _epilogue_plain(st, ws, dp: DevicePlan):
    sq = (st * st).sum(dim=1)  # [B, 2^n]
    plan = dp.plan
    if plan.fold is None:
        return sq
    wbits, zmask, d = plan.fold
    b = sq.shape[0]
    hdim = 1 << (plan.n - d)
    h = torch.arange(hdim, device=sq.device)
    fac = torch.ones((b, hdim), dtype=sq.dtype, device=sq.device)
    for t, fb in enumerate(wbits):
        w0, w1 = ws[:, t, 0:1], ws[:, t, 1:2]
        if fb < 0:
            fac = fac * w0
        else:
            bit = ((h >> (fb - d)) & 1).bool()
            fac = fac * torch.where(bit, w1, w0)
    zh = zmask >> d
    if zh:
        par = torch.zeros_like(h)
        for j in range(plan.n - d):
            if (zh >> j) & 1:
                par = par ^ ((h >> j) & 1)
        fac = fac * (1 - 2 * par).to(sq.dtype)
    return (sq.reshape(b, hdim, 1 << d) * fac[:, :, None]).sum(dim=1)


def plain_variant_rows(dp: DevicePlan, entries, wstack) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device: every label
    of the chunk replays the whole suffix from the shared prefix in one
    batch, then the epilogue.  No runs, no checkpoints and no stages — the
    staged schedule only skips work whose result it already holds, so the
    rows do not depend on it."""
    plan = dp.plan
    c = entries.shape[0]
    st = dp.prefix.to(entries.device).expand(c, 2, 1 << plan.n)
    for row in plan.ops:
        st = apply_op_plain(st, row, plan.n, plan.fixed, entries)
    return _epilogue_plain(st, wstack, dp)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.variant_rows_launch.argtypes = [p] * 10 + [i] * 11 + [p]
    lib.variant_rows_launch.restype = i
    lib.variant_kernel_max_weights.restype = i


# csrc/variant_kernel.cu, built for sm_90a at first launch
LIBRARY = KernelLibrary("variant_kernel", _bind,
                        "variant_kernel_error_string")


def default_labels_per_cta(c: int, device) -> int:
    """Labels per CUDA block: one block per SM, each looping over a
    contiguous run of the chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, math.ceil(c / sms))


def _launch(dp: DevicePlan, entries, wstack, stage, labels_per_cta):
    lib = LIBRARY.load()
    plan = dp.plan
    dev = entries.device
    c = entries.shape[0]
    n_w = wstack.shape[1]
    n_wbits = len(plan.fold[0]) if plan.fold is not None else 0
    check_tensor(entries, "entries", torch.float32,
                 (c, max(1, plan.entry_stride)), dev)
    check_tensor(wstack, "wstack", torch.float32, (c, n_w, 2), dev)
    check_tensor(stage, "stage", torch.int32, (c,), dev)
    for name in ("prefix", "ops", "fixed", "seg_start", "wbits"):
        if getattr(dp, name).device != dev:
            raise ValueError(f"plan table {name} is not on {dev}")
    if n_wbits > lib.variant_kernel_max_weights() or n_wbits > n_w:
        raise ValueError(f"{n_wbits} fold weights exceed the kernel's "
                         f"limit or the wstack's {n_w} columns")
    span = labels_per_cta or default_labels_per_cta(c, dev)
    grid = math.ceil(c / span)
    n_seg = len(plan.segments)
    big = 1 << plan.n
    scratch = torch.empty((max(1, grid * n_seg * 2 * big),),
                          dtype=torch.float32, device=dev)
    out = torch.empty((c, plan.out_width), dtype=torch.float32, device=dev)
    wbits, zmask, d = plan.fold if plan.fold is not None else ([], 0, 0)
    rc = lib.variant_rows_launch(
        dp.prefix.data_ptr(), dp.ops.data_ptr(), dp.fixed.data_ptr(),
        dp.seg_start.data_ptr(), entries.data_ptr(), stage.data_ptr(),
        wstack.data_ptr(), dp.wbits.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), plan.n, d, int(plan.fold is not None), c, span,
        n_seg, plan.entry_stride, n_w, n_wbits, zmask, grid,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "variant kernel launch failed: " + LIBRARY.error_text(rc)
        )
    variant_rows.launches += 1
    return out


def variant_rows(dp: DevicePlan, entries, wstack, stage,
                 labels_per_cta: int | None = None) -> torch.Tensor:
    """Rows ``[C, out_width]`` for a chunk of labels.  CUDA tensors launch
    the hand-written kernel (counted in ``variant_rows.launches``); CPU
    tensors run :func:`plain_variant_rows`.  ``entries [C, entry_stride]``
    (from :meth:`DevicePlan.gather_entries`), ``wstack [C, n_w, 2]`` f32,
    ``stage [C]`` int32 (the kernel's resume schedule).  ``labels_per_cta``
    overrides the kernel's run length (default: one run per SM)."""
    if entries.is_cuda:
        return _launch(dp, entries, wstack, stage, labels_per_cta)
    if entries.device.type != "cpu":
        raise ValueError(f"unsupported device {entries.device}")
    return plain_variant_rows(dp, entries, wstack)


variant_rows.launches = 0


# ---------------------------------------------------------------------------
# Streamed-engine integration points (the JAX make_*_chunk_kernel)
# ---------------------------------------------------------------------------

def make_folded_chunk_kernel(
    virt: VirtualCircuit, frag_name: str, chunk: int, keep_clbits=None,
    z_clbits=None, staged: bool = True, device=None,
):
    """``(rows_fn, kept_positions)``: ``rows_fn(vidx_chunk)`` maps a
    ``[chunk, num_vgates]`` block of per-label variant indices (global
    vgate columns, on ``device``) to FOLDED rows ``[chunk, 2^len(kept)]``:
    per touching vgate the measure clbit (num_clbits + g, when written
    here) folds with ``fold_weights[ti][v] = (w0, w1)``, non-measuring
    owners multiply by w0, ``keep_clbits`` drops data bits outside the
    set, ``z_clbits`` contracts every data bit ((+1, -1) on the support,
    summed elsewhere; kept is then []).  Output bit j carries
    ``kept_positions[j]`` (little-endian, ascending).  ``rows_fn.plan`` is
    the :class:`DevicePlan`.  Returns None past the kernel's width gate
    (``MAX_QUBITS``), where the blocked kernel takes over."""
    from .knit import fold_weights

    dev = resolve_device(device)
    prog = virt.programs[frag_name]
    if prog.num_sim_qubits > MAX_QUBITS:
        return None
    positions = sorted(prog.clbit_sources)
    frag_weights = fold_weights(virt, frag_name)
    w_entries = []
    w_tabs = []
    for ti, g in enumerate(prog.touching):
        cg = virt.num_clbits + g
        w_entries.append((cg if cg in positions else None, ti))
        w_tabs.append(np.asarray(frag_weights[ti], np.float32))
    data_pos = [p for p in positions if p < virt.num_clbits]
    z_list: list[int] = []
    if z_clbits is not None:
        z_list = [p for p in data_pos if p in set(z_clbits)]
        kept: list[int] = []
    elif keep_clbits is not None:
        kept = [p for p in data_pos if p in set(keep_clbits)]
    else:
        kept = list(data_pos)
    plan = build_plan(
        virt, frag_name,
        fold={"w": w_entries, "z": z_list, "keep": kept}, staged=staged,
    )
    dp = DevicePlan(plan, dev)
    w_dev = to_device(w_tabs, dev)
    w_gids = list(prog.touching)

    def rows_fn(vidx_chunk):
        if w_dev:
            wstack = torch.stack(
                [w[vidx_chunk[:, g]] for w, g in zip(w_dev, w_gids)], dim=1
            ).contiguous()
        else:
            wstack = torch.ones((vidx_chunk.shape[0], 1, 2),
                                dtype=torch.float32, device=dev)
        return variant_rows(dp, dp.gather_entries(vidx_chunk), wstack,
                            dp.stages(vidx_chunk))

    rows_fn.plan = dp
    return rows_fn, kept


def make_chunk_kernel(
    virt: VirtualCircuit, frag_name: str, chunk: int, staged: bool = True,
    device=None,
):
    """``(rows_fn, positions)``: ``rows_fn(vidx_chunk)`` maps a ``[chunk,
    num_vgates]`` label block to full-width kernel rows marginalised onto
    the written clbits, ``[chunk, 2^len(positions)]`` (the JAX
    ``make_chunk_kernel`` row contract).  ``rows_fn.plan`` is the
    :class:`DevicePlan`.  Returns None past the kernel's width gate."""
    dev = resolve_device(device)
    if virt.programs[frag_name].num_sim_qubits > MAX_QUBITS:
        return None
    plan = build_plan(virt, frag_name, staged=staged)
    dp = DevicePlan(plan, dev)
    prog = virt.programs[frag_name]
    positions = sorted(prog.clbit_sources)
    sources = [prog.clbit_sources[c] for c in positions]

    def rows_fn(vidx_chunk):
        c = vidx_chunk.shape[0]
        ones = torch.ones((c, 1, 2), dtype=torch.float32, device=dev)
        rows = variant_rows(dp, dp.gather_entries(vidx_chunk), ones,
                            dp.stages(vidx_chunk))
        return marginalize_flat(rows, plan.n, sources)

    rows_fn.plan = dp
    return rows_fn, positions


# ---------------------------------------------------------------------------
# Work counts for the roofline bound (bytes and f32 operations)
# ---------------------------------------------------------------------------

def effective_stages(stage: np.ndarray, labels_per_cta: int) -> np.ndarray:
    """The stages the CUDA kernel runs: the given ones, with the first
    label of every block's run forced to 0 (the function itself needs a
    full replay only at row 0, where the stage array already says 0)."""
    s = np.asarray(stage, np.int64).copy()
    s[::labels_per_cta] = 0
    return s


def work_counts(plan: VariantPlan, stage: np.ndarray, n_w: int) -> dict:
    """Work of one chunk replayed from these stages (data-dependent: only
    the replayed segments count).  The function's own stage array
    (:meth:`DevicePlan.stages`) gives the roofline work;
    :func:`effective_stages` gives what the CUDA kernel's per-block runs
    replay.

    ``bytes``/``flops`` define the roofline bound: the bytes the function
    must move (each input read once, each output written once) and the
    f32 operations it performs — a 1q gate costs 14 per amplitude (two
    complex MACs per output, 4 real outputs per pair), a 2q gate 30,
    ``|psi|^2`` 3 and the fold another ``n_wbits + 2``.  ``pass_bytes``
    is the state traffic this design adds on top: every replayed gate
    reads and writes the ``[2, 2^n]`` f32 state once, the epilogue reads
    it once."""
    c = len(stage)
    big = 1 << plan.n
    is_1q = plan.ops[:, 0] == 1 if len(plan.ops) else np.zeros(0, bool)
    per_op = np.where(is_1q, 14, 30) * big
    seg_cost = [int(per_op[a:b].sum()) for a, b in plan.segments]
    seg_ops = [b - a for a, b in plan.segments]

    def tail(xs):
        return np.cumsum(xs[::-1])[::-1].tolist() + [0]

    cost_tail, ops_tail = tail(seg_cost), tail(seg_ops)
    idx = [min(int(s), len(seg_cost)) for s in stage]
    gate_flops = sum(cost_tail[i] for i in idx)
    gate_passes = sum(ops_tail[i] for i in idx)
    epi = (3 + len(plan.fold[0]) + 2 if plan.fold is not None else 3) * big
    nbytes = 4 * (
        plan.prefix.size + plan.ops.size + plan.fixed.size
        + c * max(1, plan.entry_stride) + c + c * n_w * 2
        + c * plan.out_width
    )
    return {"bytes": int(nbytes), "flops": int(gate_flops + c * epi),
            "pass_bytes": int(gate_passes * big * 16 + c * big * 8)}
