"""Streaming cut-simulate-knit over the global QPD label space.

Port of the JAX package's ``ops/streamed.py``.  The global labels
(cartesian product over all vgates, last vgate fastest — reference
qvm/virtual_circuit.py:133-137) are processed in fixed-size chunks, and
per chunk

    carry[d1, ..., dF]  +=  sum_c  prod_f  E_f[c, d_f]

where each fragment's rows ``E_f`` are folded with the labels' knit
weights.  The chunk loop is a Python loop over device work; the carry
contraction is one plain ``torch.einsum`` in float32 (PyTorch's default
``allow_tf32=False`` keeps it full precision), whatever the states'
dtype.  Two routes make the rows:

* ``pallas_variant=False`` (the default, ``engine="streamed"``): the
  scan without a kernel.  Each fragment runs its lazy plan
  (ops/variant_engine.make_sim_fn, fused slots, 3- or 5-qubit fused
  blocks by the JAX byte model) in plain PyTorch on slot blocks gathered
  on the device by each label's variant index.  ``share_prefix`` runs
  each fragment's plan prefix once per ancestor (a combination of the
  shared vgates' variants) into a bank and the labels run only the
  suffix, staged in-chunk where the chunk is aligned
  (``meta["stage_align"]``); ``hoist_banks`` / ``meta["bank_fn"]`` build
  the banks once for many calls.  ``dtype=torch.bfloat16`` stores states
  and banks in bf16 (rows, folds, carry and knit stay float32).
  ``trunc_eps`` drops the labels of least certified weight.  ``noise``
  (a NoiseModel, or one per fragment) runs a fragment's unfused plan with
  ``trajectories`` balanced trajectories a label: the branch indices are
  drawn on the host with numpy (the JAX package's draws, from
  ``default_rng(seed)``) and streamed with the chunk, each row gathers
  its sites' Kraus blocks on the device, the rows are averaged over the
  trajectories and go through the per-bit readout channel before the
  fold.  Noisy fragments take no bank, and noise refuses bf16,
  ``trunc_eps`` and PEC models, as in the JAX package.
* ``pallas_variant=True`` (``engine="pallas"``): every fragment's rows
  from a hand-written kernel, routed by simulated width as in the JAX
  package: up to 20 qubits the fold-fused variant kernel
  (ops/variant_kernel.py, rows arrive folded), 21..24 qubits the
  segmented blocked kernel (ops/blocked_kernel.py, rows folded here in
  torch).  A fragment no kernel serves raises, and so do a bf16
  ``dtype`` and ``noise`` (the JAX package would quietly run the route
  without a kernel instead): the kernels are exact and noise-free.

:func:`run_virtual_circuit_streamed` adds carry checkpoints
(``checkpoint_dir``: the scan in segments, ``stream_carry.npz`` written
atomically after each) and ``shots`` (without a checkpoint: projection
and inverse-CDF draws on the device, only the indices fetched).

Refused here with NotImplementedError (ROADMAP H100 port, queue A):
fragments past 24 qubits on the kernel route (the sharded engine).
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
from .knit import (
    fold_weights,
    nearest_probability_distribution,
    smolin_project,
)
from .statevector import Distribution
from .variant_engine import (
    _slot_tables,
    _steps_hbm_bytes,
    exec_plan_steps,
    finish_row,
    ideal_stage_align,
    label_strides,
    make_sim_fn,
    make_prefix_fn,
    split_plan,
    suffix_stages,
    truncate_labels,
    variant_index_table,
)
from .variant_kernel import make_folded_chunk_kernel


def _resolve_noise(virt: VirtualCircuit, noise):
    """None | NoiseModel | list-per-fragment -> list per fragment."""
    if noise is None:
        return [None] * len(virt.fragments)
    if isinstance(noise, (list, tuple)):
        if len(noise) < len(virt.fragments):
            raise ValueError(f"{len(noise)} noise models for "
                             f"{len(virt.fragments)} fragments")
        return list(noise)
    return [noise] * len(virt.fragments)


def _sample_pauli_indices(rng, site_tabs, count: int, traj: int) -> np.ndarray:
    """[count, traj, n_sites] int32 branch indices into each site's own
    Kraus bank (depolarising sites: 0 = identity, 1..3 = Pauli;
    relaxation sites: 0 = no jump, 1 = decay, 2 = phase jump), the traj
    axis balanced per (label, site) (ops/noise._site_idx) — the JAX
    package's draws, site by site in the same order."""
    from .noise import _site_idx

    if not site_tabs:
        return np.zeros((count, traj, 0), np.int32)
    return np.stack([
        _site_idx(rng, pr, (count, traj), balance_axis=1)
        for pr, _ in site_tabs
    ], axis=2)


def _itemsize(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def default_bank_budget(dtype=None) -> int:
    """Per-fragment ancestor-bank budget: 512 MiB for f32 states, 1 GiB
    for bf16 (a bf16 bank holds twice the ancestors a byte) — the JAX
    package's budgets, so both packages choose the same splits."""
    if dtype is not None and _itemsize(dtype) == 2:
        return 1024 << 20
    return 512 << 20


def _pick_fuse_qubits(virt, name, dtype) -> int:
    """Fusion width for one fragment, the JAX package's byte model: build
    the plan at width 3 and 5 and keep 5 only where the counted
    per-variant bytes drop by at least 8%."""
    sizes = {}
    for fq in (3, 5):
        s, _, _, _ = make_sim_fn(
            virt, name, build_matrices=False, fused_slots=True,
            dtype=dtype, fuse_qubits=fq,
        )
        sizes[fq], _ = _steps_hbm_bytes(s.run_plan, s.prefix_width)
    return 5 if sizes[5] <= 0.92 * sizes[3] else 3


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


class _SimRows:
    """One fragment's rows without a kernel: the flat per-label plan, or
    an ancestor bank plus a staged suffix, or with noise the flat plan
    over every (label, trajectory) (the JAX package's
    ``_rows_for_fragment``, with the batched closures of
    :func:`~.variant_engine.make_sim_fn` in place of ``vmap``)."""

    def __init__(self, sim_fn, tables, gcols, split, chunk, specs, dev,
                 dtype, site_banks=None, readout=None):
        self.sim_fn = sim_fn
        self.tables = tables        # per slot: tuple of [nI, ...] blocks
        self.gcols = gcols          # per slot: its global vgate column
        self.split = split          # None | (SplitPlan, prefix_fn, stages,
                                    #         r_anc)
        self.chunk = chunk
        self.specs = specs
        self.dev = dev
        self.dtype = dtype
        self.site_banks = site_banks  # noise: site -> its plan's bank
        self.readout = readout        # noise: [k, 2, 2] per-bit channel

    def _mats(self, sids, reps):
        return {sid: tuple(t[reps[:, self.gcols[sid]]]
                           for t in self.tables[sid]) for sid in sids}

    def bank(self, chunk_bytes):
        """``[n_anc, 2, 2^m_split]`` ancestor states: one prefix run per
        combination of the shared vgates' variants, at most
        ``chunk_bytes`` of states at a time."""
        sp, prefix_fn, _, _ = self.split
        per_anc = (1 << (sp.m_split + 1)) * _itemsize(self.dtype)
        achunk = int(max(8, min(sp.n_anc, chunk_bytes // per_anc)))
        n_inst = {g: self.specs[g].num_instantiations for g in sp.shared}
        avidx = to_device(variant_index_table(
            sp.shared, sp.astrides, n_inst, sp.n_anc), self.dev,
            torch.int64)
        col = {g: j for j, g in enumerate(sp.shared)}
        sids = sorted({stp[1] for stp in sp.prefix_steps
                       if stp[0].startswith("slot")})
        parts = []
        for a0 in range(0, sp.n_anc, achunk):
            av = avidx[a0:a0 + achunk]
            mats = {sid: tuple(t[av[:, col[self.gcols[sid]]]]
                               for t in self.tables[sid]) for sid in sids}
            parts.append(prefix_fn(mats))
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def noisy_rows(self, vidx_chunk, pidx):
        """Rows ``[chunk, 2^k]`` of one chunk of labels under trajectory
        noise: ``pidx [chunk, T, S]`` branch indices; each (label,
        trajectory) row gathers its sites' blocks, the rows are averaged
        over T, then the readout channel."""
        from .noise import readout_rows

        c, t = pidx.shape[:2]
        mats = [tuple(tab[vidx_chunk[:, g]].repeat_interleave(t, dim=0)
                      for tab in tabs)
                for g, tabs in zip(self.gcols, self.tables)]
        flat = pidx.reshape(c * t, -1)
        pauli = {s: bank[flat[:, s]] for s, bank in self.site_banks.items()}
        if mats or pauli:
            rows = self.sim_fn(mats, self.dev, pauli)
            rows = rows.reshape(c, t, -1).mean(dim=1)
        else:
            rows = self.sim_fn([], self.dev).expand(c, -1)
        if self.readout is not None:
            rows = readout_rows(rows, self.readout)
        return rows

    def rows(self, vidx_chunk, bank=None, pidx=None):
        """Rows ``[chunk, 2^k]`` (float32) of one chunk of labels."""
        sim_fn = self.sim_fn
        if self.site_banks is not None:
            return self.noisy_rows(vidx_chunk, pidx)
        if self.split is None:
            if not self.tables:
                return sim_fn([], self.dev).expand(self.chunk, -1)
            return sim_fn([tuple(t[vidx_chunk[:, g]] for t in tabs)
                           for g, tabs in zip(self.gcols, self.tables)])
        # staged suffix: each stage runs once per group of r_out
        # consecutive labels, its states repeated to the next stage's
        # finer groups; every r_out == 1 is the per-label suffix
        sp, _, stages, r_anc = self.split
        reps0 = vidx_chunk[::r_anc]
        anc = torch.zeros(reps0.shape[0], dtype=torch.int64,
                          device=self.dev)
        for g in sp.shared:
            anc = anc + reps0[:, g] * sp.astrides[g]
        states = bank[anc]
        cur, m = r_anc, sp.m_split
        for st in stages:
            if st.r_out != cur:
                states = states.repeat_interleave(cur // st.r_out, dim=0)
                cur = st.r_out
            states, m = exec_plan_steps(
                states, st.m_in, st.steps,
                self._mats(st.sids, vidx_chunk[::cur]),
                slot_masks=sim_fn.slot_masks,
            )
        rows = finish_row(states, m, sim_fn.active_final, sim_fn.sources)
        # rows of a group are equal: repeat them, not the states
        return rows.repeat_interleave(cur, dim=0) if cur != 1 else rows


def make_streamed_knit(
    virt: VirtualCircuit, chunk: int = 512, keep_clbits=None,
    noise=None, trajectories: int | None = None, seed: int = 0,
    z_clbits=None, share_prefix: bool = False,
    bank_budget_bytes: int | None = None,
    hoist_banks: bool = False, dtype=None, trunc_eps: float = 0.0,
    pallas_variant: bool = False, device=None,
    blocked_window: int | None = None,
):
    """Build ``(step_fn, xs, meta)``: ``step_fn(xs)`` (or ``step_fn(xs,
    banks)``) runs every global label chunk and returns the flat knitted
    quasi-distribution values (a float32 tensor on ``device``, None =
    "cuda").

    ``xs`` = ``(vidx [n_chunks, chunk, num_vgates] int64, valid
    [n_chunks, chunk] float32, *pidx)``, on the device: per-label variant
    indices, a validity mask for the padded tail, then per fragment its
    noise branch indices ``[n_chunks, chunk, T, S]`` int64 (``[...,
    0, 0]`` for a noise-free fragment): every entry has the chunk axis
    first, so a slice of each is a segment.  ``keep_clbits``:
    marginal knit (the carry lives on the marginal); ``z_clbits``: every
    data bit contracted, signed on the support (a scalar carry).

    ``pallas_variant``: rows from the hand-written kernels (module
    docstring; ``share_prefix`` and ``hoist_banks`` then have no effect,
    as in the JAX package) or, False, from the plan in plain PyTorch,
    fused into 3- or 5-qubit blocks per fragment by the JAX byte model
    (:func:`_pick_fuse_qubits`).  ``share_prefix``: ancestor banks and staged suffixes
    (per fragment where the JAX byte model says a split wins and the bank
    fits ``bank_budget_bytes``, default :func:`default_bank_budget`);
    ``hoist_banks``: score splits for banks built once
    (``meta["bank_fn"]()``) and passed to every ``step_fn(xs, banks)``.
    ``dtype``: the states' storage dtype (``torch.bfloat16``: the serving
    mode, route without a kernel only).  ``trunc_eps``: drop the labels
    of least certified weight while their summed bound stays <=
    trunc_eps (``meta["kept_labels"]``, ``meta["dropped_mass"]``: the
    result moves at most that far in L1).  ``noise``: a NoiseModel or one
    per fragment (None: exact), ``trajectories`` a label (default the
    model's), branch indices drawn from ``default_rng(seed)`` fragment by
    fragment as in the JAX package (module docstring).

    ``meta`` carries ``carry_shape``, ``segment_fn`` and ``finish_fn``
    (``finish_fn(segment_fn(carry, xs_seg[, banks]))`` == ``step_fn(xs)``
    when the segments tile all chunks), ``bank_fn`` (None without a
    split), ``splits`` / ``stages`` per fragment, ``stage_align`` (the
    chunk multiple at which staging engages fully), ``fuse_qubits``,
    ``pallas_fragments`` (fragment -> kernel-backed), ``fragment_kernels``
    (fragment -> ``"variant"`` | ``"blocked"`` | None),
    ``fragment_plans`` (fragment -> the kernel's device plan, or None)
    and ``fragment_rows`` (per fragment the function the scan calls a
    chunk: ``fn(vidx_chunk, bank, pidx_chunk)`` -> folded rows).

    ``blocked_window``: test hook of the kernel route: send EVERY
    fragment through the blocked kernel at this window."""
    models = _resolve_noise(virt, noise)
    noisy = any(m is not None for m in models)
    dtype = torch.float32 if dtype is None else dtype
    if noisy and pallas_variant:
        raise ValueError(
            "noise runs on the route without a kernel (pallas_variant="
            "False, engine=\"streamed\"): the kernels are exact and "
            "noise-free (ROADMAP H100 port, section C, 'On purpose')")
    if noisy and dtype != torch.float32:
        raise ValueError("bf16 serving mode is exact-path only")
    if noisy and trunc_eps > 0.0:
        raise ValueError("truncation is exact-path only")
    if blocked_window is not None and not pallas_variant:
        raise ValueError("blocked_window is a hook of the kernel route "
                         "(pallas_variant=True)")
    if pallas_variant and dtype != torch.float32:
        raise ValueError(
            "the hand-written kernels are float32; dtype= (bf16 serving) "
            "runs on engine=\"streamed\" (pallas_variant=False)"
        )
    if bank_budget_bytes is None:
        bank_budget_bytes = default_bank_budget(dtype)
    dev = resolve_device(device)
    specs = [vg.spec for vg in virt.vgates]
    num_g = len(specs)
    gstride, n_inst, total = label_strides(specs, range(num_g))
    kept_labels, dropped_mass = None, 0.0
    if trunc_eps > 0.0:
        kept_labels, dropped_mass = truncate_labels(
            specs, gstride, n_inst, total, trunc_eps)
    n_labels = total if kept_labels is None else len(kept_labels)
    n_chunks = max(1, math.ceil(n_labels / chunk))
    padded = n_chunks * chunk
    valid = (np.arange(padded) < n_labels).astype(np.float32)
    vidx = variant_index_table(range(num_g), gstride, n_inst, padded,
                               labels=kept_labels)

    frag_names = [r.name for r in virt.fragments]
    rng = np.random.default_rng(seed)
    rows_fns, data_positions, pidx = [], [], []
    kernels, plans, splits, fqs = {}, {}, [], {}
    sims: list[_SimRows | None] = []
    for name, nm in zip(frag_names, models):
        if pallas_variant:
            kernels[name], rows_fn, kept, plans[name] = _fragment_rows(
                virt, name, chunk, keep_clbits, z_clbits, dev,
                blocked_window,
            )
            rows_fns.append(lambda vidx_chunk, bank, pidx_chunk, _fn=rows_fn:
                            _fn(vidx_chunk))
            data_positions.append(kept)
            splits.append(None)
            sims.append(None)
            pidx.append(np.zeros((padded, 0, 0), np.int32))
            continue
        prog = virt.programs[name]
        # the noise path keeps the unfused per-gate stream
        fq = fqs[name] = (3 if nm is not None
                          else _pick_fuse_qubits(virt, name, dtype))
        fused = nm is None
        sim_fn, _, positions, _ = make_sim_fn(
            virt, name, noise=nm, build_matrices=False, fused_slots=fused,
            dtype=dtype, fuse_qubits=fq,
        )
        tables = [to_device(list(t), dev, dtype)
                  for t in _slot_tables(prog, specs, fused=fused)]
        site_banks = readout = None
        if nm is None:
            pidx.append(np.zeros((padded, 0, 0), np.int32))
        else:
            if any(w is not None for (*_, w) in sim_fn.noise_sites):
                raise ValueError(
                    "PEC (signed quasi-sites) is batched-engine-only: "
                    "run_noisy_virtual_circuit(engine='auto')")
            site_tabs = [(pr, bank)
                         for (_, _, pr, bank, _) in sim_fn.noise_sites]
            pidx.append(_sample_pauli_indices(
                rng, site_tabs, padded, trajectories or nm.trajectories))
            site_banks = {s: to_device(sim_fn.site_banks[s], dev)
                          for s in sim_fn.active_sites}
            from .noise import _readout_mats, fragment_readout_qubits

            cq = fragment_readout_qubits(virt, name, sim_fn)
            if positions:
                readout = to_device(_readout_mats(
                    nm, [cq.get(c, j) for j, c in enumerate(positions)]),
                    dev)
        split = None
        if share_prefix and nm is None:
            # sized against the labels that actually run
            sp = split_plan(sim_fn, prog, specs, n_labels,
                            bank_budget_bytes, hoisted=hoist_banks,
                            state_bytes=_itemsize(dtype))
            if sp is not None:
                prefix_fn = make_prefix_fn(sim_fn, sp)
                # a truncated label set is no mixed-radix block sequence:
                # chunk=-1 fails every r > 1 and stages per label
                stages, r_anc = suffix_stages(
                    sp, prog, specs, gstride,
                    chunk if kept_labels is None else -1)
                split = (sp, prefix_fn, stages, r_anc)
        splits.append(split)
        sim = _SimRows(sim_fn, tables, [s.vgate_idx for s in prog.slots],
                       split, chunk, specs, dev, dtype, site_banks, readout)
        sims.append(sim)
        steps, w_tabs, kept = _fold_plan(virt, name, positions,
                                         keep_clbits, z_clbits)
        w_dev = [(g, to_device(t, dev)) for g, t in w_tabs]

        def sim_rows(vidx_chunk, bank=None, pidx_chunk=None, _sim=sim,
                     _steps=steps, _w=w_dev):
            return _apply_fold(_sim.rows(vidx_chunk, bank, pidx_chunk),
                               _steps, _w, vidx_chunk)

        rows_fns.append(sim_rows)
        data_positions.append(kept)
        kernels[name], plans[name] = None, None
    shape = tuple(1 << len(p) for p in data_positions)
    # 'z' is the chunk label — fragment labels must not collide with it
    letters = "abdefghijklm"
    assert len(frag_names) <= len(letters)
    expr = (
        ",".join(f"z{letters[i]}" for i in range(len(frag_names)))
        + "->" + letters[: len(frag_names)]
    )
    any_split = any(s is not None for s in splits)

    def bank_fn():
        """The ancestor banks, one per fragment (an empty tensor where a
        fragment has no split)."""
        return tuple(
            sims[fi].bank(_CHUNK_BYTES_BUDGET) if splits[fi] is not None
            else torch.zeros((0,), device=dev)
            for fi in range(len(frag_names))
        )

    def segment_fn(carry, xs_seg, banks=None):
        if banks is None and any_split:
            banks = bank_fn()
        vidx_seg, valid_seg, *pidx_seg = xs_seg
        for c in range(vidx_seg.shape[0]):
            es = [fn(vidx_seg[c], None if banks is None else banks[fi],
                     pidx_seg[fi][c])
                  for fi, fn in enumerate(rows_fns)]
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

    def step_fn(xs, banks=None):
        carry0 = torch.zeros(shape, dtype=torch.float32, device=dev)
        return finish_fn(segment_fn(carry0, xs, banks))

    xs = (
        to_device(vidx.reshape(n_chunks, chunk, -1), dev, torch.int64),
        to_device(valid.reshape(n_chunks, chunk), dev),
        *(to_device(a.reshape((n_chunks, chunk) + a.shape[1:]), dev,
                    torch.int64) for a in pidx),
    )
    # the chunk multiple at which staging engages fully (lcm over the
    # split fragments); a truncated label set never stages: 1
    align = 1
    if kept_labels is None:
        for fi, s in enumerate(splits):
            if s is not None:
                a = ideal_stage_align(
                    s[0], virt.programs[frag_names[fi]], specs, gstride)
                align = align * a // math.gcd(align, a)
    meta = {
        "positions": sorted(
            p for pos_list in data_positions for p in pos_list
        ),
        "global_labels": total,
        "kept_labels": n_labels,
        "dropped_mass": dropped_mass,
        "n_chunks": n_chunks,
        "chunk": chunk,
        "carry_shape": shape,
        "segment_fn": segment_fn,
        "finish_fn": finish_fn,
        "bank_fn": bank_fn if any_split else None,
        "splits": [s[0] if s is not None else None for s in splits],
        "stages": [s[2] if s is not None else None for s in splits],
        "stage_align": align,
        "fuse_qubits": fqs,
        "pallas_fragments": {name: pallas_variant for name in frag_names},
        "fragment_kernels": kernels,
        "fragment_plans": plans,
        "fragment_rows": rows_fns,
    }
    if pallas_variant:
        get_logger(__name__).info(
            "engine='pallas': " + "; ".join(
                f"{kind} kernel backs "
                f"{[n for n in frag_names if kernels[n] == kind]}"
                for kind in sorted(set(kernels.values()))
            )
        )
    return step_fn, xs, meta


# Per-buffer budget for one chunk's [chunk, 2, 2^n] states (the JAX
# package's bound, sized at f32 even for bf16 states, kept so both
# packages pick the same chunk); the ancestor banks are built in pieces
# of at most this many bytes.
_CHUNK_BYTES_BUDGET = 512 * 1024 * 1024


def auto_chunk(virt: VirtualCircuit, requested: int, trajectories: int = 1,
               noisy: bool = False) -> int:
    """Cap the requested chunk so one chunk's states (``trajectories`` a
    label) stay within the budget — an eighth of it when ``noisy`` (the
    JAX package's rule for its unfused trajectory body, kept so both
    packages pad the labels, and so draw the noise, alike) — and never
    pad a small fan-out up to a huge chunk."""
    max_n = max(
        (p.num_sim_qubits for p in virt.programs.values()), default=1
    )
    budget = _CHUNK_BYTES_BUDGET
    if noisy or trajectories > 1:
        budget //= 8
    cap = max(8, budget // (2 * (1 << max_n) * 4 * max(1, trajectories)))
    total = 1
    for vg in virt.vgates:
        total *= vg.spec.num_instantiations
    return int(max(1, min(requested, cap, total)))


# ---------------------------------------------------------------------------
# Segmented (checkpointable) execution
# ---------------------------------------------------------------------------

_STREAM_CKPT = "stream_carry.npz"


def _stream_fingerprint(virt, chunk, segment_chunks, seed, dtype=None,
                        trunc_eps: float = 0.0, keep_clbits=None,
                        models=None, trajectories=None) -> str:
    """Identity of a segmented scan's carry: the circuit's results
    fingerprint (utils/checkpoint), the chunking, the seed, truncation,
    the marginal and every fragment's noise model (``models``, None: all
    exact; rates, trajectories, coupling, relaxation and the per-qubit
    calibration vectors) — the JAX package's digest."""
    import hashlib

    from ..utils.checkpoint import checkpoint_fingerprint

    h = hashlib.sha256()
    h.update(checkpoint_fingerprint(virt, dtype=dtype).encode())
    h.update(f"|chunk={chunk}|seg={segment_chunks}|seed={seed}".encode())
    if trunc_eps:
        # a truncated run's carry covers another label subset
        h.update(f"|trunc_eps={trunc_eps!r}".encode())
    if keep_clbits is not None:
        # a marginal run's carry has the marginal's width and layout
        h.update(f"|keep={sorted(keep_clbits)}".encode())
    for nm in models or [None] * len(virt.fragments):
        if nm is None:
            h.update(b"none")
            continue
        h.update(
            f"{nm.name}|{nm.p1}|{nm.p2}|{nm.readout01}|{nm.readout10}|"
            f"{trajectories or nm.trajectories}|{nm.untranspiled}|"
            f"{sorted(map(tuple, nm.coupling)) if nm.coupling else None}"
            .encode()
        )
        # models differing only in T1/T2 must not share a checkpoint
        h.update(
            f"|t1={nm.t1}|t2={nm.t2}|g1={nm.gate_time_1q}"
            f"|g2={nm.gate_time_2q}".encode()
        )
        # nor models differing only in their per-qubit vectors
        for vec in (nm.p1_q, nm.p2_q, nm.ro01_q, nm.ro10_q, nm.t1_q,
                    nm.t2_q):
            if vec is None:
                h.update(b"|none")
            else:
                a = np.ascontiguousarray(np.asarray(vec, np.float64))
                h.update(b"|" + a.tobytes())
    return h.hexdigest()


def _load_stream_checkpoint(directory, fingerprint, carry_shape):
    import pathlib

    path = pathlib.Path(directory) / _STREAM_CKPT
    if not path.exists():
        return None, 0
    data = np.load(path, allow_pickle=False)
    if str(data["fingerprint"]) != fingerprint:
        return None, 0
    carry = data["carry"]
    if carry.shape != tuple(carry_shape):
        return None, 0
    return carry, int(data["next_segment"])


def _save_stream_checkpoint(directory, fingerprint, carry, next_segment):
    import os
    import pathlib

    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / (_STREAM_CKPT + ".tmp")
    np.savez(
        tmp, carry=carry, next_segment=next_segment, fingerprint=fingerprint
    )
    # np.savez appends .npz to a name without it; handle both layouts
    src = tmp if tmp.exists() else tmp.with_suffix(".tmp.npz")
    os.replace(src, directory / _STREAM_CKPT)


def _run_segments(virt, meta, xs, chunk, checkpoint_dir, segment_chunks,
                  models, trajectories, seed, dtype, trunc_eps,
                  keep_clbits):
    """The scan in segments of ``segment_chunks`` chunks, the carry saved
    after each; resumes at the first unfinished segment of a matching
    checkpoint.  The banks are built once, not once a segment.  Returns
    the finished values on the device."""
    n_chunks = meta["n_chunks"]
    seg = segment_chunks or max(1, min(n_chunks, 16))
    nseg = math.ceil(n_chunks / seg)
    pad = nseg * seg - n_chunks
    if pad:
        # padded chunks carry valid=0, so their contribution is masked
        xs = tuple(torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
                   for a in xs)
    fp = _stream_fingerprint(virt, chunk, seg, seed, dtype=dtype,
                             trunc_eps=trunc_eps, keep_clbits=keep_clbits,
                             models=models, trajectories=trajectories)
    carry, start = _load_stream_checkpoint(checkpoint_dir, fp,
                                           meta["carry_shape"])
    dev = xs[0].device
    if carry is None:
        carry, start = np.zeros(meta["carry_shape"], np.float32), 0
    carry = to_device(carry, dev)
    banks = meta["bank_fn"]() if meta["bank_fn"] is not None else None
    for si in range(start, nseg):
        xs_seg = tuple(a[si * seg:(si + 1) * seg] for a in xs)
        carry = meta["segment_fn"](carry, xs_seg, banks)
        _save_stream_checkpoint(checkpoint_dir, fp, carry.cpu().numpy(),
                                si + 1)
    return meta["finish_fn"](carry)


def _traj_eff(models, trajectories) -> int:
    """Trajectories a label of the widest noisy fragment (1 without
    noise): what :func:`auto_chunk` sizes the chunk by."""
    return max([trajectories or nm.trajectories
                for nm in models if nm is not None], default=1)


def run_virtual_circuit_streamed(
    virt: VirtualCircuit,
    chunk: int = 512,
    project: bool = False,
    noise=None,
    trajectories: int | None = None,
    shots: int | None = None,
    seed: int = 0,
    checkpoint_dir=None,
    segment_chunks: int | None = None,
    share_prefix: bool | None = None,
    dtype=None,
    trunc_eps: float = 0.0,
    keep_clbits=None,
    pallas_variant: bool = False,
    device=None,
) -> Distribution:
    """End-to-end streamed execution on ``device`` (None = "cuda").
    ``chunk`` is capped by :func:`auto_chunk` (never rounded to
    ``meta["stage_align"]``: staging engages where the caller's chunk is
    aligned; with noise the trajectories count against the budget, and
    the budget is an eighth).  ``share_prefix``: None = on.
    ``keep_clbits``: marginal knit.  ``project``: Smolin projection onto
    the simplex, on the device before the fetch.  ``noise``,
    ``trajectories``, ``seed``: trajectory noise
    (:func:`make_streamed_knit`); ``seed`` also seeds the shots.

    ``checkpoint_dir``: run the scan in segments of ``segment_chunks``
    chunks (default min(n_chunks, 16)), saving the carry after each; a
    rerun with the same arguments resumes at the first unfinished
    segment (a stale or mismatching checkpoint is ignored by its
    fingerprint).

    ``shots``: multinomial counts / shots of the projected knit.  Without
    ``checkpoint_dir`` the projection (``knit.smolin_project``) and an
    inverse-CDF draw from a ``torch.Generator`` seeded with ``seed`` run
    on the device, and only the ``[shots]`` outcome indices and the mass
    are fetched; with it, numpy's :func:`~.sampling.sample_distribution`
    on the fetched values.  A non-positive mass raises ValueError."""
    models = _resolve_noise(virt, noise)
    chunk = auto_chunk(virt, chunk, _traj_eff(models, trajectories),
                       noisy=any(m is not None for m in models))
    step_fn, xs, meta = make_streamed_knit(
        virt, chunk, keep_clbits=keep_clbits, noise=models,
        trajectories=trajectories, seed=seed,
        share_prefix=True if share_prefix is None else share_prefix,
        dtype=dtype, trunc_eps=trunc_eps, pallas_variant=pallas_variant,
        device=device,
    )
    positions = meta["positions"]
    if checkpoint_dir is None and shots is not None:
        from .sampling import sample_indices_device

        proj = smolin_project(step_fn(xs))
        gen = torch.Generator(device=proj.device).manual_seed(seed)
        idx = sample_indices_device(proj, shots, gen)
        if float(proj.sum()) <= 0.0:
            raise ValueError(
                "cannot sample from an all-nonpositive distribution"
            )
        counts = np.bincount(idx.cpu().numpy(),
                             minlength=1 << len(positions)) / float(shots)
        return Distribution(counts.astype(np.float32), positions,
                            virt.num_clbits)
    if checkpoint_dir is None:
        values = step_fn(xs)
    else:
        values = _run_segments(virt, meta, xs, chunk, checkpoint_dir,
                               segment_chunks, models, trajectories, seed,
                               dtype, trunc_eps, keep_clbits)
    if shots is not None:
        from .sampling import sample_distribution

        dist = nearest_probability_distribution(Distribution(
            values.cpu().numpy(), positions, virt.num_clbits))
        return sample_distribution(dist, shots, seed)
    if project:
        values = smolin_project(values).to(torch.float32)
    return Distribution(values.cpu().numpy(), positions, virt.num_clbits)


def streamed_expectation_z(
    virt: VirtualCircuit, z_clbits, chunk: int = 512, noise=None,
    trajectories: int | None = None, seed: int = 0,
    share_prefix: bool = True, dtype=None, pallas_variant: bool = False,
    device=None,
) -> float:
    """<prod_{c in z_clbits} Z_c> of the reconstructed distribution,
    computed with a SCALAR carry: every data bit is contracted per
    fragment and label (signed on the Z support), so no distribution of
    any size materialises for any circuit width; one scalar fetch.  On
    ``device`` (None = "cuda"); the rows come from the kernels with
    ``pallas_variant=True``.  ``noise`` (a NoiseModel or one per
    fragment), ``trajectories``, ``seed``: the observable of the
    trajectory-noise + readout-channel estimate (the scan's noise path,
    :func:`make_streamed_knit`)."""
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
    models = _resolve_noise(virt, noise)
    chunk = auto_chunk(virt, chunk, _traj_eff(models, trajectories),
                       noisy=any(m is not None for m in models))
    step_fn, xs, _ = make_streamed_knit(
        virt, chunk, z_clbits=frozenset(z_clbits),
        noise=models, trajectories=trajectories, seed=seed,
        share_prefix=share_prefix, dtype=dtype,
        pallas_variant=pallas_variant, device=device,
    )
    return float(step_fn(xs).reshape(()))
