"""The torch port's variant kernel, plain version, against the JAX Pallas
kernel (ops/pallas_variant.py, interpret mode on the CPU).

On the CPU the port's wrapper runs its plain PyTorch version, which
replays every label in full; the CUDA kernel's staged schedule is held to
it on the card (test_torch_kernel_cuda.py).  Tolerance 2e-6, the JAX
kernel tests' own (f32, different summation order)."""
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
    Instruction as JInstruction,
    Register as JRegister,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.pallas_variant import (  # noqa: E501
    make_chunk_kernel as j_make_chunk_kernel,
    make_folded_chunk_kernel as j_make_folded_chunk_kernel,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_gates import (  # noqa: E501
    VirtualGateOp as JVirtualGateOp,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    op_rewrite,
    variant_kernel as vk,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    apply_matrix_host,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from torch_port_common import (
    chain_cut_pair,
    cut_pair,
    label_table,
    shuffled,
    to_port,
)

ATOL = 2e-6


def _rows_both(jvirt, tvirt, name, chunk, rows_of, full=False, **kw):
    """Rows of every chunk of the global label table from the JAX kernel
    and the port, for ``rows_of(vidx) -> label order``: folded rows, or
    with ``full`` the full rows of ``make_chunk_kernel``."""
    import jax.numpy as jnp

    if full:
        j_fn, j_pos = j_make_chunk_kernel(jvirt, name, chunk, interpret=True,
                                          staged=False)
        t_fn, t_pos = vk.make_chunk_kernel(tvirt, name, chunk, device="cpu")
    else:
        j_fn, j_pos = j_make_folded_chunk_kernel(
            jvirt, name, chunk, interpret=True, staged=False, **kw
        )
        t_fn, t_pos = vk.make_folded_chunk_kernel(
            tvirt, name, chunk, device="cpu", **kw
        )
    assert t_pos == j_pos
    vidx, total, padded = label_table(tvirt, chunk)
    arr = rows_of(vidx, total)
    for c0 in range(0, padded, chunk):
        blk = arr[c0:c0 + chunk]
        want = np.asarray(j_fn(jnp.asarray(blk)))
        got = t_fn(torch.as_tensor(blk, dtype=torch.int64)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("mode", ["dense", "keep", "z"])
def test_folded_kernel_rows_match_jax_fold(mode):
    """The in-kernel fold (vgate weights, dropped bits, z signs) equals
    the JAX fold-fused kernel row for row: dense, marginal and z modes
    (mirrors test_folded_kernel_rows_match_xla_fold)."""
    jvirt, tvirt = chain_cut_pair(8)
    kw = {"dense": {}, "keep": {"keep_clbits": [0, 1, 2, 5]},
          "z": {"z_clbits": [0, 3, 7]}}[mode]
    _rows_both(jvirt, tvirt, "frag0", 8, lambda v, t: v, **kw)


def test_folded_kernel_small_keep_rows():
    """d <= 1 kept bits (the JAX kernel's masked-lane epilogue; the port
    has one generic epilogue) matches exactly (mirrors
    test_folded_kernel_small_keep_masked_lane_path)."""
    jvirt, tvirt = chain_cut_pair(8)
    _rows_both(jvirt, tvirt, "frag0", 16, lambda v, t: v, keep_clbits=[0])


def test_folded_kernel_sup_fragment_rows():
    """A real optimal-cut supremacy fragment (sup-12, seed 5, dense 2q
    structure, cz cuts on interior qubits)."""
    _, _, jvirt, tvirt = cut_pair("sup", 12, 1, 10, seed=5)
    names = [r.name for r in tvirt.fragments
             if tvirt.programs[r.name].num_sim_qubits >= 8]
    assert names
    _rows_both(jvirt, tvirt, names[0], 64, lambda v, t: v)


@pytest.mark.parametrize("order", ["natural", "shuffled"])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_folded_kernel_staged_matches_unstaged_any_order(order, chunk):
    """The port's staged and unstaged plans give the JAX staged kernel's
    rows for any label order and any chunk split: chunks of 1 and 3 start
    where the stage array would otherwise say "resume", and the JAX kernel
    forces a full replay there (mirrors test_folded_kernel_staged_matches_
    unstaged_any_order).  The CUDA kernel's own block runs are held to the
    plain version in test_torch_kernel_cuda.py."""
    import jax.numpy as jnp

    jvirt, tvirt = chain_cut_pair(8)
    j_fn, _ = j_make_folded_chunk_kernel(jvirt, "frag0", chunk,
                                         interpret=True, staged=True)
    s_fn, _ = vk.make_folded_chunk_kernel(tvirt, "frag0", chunk,
                                          device="cpu")
    u_fn, _ = vk.make_folded_chunk_kernel(tvirt, "frag0", chunk,
                                          device="cpu", staged=False)
    assert s_fn.plan.plan.staged and len(s_fn.plan.plan.segments) == 2
    vidx, total, padded = label_table(tvirt, chunk)
    arr = vidx if order == "natural" else shuffled(vidx, total, 7)
    for c0 in range(0, padded, chunk):
        blk = torch.as_tensor(arr[c0:c0 + chunk], dtype=torch.int64)
        assert s_fn.plan.stages(blk)[0].item() == 0
        want = np.asarray(j_fn(jnp.asarray(arr[c0:c0 + chunk])))
        np.testing.assert_allclose(s_fn(blk).numpy(), want, atol=ATOL)
        np.testing.assert_allclose(u_fn(blk).numpy(), want, atol=ATOL)


def test_forced_full_replay_at_run_start_is_needed():
    """A CUDA run that starts mid-chunk has no checkpoints although the
    stage array may say "resume": effective_stages forces every run's
    first row to 0.  Runs now open at label groups (or every ``cap`` rows
    of a long group), so the forced replays cost the kernel no more than
    the first design's runs of ``cap`` rows (a full replay every ``cap``
    rows), and no less than the function's own stages."""
    _, tvirt = chain_cut_pair(8)
    fn, _ = vk.make_folded_chunk_kernel(tvirt, "frag0", 8, device="cpu")
    dp = fn.plan
    n_seg = len(dp.plan.row_segments)
    vidx, total, _ = label_table(tvirt, 8)
    for rows in (vidx[:12], shuffled(vidx, total, 5)[:12]):
        blk = torch.as_tensor(rows, dtype=torch.int64)
        blk = blk[dp.order(blk)]
        stage = dp.stages(blk).numpy()
        heads = vk.run_heads(torch.as_tensor(stage), n_seg, 3).numpy()
        eff = vk.effective_stages(stage, n_seg, 3)
        assert (eff[heads] == 0).all()
        assert (eff[~heads] == stage[~heads]).all()
        old = stage.copy()
        old[::3] = 0
        own = vk.work_counts(dp.plan, stage, 2)
        kern = vk.work_counts(dp.plan, eff, 2)
        before = vk.work_counts(dp.plan, old, 2)
        for key in ("flops", "passes", "pass_bytes"):
            assert own[key] <= kern[key] <= before[key]
        assert kern["bytes"] == own["bytes"]


def _plain_heads(stage, n_seg, cap):
    """The run heads by a plain walk over the rows: a run opens at row 0
    and at every stage 0, at a group's first row (stage below n_seg - 1)
    when its span of ``cap`` rows is not the previous group's, and every
    ``cap`` rows into a group."""
    heads, group_at = [], 0
    for i, s in enumerate(stage):
        group = i == 0 or s < max(n_seg - 1, 1)
        if i == 0 or s == 0:
            heads.append(True)
        elif group:
            heads.append(i // cap != group_at // cap)
        else:
            heads.append((i - group_at) % cap == 0)
        if group:
            group_at = i
    return np.asarray(heads)


def _schedules():
    """(stage, n_seg) pairs: the chain cut's chunk in natural and sorted
    shuffled order, random stage arrays of five segments, and of one."""
    _, tvirt = chain_cut_pair(8)
    fn, _ = vk.make_folded_chunk_kernel(tvirt, "frag0", 36, device="cpu")
    dp = fn.plan
    vidx, total, _ = label_table(tvirt, 36)
    out = []
    for rows in (vidx[:total], shuffled(vidx, total, 2)[:total]):
        blk = torch.as_tensor(rows, dtype=torch.int64)
        out.append((dp.stages(blk[dp.order(blk)]).numpy(),
                    len(dp.plan.row_segments)))
    rng = np.random.default_rng(9)
    for _ in range(2):
        st = rng.choice(6, 200, p=[0.01, 0.02, 0.05, 0.12, 0.6, 0.2])
        st[0] = 0
        out.append((st.astype(np.int32), 5))
    out.append((rng.choice(2, 50).astype(np.int32), 1))
    return out


@pytest.mark.parametrize("cap", [1, 3, 8, 64])
def test_run_table_matches_a_plain_walk(cap):
    """The run table built with torch ops (no host wait on the card)
    against a plain walk over the rows: the same heads, runs that open
    only at a label group or ``cap`` rows into one, shorter than 2 cap,
    and every label in exactly one run."""
    for stage, n_seg in _schedules():
        c = len(stage)
        want = _plain_heads(stage, n_seg, cap)
        heads = vk.run_heads(torch.as_tensor(stage), n_seg, cap).numpy()
        np.testing.assert_array_equal(heads, want)
        table, count = vk.run_table(torch.as_tensor(stage), n_seg, cap)
        runs = table[:int(count)].numpy()
        assert int(count) == want.sum() and (table[int(count):, 1] == 0).all()
        covered = np.concatenate([np.arange(a, a + n) for a, n in runs])
        np.testing.assert_array_equal(covered, np.arange(c))
        assert runs[:, 1].max() < 2 * cap
        group = np.asarray(stage) < max(n_seg - 1, 1)
        group[0] = True
        starts = runs[:, 0]
        at_group = group[starts]
        into = np.asarray([(a - np.flatnonzero(group[:a + 1])[-1]) % cap == 0
                           for a in starts])
        assert (at_group | into).all()


# clusters of g = 1..8 CTAs of the rows launch at 16-20 qubits (512
# threads, one CTA an SM) that an H100 80GB HBM3 runs at once, as
# cudaOccupancyMaxActiveClusters gives them: the SMs sit in GPCs, so
# large clusters leave some idle
H100_CLUSTERS = dict(zip(range(1, 9), [132, 66, 39, 30, 22, 17, 15, 15]))


@pytest.mark.parametrize("n,c,cap,want", [
    (20, 64, 6, 8),      # syc32-rcs: 11 runs, one CTA each kept 11 SMs busy
    (18, 256, 6, 8),     # sup25-full: 43 runs
    (17, 256, 6, 8),
    (20, 1, 6, 8),       # one label
    (18, 128, 6, 5),     # 22 runs: 5 CTAs each fill the card in one round
    (16, 1024, 6, 2),    # 171 runs: two rounds of one CTA, 3 of two
    (18, 792, 6, 1),     # 132 runs fill the card
    (18, 1584, 6, 1),
    (13, 64, 6, 1),      # shared memory: one CTA
    (15, 64, 6, 2),      # shared memory: the two-CTA cluster
])
def test_cluster_size_spreads_few_runs_over_the_card(n, c, cap, want):
    """The rows launch's cluster on the global-memory path: the size with
    the fewest rounds of the card per CTA for the chunk's runs; the
    shared-memory widths keep their geometry."""
    assert vk.cluster_size(n, c, cap, H100_CLUSTERS.get) == want


def test_cluster_size_skips_clusters_the_card_cannot_hold():
    """A size the card runs no cluster of is never chosen, and a card
    that runs none past one CTA keeps one."""
    caps = {**H100_CLUSTERS, 8: 0}
    assert vk.cluster_size(20, 64, 6, caps.get) == 7
    assert vk.cluster_size(20, 64, 6, lambda g: 132 if g == 1 else 0) == 1


CASES = {
    "fold": {}, "z": {"z_clbits": [0, 3, 7]}, "full": None,
}


@pytest.mark.parametrize("cap", [1, 3, 36])
@pytest.mark.parametrize("order", ["natural", "shuffled"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_schedule_replays_the_plain_rows(case, order, cap):
    """The kernel's own schedule, replayed on the CPU
    (replay_kernel_table: runs, checkpoints at segment starts, the
    rewritten table) on the sorted chunk equals the plain version on the
    chunk as given, once the rows are put back; staged and unstaged."""
    _, tvirt = chain_cut_pair(8)
    kw = CASES[case]
    vidx, total, _ = label_table(tvirt, 36)
    rows = vidx[:total] if order == "natural" else shuffled(vidx, total, 4)
    blk = torch.as_tensor(rows[:total], dtype=torch.int64)
    for staged in (True, False):
        if kw is None:
            fn, _ = vk.make_chunk_kernel(tvirt, "frag0", 36, staged=staged,
                                         device="cpu")
        else:
            fn, _ = vk.make_folded_chunk_kernel(tvirt, "frag0", 36,
                                                staged=staged, device="cpu",
                                                **kw)
        dp = fn.plan
        want = vk.plain_variant_rows(dp, dp.gather_entries(blk),
                                     fn.weigh(blk))
        o = dp.order(blk)
        sb = blk if o is None else blk[o]
        got = vk.replay_kernel_table(dp, dp.gather_entries(sb), fn.weigh(sb),
                                     dp.stages(sb), cap)
        back = got if o is None else torch.empty_like(got).index_copy_(
            0, o, got)
        np.testing.assert_allclose(back.numpy(), want.numpy(), atol=ATOL)
        np.testing.assert_allclose(
            vk.label_rows(dp, blk, fn.weigh).numpy(), want.numpy(),
            atol=ATOL)


def test_label_sort_orders_by_slot_digits_in_chain_order():
    """DevicePlan.order is a stable lexicographic sort of the slot digits
    in chain order (numpy's lexsort, by a mixed-radix key); sorted, a
    shuffled chunk resumes from later stages."""
    _, _, _, tvirt = cut_pair("sup", 12, 1, 10, seed=5)
    vidx, total, _ = label_table(tvirt, 64)
    rows = shuffled(vidx, total, 8)[:200]
    blk = torch.as_tensor(rows, dtype=torch.int64)
    for reg in tvirt.fragments:
        fn, _ = vk.make_folded_chunk_kernel(tvirt, reg.name, 200,
                                            device="cpu")
        dp = fn.plan
        gids = dp.plan.entry_gids
        if not gids:
            assert dp.order(blk) is None
            continue
        want = np.lexsort([rows[:, g] for g in reversed(gids)])
        got = dp.order(blk)
        np.testing.assert_array_equal(got.numpy(), want)
        assert dp.stages(blk[got]).sum() > dp.stages(blk).sum()


@pytest.mark.parametrize("staged", [True, False])
def test_chunk_kernel_rows_match_jax(staged):
    """Full-row epilogue + marginalisation onto the written clbits equals
    the JAX make_chunk_kernel on shuffled label order (mirrors
    test_chunk_kernel_staged_matches_unstaged)."""
    import jax.numpy as jnp

    jvirt, tvirt = chain_cut_pair(8)
    chunk = 8
    j_fn, j_pos = j_make_chunk_kernel(jvirt, "frag0", chunk, interpret=True,
                                      staged=False)
    t_fn, t_pos = vk.make_chunk_kernel(tvirt, "frag0", chunk, device="cpu",
                                       staged=staged)
    assert t_pos == j_pos
    vidx, total, padded = label_table(tvirt, chunk)
    arr = shuffled(vidx, total, 3)
    for c0 in range(0, padded, chunk):
        want = np.asarray(j_fn(jnp.asarray(arr[c0:c0 + chunk])))
        got = t_fn(torch.as_tensor(arr[c0:c0 + chunk],
                                   dtype=torch.int64)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_width_gate_raises_not_implemented():
    """Past the port's width gate the kernel names the blocked kernel's
    ROADMAP item instead of running."""
    _, tvirt = chain_cut_pair(8)
    old = vk.MAX_QUBITS
    vk.MAX_QUBITS = 4
    try:
        with pytest.raises(NotImplementedError, match="kernel 4"):
            vk.build_plan(tvirt, "frag0")
    finally:
        vk.MAX_QUBITS = old


def test_work_counts_follow_replayed_segments():
    """The roofline bound counts only the segments a chunk replays, and
    the passes only the rewritten rows of those segments."""
    _, tvirt = chain_cut_pair(8)
    plan = vk.build_plan(tvirt, "frag0", staged=True)
    full = vk.work_counts(plan, np.zeros(8, np.int64), 1)
    last = vk.work_counts(plan, np.array([0] + [1] * 7), 1)
    none = vk.work_counts(plan, np.array([0] + [2] * 7), 1)
    assert full["flops"] > last["flops"] > none["flops"] > 0
    assert full["passes"] > last["passes"] > none["passes"] > 0
    assert full["passes"] == 8 * len(plan.table.rows)
    assert full["passes_before"] == 8 * len(plan.ops)
    assert full["bytes"] == last["bytes"]


def _layered_chain(nbig: int = 6):
    """A port circuit whose frag0 (``nbig + 3`` simulated qubits) has
    three cuts with entangling layers between them, so a narrow tile
    window splits its segments into several passes."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
        Circuit,
        Instruction,
        Register,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_gates import (  # noqa: E501
        VirtualGateOp,
    )

    cut = Circuit([Register("frag0", nbig), Register("frag1", 2)], nbig + 2)
    for q in range(nbig):
        cut.h(q)
    for i in range(nbig - 1):
        cut.cx(i, i + 1)
    cut.append(Instruction("vgate", [nbig - 1, nbig],
                           op=VirtualGateOp("cz")))
    for i in range(nbig - 1):
        cut.ry(0.3 + 0.05 * i, i)
        cut.cx(i + 1, i)
    cut.append(Instruction("vgate", [0, nbig],
                           op=VirtualGateOp("cp", params=(0.7,))))
    for i in range(0, nbig - 2, 2):
        cut.cz(i, i + 2)
        cut.rx(0.2 + 0.1 * i, i + 1)
    cut.append(Instruction("vgate", [nbig // 2, nbig + 1],
                           op=VirtualGateOp("cz")))
    cut.cx(0, nbig - 1)
    cut.cx(nbig, nbig + 1)
    for q in range(nbig + 2):
        cut.measure(q, q)
    return TVirtualCircuit(cut)


def _layout_of(mask: int, n: int) -> np.ndarray:
    """``[2^n]``: the flat index of each layout index of a pass whose
    window is ``mask`` (window bits, ascending, below the others)."""
    win = [j for j in range(n) if (mask >> j) & 1]
    order = win + [j for j in range(n) if not (mask >> j) & 1]
    idx = np.arange(1 << n)
    return sum(((idx >> p) & 1) << j for p, j in enumerate(order))


@pytest.mark.parametrize("window", [4, 5, 7])
def test_tile_passes_hold_each_segments_rows(window):
    """The global-memory path's tile planner on a 9-qubit plan at forced
    windows: each segment's rows stay in order, cut into passes only
    where the next row's bits would overflow the window (with bits 0 and
    1, which every window holds); every row's bits lie inside its pass's
    window; and the rows at their layout bits, applied to the state in
    each pass's layout order, give the plain replay of the table."""
    virt = _layered_chain(6)
    plan = vk.build_plan(virt, "frag0")
    n, table, segs = plan.n, plan.table, plan.row_segments
    assert plan.tiles is None and n == 9 and len(segs) == 3
    tiles = vk.plan_tiles(table, segs, n, window=window)
    assert tiles.window == window
    passes, seg_pass = tiles.passes.tolist(), tiles.seg_pass.tolist()
    assert len(seg_pass) == len(segs) + 1 and seg_pass[-1] == len(passes)
    pinned = set(range(vk.TILE_PINNED))
    for i, (a, b) in enumerate(segs):
        mine = passes[seg_pass[i]:seg_pass[i + 1]]
        assert mine and mine[0][0] == a and mine[-1][1] == b
        for (lo, hi, mask), nxt in zip(mine, mine[1:] + [None]):
            win = {j for j in range(n) if (mask >> j) & 1}
            assert len(win) == window and pinned <= win
            bits = set(pinned)
            for o in range(lo, hi):
                assert set(vk.row_bits(table.rows[o])) <= win
                bits |= set(vk.row_bits(table.rows[o]))
            if nxt is not None:   # split where the next row overflows
                assert nxt[0] == hi
                assert len(bits | set(vk.row_bits(table.rows[hi]))) > window
    if window < 7:
        assert max(tiles.segment_passes) > 1
    entries = torch.rand((3, max(1, plan.entry_stride)), dtype=torch.float32)
    st = torch.rand((3, 2, 1 << n), dtype=torch.float32)
    want = op_rewrite.replay(st, table, n, entries)
    got = st
    for lo, hi, mask in passes:
        at = torch.as_tensor(_layout_of(mask, n))
        lay = got[:, :, at]
        for row in tiles.rows[lo:hi]:
            lay = op_rewrite.apply_row(lay, row, n, tiles.pool, entries)
        got = torch.empty_like(lay).index_copy_(2, at, lay)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_work_counts_tile_bytes_by_hand():
    """``tile_passes`` and ``tile_bytes`` of a plan whose segments take
    several passes: each label replays the passes from its stage's
    segment, the last segment where its stage says nothing changed; each
    pass reads and writes the 2^n complex64 state, but the last, which
    reads it.  Without tiles (the shared-memory path) both are 0."""
    virt = _layered_chain(6)
    plan = vk.build_plan(virt, "frag0")
    assert vk.work_counts(plan, np.zeros(2, np.int64), 1)["tile_bytes"] == 0
    plan.tiles = vk.plan_tiles(plan.table, plan.row_segments, plan.n,
                               window=4)
    a, b, c = plan.tiles.segment_passes
    stage = np.array([0, 1, 2, 3, 3])
    got = vk.work_counts(plan, stage, 1)
    passes = (a + b + c) + (b + c) + c + c + c
    assert got["tile_passes"] == passes
    assert got["tile_bytes"] == passes * 2 * 8 * 512 - 5 * 8 * 512


def test_wrapper_counts_only_cuda_launches():
    """The CPU path runs the plain version and leaves the launch counter
    alone; a CUDA launch is the only place it moves."""
    _, tvirt = chain_cut_pair(8)
    fn, _ = vk.make_folded_chunk_kernel(tvirt, "frag0", 8, device="cpu")
    before = vk.variant_rows.launches
    vidx, _, _ = label_table(tvirt, 8)
    fn(torch.as_tensor(vidx[:8], dtype=torch.int64))
    assert vk.variant_rows.launches == before


def _edge_pair():
    """frag0 (8 qubits) opens with a cut, so its prefix is empty; frag1
    is one data qubit whose gates all come before the cut, so its prefix
    is a state narrower than any window of kernel 4's.  Returns
    (jax_virt, port_virt)."""
    cut = JCircuit([JRegister("frag0", 8), JRegister("frag1", 1)], 9)
    cut.h(8)
    cut.rx(0.3, 8)
    cut.append(JInstruction("vgate", [7, 8], op=JVirtualGateOp("cz")))
    cut.h(0)
    for i in range(7):
        cut.cx(i, i + 1)
        cut.ry(0.2 + 0.1 * i, i)
    cut.rz(0.4, 8)
    for q in range(9):
        cut.measure(q, q)
    return JVirtualCircuit(cut), TVirtualCircuit(to_port(cut))


_PAIRS = {
    "hwe16": lambda: cut_pair("hwe", 16, 3, 10)[2:],
    "sup12": lambda: cut_pair("sup", 12, 1, 10, seed=5)[2:],
    "syc16": lambda: cut_pair("syc", 16, 2, 10)[2:],
    "edge": _edge_pair,
}
_BUILT: dict = {}

# (circuit, fragment, epilogue): full rows, the fold keeping every data
# bit, some of them (their sources moved to the low flat bits), none (z)
PREFIX_CASES = {
    "hwe16-full": ("hwe16", "frag0", "full"),
    "hwe16-fold": ("hwe16", "frag1", "fold"),
    "sup12-keep": ("sup12", "frag0", "keep"),
    "sup12-full": ("sup12", "frag1", "full"),
    "syc16-z": ("syc16", "frag0", "z"),
    "syc16-keep": ("syc16", "frag1", "keep"),
    "empty-prefix": ("edge", "frag0", "keep"),
    "narrow": ("edge", "frag1", "full"),
}


@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_device_prefix_matches_the_host_loop(case):
    """DevicePlan.prefix, built on the plan's device by kernel 4's prefix
    routine (its plain version here, no launch), equals the host loop
    that built it before (``apply_matrix_host`` gate by gate, each qubit
    on the flat bit the plan gives it) within 1e-6: unfolded and folded
    plans, a fold whose kept clbits permute the flat bits, a fragment
    whose prefix is empty (``|0...0>``) and one of a single data qubit
    (run as the low amplitudes of a 3-qubit state); the rows of every
    label match the JAX kernel's (its host prefix on the same gates),
    but for the single qubit, a fragment the JAX kernel does not
    serve."""
    pair, name, epilogue = PREFIX_CASES[case]
    if pair not in _BUILT:
        _BUILT[pair] = _PAIRS[pair]()
    jvirt, tvirt = _BUILT[pair]
    prog = tvirt.programs[name]
    n = prog.num_sim_qubits
    data = [p for p in sorted(prog.clbit_sources) if p < tvirt.num_clbits]
    kw = {"full": None, "fold": {}, "keep": {"keep_clbits": data[::-2]},
          "z": {"z_clbits": data[:3]}}[epilogue]
    if kw is None:
        fn, _ = vk.make_chunk_kernel(tvirt, name, 8, device="cpu")
        flat = {q: n - 1 - q for q in range(n)}
    else:
        fn, kept = vk.make_folded_chunk_kernel(tvirt, name, 8, device="cpu",
                                               **kw)
        order = [prog.clbit_sources[c] for c in kept]
        order += [q for q in range(n) if q not in order]
        flat = {q: j for j, q in enumerate(order)}
    dp = fn.plan
    prefix_ops, _, _ = op_rewrite._plan_ops(tvirt, name)
    want = np.zeros((2, 1 << n), np.float32)
    want[0, 0] = 1.0
    for _, mat, axes in prefix_ops:
        want = apply_matrix_host(want, mat, tuple(n - 1 - flat[q]
                                                  for q in axes), n)
    assert dp.prefix.shape == (2, 1 << n) and dp.prefix.dtype == torch.float32
    np.testing.assert_allclose(dp.prefix.numpy(), want, atol=1e-6)
    assert dp.prefix_launches == 0
    assert len(dp.plan.prefix_ops) == len(prefix_ops)
    if epilogue == "keep":  # the kept sources left the canonical bits
        assert any(flat[q] != n - 1 - q for q in range(n))
    if pair == "edge":
        assert (n < 3) == (name == "frag1")
        assert (not prefix_ops) == (name == "frag0")
    if case != "narrow":
        _rows_both(jvirt, tvirt, name, 8, lambda v, t: v, full=kw is None,
                   **(kw or {}))
