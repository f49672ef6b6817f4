"""The torch port's variant kernel, plain version, against the JAX Pallas
kernel (ops/pallas_variant.py, interpret mode on the CPU).

On the CPU the port's wrapper runs its plain PyTorch version, which
replays every label in full; the CUDA kernel's staged schedule is held to
it on the card (test_torch_kernel_cuda.py).  Tolerance 2e-6, the JAX
kernel tests' own (f32, different summation order)."""
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.pallas_variant import (  # noqa: E501
    make_chunk_kernel as j_make_chunk_kernel,
    make_folded_chunk_kernel as j_make_folded_chunk_kernel,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    variant_kernel as vk,
)
from torch_port_common import chain_cut_pair, cut_pair, label_table, shuffled

ATOL = 2e-6


def _rows_both(jvirt, tvirt, name, chunk, rows_of, **kw):
    """Rows of every chunk of the global label table from the JAX kernel
    and the port, for ``rows_of(vidx) -> label order``."""
    import jax.numpy as jnp

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


def test_wrapper_counts_only_cuda_launches():
    """The CPU path runs the plain version and leaves the launch counter
    alone; a CUDA launch is the only place it moves."""
    _, tvirt = chain_cut_pair(8)
    fn, _ = vk.make_folded_chunk_kernel(tvirt, "frag0", 8, device="cpu")
    before = vk.variant_rows.launches
    vidx, _, _ = label_table(tvirt, 8)
    fn(torch.as_tensor(vidx[:8], dtype=torch.int64))
    assert vk.variant_rows.launches == before
