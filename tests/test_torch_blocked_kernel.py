"""The torch port's segmented blocked kernel, plain version, against the
JAX Pallas blocked kernel (ops/pallas_blocked.py, interpret mode on the
CPU) and against the port's own variant kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel is held to it on the card (test_torch_kernel_cuda.py).  Fragments
are FORCED through the blocked path at small windows, as the JAX tests
do, so segmentation and the gathered tiles run exactly as at 21..24
qubits; one
case runs at a true width (21 qubits).  Tolerance 1e-6 on rows (f32,
sums in another order), 1e-5 at 21 qubits (2^21-term marginal sums)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.pallas_blocked import (  # noqa: E501
    make_blocked_chunk_kernel as j_make_blocked_chunk_kernel,
    plan_segments as j_plan_segments,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.pallas_variant import (  # noqa: E501
    _plan_ops as j_plan_ops,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
    Circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    blocked_kernel as bk,
    variant_kernel as vk,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    apply_matrix_host,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
    make_streamed_knit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    op_rewrite,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.op_rewrite import (  # noqa: E501
    classify,
    matvec_ops,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit,
)
from torch_port_common import chain_cut_pair, cut_pair

ATOL = 1e-6


def _hwe16():
    _, _, jv, tv = cut_pair("hwe", 16, 3, 10)
    return jv, tv, tv.fragments[0].name


def _sup12():
    _, _, jv, tv = cut_pair("sup", 12, 1, 10)
    name = max((r.name for r in tv.fragments),
               key=lambda nm: tv.programs[nm].num_sim_qubits)
    assert tv.programs[name].num_sim_qubits >= 9
    return jv, tv, name


def _rand_labels(virt, count, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(
        0, [vg.spec.num_instantiations for vg in virt.vgates],
        size=(count, len(virt.vgates)),
    ).astype(np.int32)


def _is_identity(op):
    return op[0] == "u" and classify(op[1]) == "identity"


def _op_key(op):
    """An op without its matrix: (kind, slot id or None, qubit axes)."""
    return (op[0], op[1] if op[0] == "slot" else None, tuple(op[2]))


@pytest.mark.parametrize("config,window", [("hwe16", 8), ("hwe16", 9),
                                           ("sup12", 8)])
def test_plan_segments_equals_jax(config, window):
    """Unpinned, the planner gives the JAX planner's perms and op ranges
    on the same fused suffix; the port's plan (pinned bits, identities
    left out) covers the suffix in order with every row below the
    window."""
    jv, tv, name = _hwe16() if config == "hwe16" else _sup12()
    _, j_suffix, j_prog = j_plan_ops(jv, name)
    _, t_suffix, t_prog = vk._plan_ops(tv, name)
    n = t_prog.num_sim_qubits
    assert n == j_prog.num_sim_qubits
    assert [_op_key(o) for o in t_suffix] == [_op_key(o) for o in j_suffix]
    want = j_plan_segments(j_suffix, n, window)
    got = bk.plan_segments(t_suffix, n, window)
    assert len(got) == len(want) >= 2
    for (gp, gops), (wp, wops) in zip(got, want):
        assert gp == wp
        assert [_op_key(o) for o in gops] == [_op_key(o) for o in wops]
        for a, b in zip(gops, wops):
            if a[0] == "u":
                np.testing.assert_allclose(a[1], b[1], atol=1e-12)
    # the port's own plan: identities left out, 3 pinned bits
    plan = bk.build_plan(tv, name, window)
    assert plan.w == window and plan.pinned == bk.DEFAULT_PINNED
    kept = [o for o in t_suffix if not _is_identity(o)]
    segs = bk.plan_segments(kept, n, window, plan.pinned)
    assert plan.perms == [p for p, _ in segs]
    # the segments cover the suffix in order
    assert [e - s for s, e in plan.segments] == [len(o) for _, o in segs]
    assert [_op_key(o) for _, ops in segs for o in ops] == \
        [_op_key(o) for o in kept]
    assert plan.segments[0][0] == 0
    assert plan.segments[-1][1] == len(kept) == len(plan.ops)
    for perm, ops in segs:
        # every window holds the pinned bits, as its lowest tile bits
        assert all(perm[n - 1 - b] == b for b in range(plan.pinned))
        assert all(perm[q] < window for op in ops for q in op[2])
    # every op row of a segment acts below the window
    for row in plan.ops:
        assert row[1] < window and row[2] < window


@pytest.mark.parametrize("window", [8, 9, 10])
def test_forced_blocked_rows_match_jax_and_variant_kernel(window):
    jv, tv, name = _hwe16()
    j_fn, j_pos = j_make_blocked_chunk_kernel(
        jv, name, 8, window=window, interpret=True, force=True
    )
    t_fn, t_pos = bk.make_blocked_chunk_kernel(
        tv, name, 8, window=window, force=True, device="cpu"
    )
    v_fn, v_pos = vk.make_chunk_kernel(tv, name, 8, device="cpu")
    assert t_pos == j_pos == v_pos
    lab = _rand_labels(tv, 8)
    blk = torch.as_tensor(lab, dtype=torch.int64)
    got = t_fn(blk).numpy()
    np.testing.assert_allclose(got, np.asarray(j_fn(jnp.asarray(lab))),
                               atol=ATOL)
    np.testing.assert_allclose(got, v_fn(blk).numpy(), atol=ATOL)


def test_forced_blocked_rows_match_jax_on_sup():
    """Supremacy-grid fragment (dense 2q structure stresses the lookahead
    segmentation; mirrors test_blocked_rows_match_on_sup)."""
    jv, tv, name = _sup12()
    j_fn, j_pos = j_make_blocked_chunk_kernel(
        jv, name, 4, window=8, interpret=True, force=True
    )
    t_fn, t_pos = bk.make_blocked_chunk_kernel(
        tv, name, 4, window=8, force=True, device="cpu"
    )
    assert t_pos == j_pos
    lab = _rand_labels(tv, 4, seed=11)
    np.testing.assert_allclose(
        t_fn(torch.as_tensor(lab, dtype=torch.int64)).numpy(),
        np.asarray(j_fn(jnp.asarray(lab))), atol=ATOL,
    )


def test_blocked_width_gate():
    """n = 11 is the variant kernel's: without force the blocked path
    declines (mirrors test_blocked_width_gate); and the variant kernel's
    factories decline past their own gate instead of raising."""
    _, tv, name = _hwe16()
    assert tv.programs[name].num_sim_qubits == 11
    assert bk.make_blocked_chunk_kernel(tv, name, 8, device="cpu") is None
    old = vk.MAX_QUBITS
    vk.MAX_QUBITS = 4
    try:
        assert vk.make_chunk_kernel(tv, name, 8, device="cpu") is None
        assert vk.make_folded_chunk_kernel(tv, name, 8, device="cpu") is None
    finally:
        vk.MAX_QUBITS = old


@pytest.mark.parametrize("window", [1, 0])
def test_blocked_window_gate(window):
    """A window below 2 bits cannot hold a 2q gate: declined."""
    _, tv, name = _hwe16()
    assert bk.make_blocked_chunk_kernel(tv, name, 8, window=window,
                                        force=True, device="cpu") is None


def test_window_is_capped_by_shared_memory_and_width():
    """A window past 14 bits is clamped to n - 1 when that fits a tile."""
    _, tv, name = _hwe16()
    fn, _ = bk.make_blocked_chunk_kernel(tv, name, 8, window=18, force=True,
                                         device="cpu")
    assert fn.plan.plan.w == 10 <= bk.MAX_WINDOW


def test_true_width_21_qubits_matches_jax():
    """The 21-qubit chain fragment through the unforced route of both
    packages, 2 labels, at the default window and at a split one."""
    jv, tv = chain_cut_pair(19)
    assert tv.programs["frag0"].num_sim_qubits == 21
    assert vk.make_chunk_kernel(tv, "frag0", 2, device="cpu") is None
    j_fn, j_pos = j_make_blocked_chunk_kernel(jv, "frag0", 2,
                                              interpret=True)
    t_fn, t_pos = bk.make_blocked_chunk_kernel(tv, "frag0", 2, device="cpu")
    assert t_pos == j_pos
    assert t_fn.plan.plan.w == bk.DEFAULT_WINDOW
    lab = _rand_labels(tv, 2, seed=5)
    blk = torch.as_tensor(lab, dtype=torch.int64)
    got = t_fn(blk).numpy()
    want = np.asarray(j_fn(jnp.asarray(lab)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the suffix is two slot ops: a 2-bit window splits it in segments
    s_fn, _ = bk.make_blocked_chunk_kernel(tv, "frag0", 2, window=2,
                                           device="cpu")
    assert len(s_fn.plan.plan.segments) >= 2
    np.testing.assert_allclose(s_fn(blk).numpy(), want, atol=1e-5)


def test_fragment_without_slots_has_no_segment():
    """An uncut circuit's single fragment has an empty suffix: no segment,
    every label's row is the prefix state's."""
    circ = Circuit(3, 3)
    circ.h(0)
    circ.cx(0, 1)
    circ.cx(1, 2)
    for q in range(3):
        circ.measure(q, q)
    virt = VirtualCircuit(circ)
    name = virt.fragments[0].name
    fn, pos = bk.make_blocked_chunk_kernel(virt, name, 2, window=2,
                                           force=True, device="cpu")
    assert fn.plan.plan.segments == [] and pos == [0, 1, 2]
    rows = fn(torch.zeros((2, 0), dtype=torch.int64)).numpy()
    want = np.zeros(8, np.float32)
    want[0] = want[7] = 0.5
    np.testing.assert_allclose(rows, np.stack([want, want]), atol=ATOL)


def test_apply_segment_on_cpu_is_plain_and_counts_no_launch():
    """The CPU path runs the plain version and leaves the launch counter
    alone; a CUDA launch is the only place it moves."""
    _, tv, name = _hwe16()
    fn, _ = bk.make_blocked_chunk_kernel(tv, name, 4, window=8, force=True,
                                         device="cpu")
    dp = fn.plan
    ent = dp.gather_entries(torch.as_tensor(_rand_labels(tv, 4),
                                            dtype=torch.int64))
    before = bk.blocked_rows.launches
    got = bk.apply_segment(dp, 0, dp.prefix, ent)
    want = bk.plain_segment(dp, 0, dp.prefix, ent)
    assert got.shape == (4, 2, 1 << dp.plan.n)
    assert torch.equal(got, want)
    assert torch.equal(bk.blocked_rows(dp, ent),
                       bk.plain_blocked_rows(dp, ent))
    assert bk.blocked_rows.launches == before


def test_work_counts_per_segment():
    """Bytes: the first segment reads the shared prefix once, later ones
    every label's state; operations scale with the segment's gates."""
    _, tv, name = _hwe16()
    plan = bk.build_plan(tv, name, 8)
    big = 1 << plan.n
    first = bk.work_counts(plan, 0, 4)
    later = bk.work_counts(plan, 1, 4)
    assert first["bytes"] >= 4 * (2 * big + 4 * 2 * big)
    assert later["bytes"] >= 4 * (2 * 4 * 2 * big)
    assert later["bytes"] - first["bytes"] > 4 * 2 * big * 2
    # each gate what its matrix needs, a slot gate as dense (no entries)
    rows = plan.ops[plan.segments[1][0]:plan.segments[1][1]]
    want = 0
    for nq, _, _, coef in rows.tolist():
        m = 1 << nq
        if coef < 0:
            want += (28 if nq == 1 else 120) * (big // m)
            continue
        mat = plan.fixed[coef:coef + 2 * m * m].reshape(2, m, m)
        want += int(matvec_ops(mat[0], mat[1])) * (big // m)
    assert later["flops"] == want * 4 > 0
    assert want < sum(14 if r[0] == 1 else 30 for r in rows) * big


@pytest.mark.parametrize("config,window,pinned", [
    ("hwe16", 8, 3), ("hwe16", 9, 5), ("sup12", 8, 3), ("sup12", 8, 5)])
def test_pinned_planner_brute_force(config, window, pinned):
    """Pinned segments against a check by brute force: the ops keep their
    order, each segment's qubits and the pinned ones fit the window (and
    the next op would not), the perm is a bijection with the window on
    layout bits below ``w`` in ascending storage order, the pinned
    storage bits first."""
    _, tv, name = _hwe16() if config == "hwe16" else _sup12()
    _, suffix, prog = vk._plan_ops(tv, name)
    n = prog.num_sim_qubits
    segs = bk.plan_segments(suffix, n, window, pinned)
    assert [o for _, ops in segs for o in ops] == list(suffix)
    pins = {n - 1 - b for b in range(pinned)}
    at = 0
    for perm, ops in segs:
        assert ops
        qubits = pins | {q for op in ops for q in op[2]}
        assert len(qubits) <= window
        at += len(ops)
        if at < len(suffix):
            assert len(qubits | set(suffix[at][2])) > window
        assert sorted(perm) == list(range(n))
        assert sorted(perm.values()) == list(range(n))
        win = sorted(n - 1 - q for q, j in perm.items() if j < window)
        assert len(win) == window and qubits <= {n - 1 - b for b in win}
        assert [perm[n - 1 - b] for b in win] == list(range(window))
        assert win[:pinned] == list(range(pinned))
    assert at == len(suffix)


@pytest.mark.parametrize("config,window", [("hwe16", 8), ("hwe16", 5),
                                           ("sup12", 8)])
def test_prefix_from_plain_segments_matches_host(config, window):
    """The prefix built by the plain prefix segments (gathered tiles,
    rewritten rows) equals the host's gate-by-gate prefix."""
    _, tv, name = _hwe16() if config == "hwe16" else _sup12()
    prefix_ops, _, prog = vk._plan_ops(tv, name)
    n = prog.num_sim_qubits
    want = np.zeros((2, 1 << n), np.float32)
    want[0, 0] = 1.0
    for op in prefix_ops:
        want = apply_matrix_host(want, op[1], tuple(op[2]), n)
    dp = bk.BlockedDevicePlan(bk.build_plan(tv, name, window), "cpu")
    assert dp.plan.n_prefix >= 1
    got = dp.prefix.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(bk.plain_prefix_state(dp).numpy(), got,
                               atol=0)


@pytest.mark.parametrize("config,window", [("hwe16", 8), ("hwe16", 13),
                                           ("sup12", 5)])
def test_prefix_half_is_the_shared_routine(config, window):
    """The prefix segments of a fragment's plan are ``plan_prefix``'s on
    the same gates, row for row (rows, pool, copy tables, phases, folded
    moves), and ``build_prefix`` gives the device plan's prefix, with no
    launch on the CPU: kernel 1's prefix and kernel 4's are one path."""
    _, tv, name = _hwe16() if config == "hwe16" else _sup12()
    prefix_ops, _, prog = vk._plan_ops(tv, name)
    n = prog.num_sim_qubits
    plan = bk.build_plan(tv, name, window)
    pre = bk.plan_prefix(prefix_ops, n, window)
    g = pre.n_prefix
    assert g == plan.n_prefix >= 1 and not pre.segments
    assert pre.prefix_perms == plan.prefix_perms
    assert pre.row_segments == plan.row_segments[:g]
    assert pre.folded == plan.folded[:g]
    r1, p1 = plan.row_segments[g - 1][1::2]
    np.testing.assert_array_equal(pre.table.rows, plan.table.rows[:r1])
    np.testing.assert_array_equal(pre.table.pool, plan.table.pool[:p1])
    np.testing.assert_array_equal(pre.tables, plan.tables[:g])
    np.testing.assert_array_equal(pre.phases, plan.phases[:g])
    state, launches = bk.build_prefix(prefix_ops, n, "cpu", window)
    assert launches == 0
    assert torch.equal(state, bk.BlockedDevicePlan(plan, "cpu").prefix)


def test_device_plan_is_cached_on_the_circuit(monkeypatch):
    """A second scan build on the same circuit builds no plan and gives
    the same values; another window builds new entries."""
    _, tv, _ = _hwe16()
    built = []
    build = bk.build_plan
    monkeypatch.setattr(bk, "build_plan",
                        lambda *a, **k: built.append(a[1]) or build(*a, **k))
    step, xs, meta = make_streamed_knit(tv, 64, device="cpu",
                                        blocked_window=8,
                                        pallas_variant=True)
    assert sorted(built) == sorted(meta["fragment_plans"])
    first = step(xs)
    step2, xs2, meta2 = make_streamed_knit(tv, 64, device="cpu",
                                           blocked_window=8,
                                           pallas_variant=True)
    assert len(built) == len(meta["fragment_plans"])
    assert all(meta2["fragment_plans"][k] is dp
               for k, dp in meta["fragment_plans"].items())
    assert torch.equal(step2(xs2), first)
    _, _, meta3 = make_streamed_knit(tv, 64, device="cpu", blocked_window=9,
                                  pallas_variant=True)
    assert len(built) == 2 * len(meta["fragment_plans"])
    assert all(dp.plan.w == 9 for dp in meta3["fragment_plans"].values())


def _signed_perm(rng, d):
    """A random signed permutation matrix of size ``d`` that moves some
    member (phases 1, i, -1, -i)."""
    perm = np.arange(d)
    while np.array_equal(perm, np.arange(d)):
        perm = rng.permutation(d)
    mat = np.zeros((d, d), complex)
    mat[np.arange(d), perm] = 1j ** rng.integers(0, 4, d)
    return mat


@pytest.mark.parametrize("whole_vectors", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_folded_moves_equal_their_rows(whole_vectors, seed):
    """Signed permutations before and after a dense gate, folded into the
    gather and the scatter (with their phases), give the rows' own
    result; with 4-float copies the folds keep every group of 4 whole,
    and the copies the kernel makes (4 floats from the group's first
    index on, into its own order) give the same result."""
    w = 6
    rng = np.random.default_rng(seed)
    ops = []
    for k in range(9):
        if k == 4:
            u = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
            ops.append(("u", u, list(rng.choice(w, 2, replace=False))))
            continue
        q = rng.choice(w, 2 if k % 2 else 1, replace=False)
        ops.append(("u", _signed_perm(rng, 1 << len(q)), list(q)))
    table = op_rewrite.rewrite(ops)
    assert sum(r[0] in (op_rewrite.OP_PERM1, op_rewrite.OP_PERM2)
               for r in table.rows) == 8
    st = torch.as_tensor(rng.normal(size=(1, 2, 1 << w)), dtype=torch.float32)
    want = op_rewrite.replay(st, table, w)
    first, last, (gi, gp), (si, sp) = bk.fold_moves(table.rows, w,
                                                   whole_vectors)
    assert first + len(table.rows) - last > 0
    x = np.arange(1 << w)
    if whole_vectors:
        # the gather loads an aligned group in order, the scatter stores
        # float k of a group at the group's first index ^ k
        assert np.array_equal(gi, (gi[x & ~3] & ~3) | (x & 3))
        assert np.array_equal(si ^ si[x & ~3], x & 3)
        gi, si = gi[x & ~3] + (x & 3), si[x & ~3] ^ (x & 3)
    got = bk._rotate(st[:, :, torch.as_tensor(gi)], torch.as_tensor(gp))
    for row in table.rows[first:last]:
        got = op_rewrite.apply_row(got, row, w, table.pool)
    got = bk._rotate(got, torch.as_tensor(sp))
    out = torch.empty_like(got)
    out[:, :, torch.as_tensor(si)] = got
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)


def _low_bit_ladder(n: int = 16):
    """An uncut circuit whose moves (cx) are controlled by the qubits on
    storage bits 0 and 1 and target the qubits above: segments start with
    such a move, between dense rotation layers."""
    circ = Circuit(n, n)
    for q in range(n):
        circ.ry(0.3 + 0.1 * q, q)
    for _ in range(2):
        for t in range(n - 2):
            circ.cx(n - 1 - t % 2, t)
    for q in range(n):
        circ.rx(0.5 + 0.1 * q, q)
    for q in range(n):
        circ.measure(q, q)
    return circ


@pytest.mark.parametrize("config,window", [("ladder16", 8), ("ladder16", 13),
                                           ("hwe16", 8), ("sup12", 8)])
def test_four_float_copies_read_the_exact_tiles(config, window):
    """With pinned bits the kernel copies 4 floats at a time: the gather
    reads the 4 from its group's first offset on (which must be aligned),
    the scatter writes float k at that offset ^ k.  On every segment of
    the plan those copies address exactly the tiles' amplitudes (which
    the plain version gathers one by one), moves on storage bits 0 and 1
    at a segment's start included."""
    if config == "ladder16":
        virt = VirtualCircuit(_low_bit_ladder())
        name = virt.fragments[0].name
    else:
        _, virt, name = _hwe16() if config == "hwe16" else _sup12()
    plan = bk.build_plan(virt, name, window)
    assert plan.pinned >= 2
    x = torch.arange(1 << plan.w)
    for g in range(len(plan.row_segments)):
        for side in (0, 1):
            exact = bk.tile_index(plan.tables[g, side], plan.free_masks[g],
                                  plan.n, plan.w)
            first = exact[:, x & ~3]
            if side == 0:
                assert torch.equal(first & 3, torch.zeros_like(first))
                assert torch.equal(first + (x & 3), exact)
            else:
                assert torch.equal(first ^ (x & 3), exact)
    if config == "ladder16":
        # some segment starts with a cx on tile bit 0 or 1 and one above
        starts = [plan.table.rows[r0] for r0, r1, _, _ in plan.row_segments
                  if r1 > r0]
        assert any(r[0] == op_rewrite.OP_PERM2 and min(r[1], r[2]) < 2
                   and max(r[1], r[2]) >= 2 for r in starts)


def test_bit_reversal_index_is_kept_in_the_callers_memo():
    """The gather fallback of the bit reorder (a full reversal has more
    runs than a transpose takes) builds its index once into the memo its
    caller keeps, and reorders as the plain bit map does."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.bits import (  # noqa: E501
        permute_bits_flat,
    )

    m = 10
    src, dst = list(range(m)), list(reversed(range(m)))
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(3, 1 << m)),
                        dtype=torch.float32)
    memo: dict = {}
    got = permute_bits_flat(x, src, dst, memo)
    assert len(memo) == 1
    (index,) = memo.values()
    again = permute_bits_flat(x, src, dst, memo)
    assert len(memo) == 1 and next(iter(memo.values())) is index
    d = np.arange(1 << m)
    s = sum(((d >> j) & 1) << (m - 1 - j) for j in range(m))
    np.testing.assert_array_equal(got.numpy(), x.numpy()[:, s])
    assert torch.equal(again, got)
    assert torch.equal(permute_bits_flat(x, src, dst), got)
