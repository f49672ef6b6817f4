"""The torch port's segmented blocked kernel, plain version, against the
JAX Pallas blocked kernel (ops/pallas_blocked.py, interpret mode on the
CPU) and against the port's own variant kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel is held to it on the card (test_torch_kernel_cuda.py).  Fragments
are FORCED through the blocked path at small windows, as the JAX tests
do, so segmentation and re-tiling run exactly as at 21..24 qubits; one
case runs at a true width (21 qubits).  Tolerance 1e-6 on rows (f32,
sums in another order), 1e-5 at 21 qubits (2^21-term marginal sums)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.pallas_blocked import (  # noqa: E501
    _perm_dst_bits as j_perm_dst_bits,
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
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.op_rewrite import (  # noqa: E501
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


def _op_key(op):
    """An op without its matrix: (kind, slot id or None, qubit axes)."""
    return (op[0], op[1] if op[0] == "slot" else None, tuple(op[2]))


@pytest.mark.parametrize("config,window", [("hwe16", 8), ("hwe16", 9),
                                           ("sup12", 8)])
def test_plan_segments_equals_jax(config, window):
    """Same perms, same op ranges, same re-tile orders as the JAX planner
    on the same fused suffix: every later comparison rests on this."""
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
    plan = bk.build_plan(tv, name, window)
    assert plan.w == window
    assert plan.perms == [p for p, _ in want]
    assert [e - s for s, e in plan.segments] == [len(o) for _, o in want]
    assert plan.segments[0][0] == 0
    assert plan.segments[-1][1] == len(t_suffix) == len(plan.ops)
    assert plan.retiles == [
        j_perm_dst_bits(want[k][0], want[k + 1][0], n)
        for k in range(len(want) - 1)
    ]
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
    # the suffix is two slot ops: a 2-bit window splits it and re-tiles
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
