"""The CUDA kernels on the card against their plain PyTorch versions.

This file imports only the torch port (no JAX), so it also runs on the
card's machine: ``python -m pytest -m cuda tests/test_torch_kernel_cuda.py``.
Without a card every test skips (the CUDA kernel has no CPU mode).
Tolerance 1e-5: f32, different summation order."""
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
    Circuit,
    Instruction,
    Register,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    blocked_kernel as bk,
    kernel_build,
    op_rewrite,
    sv_kernel as sv,
    variant_kernel as vk,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.variant_engine import (  # noqa: E501
    label_strides,
    variant_index_table,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_gates import (  # noqa: E501
    VirtualGateOp,
)
import torch_threads  # noqa: F401 (torch's threads: a share of the cores)

TOL = 1e-5


def _chain(nbig: int = 9):
    cut = Circuit([Register("frag0", nbig), Register("frag1", 2)], nbig + 2)
    cut.h(0)
    for i in range(nbig - 1):
        cut.cx(i, i + 1)
    for q in range(nbig):
        cut.rz(0.1 * (q + 1), q)
    cut.append(Instruction("vgate", [nbig - 1, nbig],
                           op=VirtualGateOp("cz")))
    cut.append(Instruction("vgate", [0, nbig],
                           op=VirtualGateOp("cp", params=(0.7,))))
    cut.cx(nbig, nbig + 1)
    for q in range(nbig + 2):
        cut.measure(q, q)
    return VirtualCircuit(cut)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return "cuda"


def _block(virt, c, seed):
    """``c`` labels of the grid: drawn with ``seed``, or the first ``c``
    in natural order (``seed=None``)."""
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, total = label_strides(specs, range(len(specs)))
    vidx = variant_index_table(range(len(specs)), strides, n_inst, total)
    if seed is None:
        return torch.as_tensor(vidx[:c], dtype=torch.int64)
    perm = np.random.default_rng(seed).permutation(total)[:c]
    return torch.as_tensor(vidx[perm], dtype=torch.int64)


# epilogues: full rows, and the fold keeping 9, 1 and 0 (z) data bits, so
# 2^d outputs cover both the one-thread-per-output and the tree-sum path
EPILOGUES = {"full": None, "fold": {}, "keep1": {"keep_clbits": [0]},
             "z": {"z_clbits": [0, 3, 7]}}


# folded rows of a cluster that shares a global-memory state against one
# CTA's: only the order of the CTAs' partial sums differs
CLUSTER_TOL = 1e-6


def _check_cluster_sizes(rows, folded):
    """``rows(csize)`` at every cluster size the global-memory path takes:
    each launch reports its size and counts in ``variant_rows.clustered``
    past one CTA; full rows equal one CTA's bit for bit, folded rows
    within ``CLUSTER_TOL``; a second launch equal bit for bit."""
    one = rows(1)
    for g in range(1, vk.MAX_CLUSTER + 1):
        before = vk.variant_rows.clustered
        got = rows(g)
        torch.cuda.synchronize()
        assert vk.variant_rows.last_launch["cluster"] == g
        assert vk.variant_rows.clustered == before + (g > 1)
        assert torch.equal(rows(g), got)
        if folded:
            assert (got - one).abs().max().item() <= CLUSTER_TOL
        else:
            assert torch.equal(got, one)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("cap", [1, 3, 36])
@pytest.mark.parametrize("n", [11, 16, 18, 20])
def test_kernel_matches_plain_on_card(card, n, epilogue, staged, cap):
    """Random labels in the order given, runs of at most ``cap`` rows:
    one launch, rows within 1e-5 of the plain version, a second launch
    equal bit for bit.  From n = 16 (global memory) every cluster size
    too (:func:`_check_cluster_sizes`)."""
    virt = _chain(n - 2)
    blk = _block(virt, 36, 1).to(card)
    kw = EPILOGUES[epilogue]
    folded = kw is not None
    if folded:
        fn, _ = vk.make_folded_chunk_kernel(virt, "frag0", 36, staged=staged,
                                            device=card, **kw)
    else:
        fn, _ = vk.make_chunk_kernel(virt, "frag0", 36, staged=staged,
                                     device=card)
    dp = fn.plan
    ent = dp.gather_entries(blk)
    n_w = max(1, len(dp.plan.fold[0])) if folded else 1
    ws = torch.rand((36, n_w, 2), device=card, dtype=torch.float32)
    st = dp.stages(blk)
    before = vk.variant_rows.launches
    got = vk.variant_rows(dp, ent, ws, st, cap)
    again = vk.variant_rows(dp, ent, ws, st, cap)
    want = vk.plain_variant_rows(dp, ent, ws)
    torch.cuda.synchronize()
    assert vk.variant_rows.launches == before + 2
    assert (got - want).abs().max().item() <= TOL
    assert torch.equal(got, again)
    if n > kernel_build.CLUSTER_QUBITS:
        _check_cluster_sizes(
            lambda g: vk.variant_rows(dp, ent, ws, st, cap, csize=g), folded)


def _wide_chain(nbig: int):
    """frag0: ``nbig`` data qubits (``nbig + 3`` simulated: 13, 15, 18 for
    10, 12, 15) under three cuts, a cz, a cp and a cz, with entangling
    layers between them, so a chunk has three segments: a global
    checkpoint and the register one; every row kind, and rows on the
    split bit of a 15-qubit state."""
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
    return VirtualCircuit(cut)


_WIDE_CHAINS: dict = {}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fold", "full"])
@pytest.mark.parametrize("order", ["natural", "shuffled"])
@pytest.mark.parametrize("n", [13, 15, 16, 18, 20])
def test_kernel_width_classes_on_card(card, n, order, mode):
    """Every width class of the kernel: one CTA's shared memory (13), a
    two-CTA cluster (15), global scratch that a cluster shares (16, 18,
    20); all 216 labels through the row function's call (sorted by slot
    digits, rows put back), in natural and shuffled order, fold and full
    rows.  One launch a call, rows within 1e-5 of the plain version on
    the order given, a second call equal bit for bit; in global memory
    the cluster :func:`vk.cluster_size` chose, and every size
    (:func:`_check_cluster_sizes`)."""
    if n not in _WIDE_CHAINS:
        _WIDE_CHAINS[n] = _wide_chain(n - 3)
    virt = _WIDE_CHAINS[n]
    if mode == "fold":
        fn, _ = vk.make_folded_chunk_kernel(virt, "frag0", 216, device=card)
    else:
        fn, _ = vk.make_chunk_kernel(virt, "frag0", 216, device=card)
    dp = fn.plan
    assert dp.plan.n == n and len(dp.plan.row_segments) == 3
    blk = _block(virt, 216, 0 if order == "shuffled" else None).to(card)
    before = vk.variant_rows.launches
    got = vk.label_rows(dp, blk, fn.weigh)
    torch.cuda.synchronize()
    launch = dict(vk.variant_rows.last_launch)
    again = vk.label_rows(dp, blk, fn.weigh)
    want = vk.plain_variant_rows(dp, dp.gather_entries(blk), fn.weigh(blk))
    torch.cuda.synchronize()
    assert vk.variant_rows.launches == before + 2
    if n > kernel_build.CLUSTER_QUBITS:
        def caps(g):
            return vk._capacity(vk.LIBRARY.lib, launch["threads"],
                                launch["smem"], g, True)

        assert launch["cluster"] == vk.cluster_size(n, 216, launch["cap"],
                                                    caps)
    else:
        assert launch["cluster"] == (2 if n == 15 else 1)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    assert torch.equal(got, again)
    if n > kernel_build.CLUSTER_QUBITS:
        _check_cluster_sizes(
            lambda g: vk.label_rows(dp, blk, fn.weigh, csize=g),
            mode == "fold")
    # the schedule launch against its plain version: order, stages, runs
    order = dp.order(blk)
    stage = dp.stages(blk[order])
    table, count = vk.run_table(stage, 3, launch["cap"])
    r = int(count)
    assert torch.equal(launch["order"].long(), order)
    assert torch.equal(launch["stage"], stage)
    assert int(launch["runs"]) == r
    assert torch.equal(launch["table"][:r], table[:r])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [13, 20])
def test_kernel_clusters_engage_on_card(card, n):
    """The scan's chunk as the cell ``syc32-rcs`` sends it: 64 labels of
    syc-32 d3 (the stored P2 Q17 plan, two 20-qubit fragments) in natural
    order take a cluster of CTAs on the global-memory path and count in
    ``variant_rows.clustered`` and ``variant_rows.tiled``; a 13-qubit
    chunk does neither."""
    if n == 20:
        virt = _stored_cut("syc", 32, 3, 17, "syc32_d3_p2_q17")
    else:
        if 13 not in _WIDE_CHAINS:
            _WIDE_CHAINS[13] = _wide_chain(10)
        virt = _WIDE_CHAINS[13]
    blk = _block(virt, 64, None).to(card)
    for name in (reg.name for reg in virt.fragments):
        fn, _ = vk.make_folded_chunk_kernel(virt, name, 64, device=card)
        if fn.plan.plan.n != n:
            continue
        before = vk.variant_rows.clustered
        tiled = vk.variant_rows.tiled
        got = vk.label_rows(fn.plan, blk, fn.weigh)
        torch.cuda.synchronize()
        launch = vk.variant_rows.last_launch
        want = vk.plain_variant_rows(fn.plan, fn.plan.gather_entries(blk),
                                     fn.weigh(blk))
        assert (got - want).abs().max().item() <= TOL
        assert (launch["cluster"] > 1) == (n == 20)
        assert vk.variant_rows.clustered == before + (n == 20)
        assert vk.variant_rows.tiled == tiled + (n == 20)


_TILE_CASES: dict = {}


def _tile_case(card, n, mode):
    """A chunk of 216 labels of ``_wide_chain`` drawn with repeats, in
    launch order (sorted by slot digits), its stages, entries and
    weights, and the plain version's rows and the kernel schedule's
    replay (cap 4: runs open inside label groups)."""
    if (n, mode) in _TILE_CASES:
        return _TILE_CASES[n, mode]
    if n not in _WIDE_CHAINS:
        _WIDE_CHAINS[n] = _wide_chain(n - 3)
    virt = _WIDE_CHAINS[n]
    if mode == "fold":
        fn, _ = vk.make_folded_chunk_kernel(virt, "frag0", 216, device=card)
    else:
        fn, _ = vk.make_chunk_kernel(virt, "frag0", 216, device=card)
    dp = fn.plan
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, total = label_strides(specs, range(len(specs)))
    vidx = variant_index_table(range(len(specs)), strides, n_inst, total)
    pick = np.sort(np.random.default_rng(n).integers(0, total, 216))
    blk = torch.as_tensor(vidx[pick], dtype=torch.int64, device=card)
    blk = blk[dp.order(blk)]
    ent, ws, st = dp.gather_entries(blk), fn.weigh(blk), dp.stages(blk)
    want = vk.plain_variant_rows(dp, ent, ws)
    replay = vk.replay_kernel_table(dp, ent, ws, st, 4)
    _TILE_CASES[n, mode] = (dp, ent, ws, st, want, replay)
    return _TILE_CASES[n, mode]


@pytest.mark.cuda
@pytest.mark.parametrize("csize", [1, 2, 8])
@pytest.mark.parametrize("mode", ["fold", "full"])
@pytest.mark.parametrize("n", [16, 18, 20])
def test_kernel_tile_passes_on_card(card, n, mode, csize):
    """The global-memory path's tile passes: a segment whose bits
    overflow the window splits into two passes, the fold keeps bits
    outside the last pass's window, labels repeat (stage n_seg: the last
    segment replayed from its checkpoint) and runs open inside label
    groups (cap 4).  Each launch counts in ``variant_rows.tiled``; rows
    within 1e-5 of the plain version and of the schedule's replay, a
    second launch equal bit for bit, full rows equal to one CTA's bit
    for bit and folded rows within ``CLUSTER_TOL``."""
    dp, ent, ws, st, want, replay = _tile_case(card, n, mode)
    tiles, n_seg = dp.plan.tiles, len(dp.plan.row_segments)
    assert tiles is not None and tiles.segment_passes[0] > 1
    assert (st == n_seg).any()
    heads = vk.run_heads(st, n_seg, 4)
    assert (st[heads] > 0).any()
    if mode == "fold":
        d = dp.plan.fold[2]
        assert int(tiles.passes[-1, 2]) & ((1 << d) - 1) != (1 << d) - 1
    before = vk.variant_rows.tiled
    got = vk.variant_rows(dp, ent, ws, st, 4, csize=csize)
    torch.cuda.synchronize()
    launch = vk.variant_rows.last_launch
    assert vk.variant_rows.tiled == before + 1 and launch["tiled"]
    assert launch["cluster"] == csize
    assert launch["window"] == tiles.window
    assert launch["tile_passes"] == tiles.segment_passes
    assert (got - want).abs().max().item() <= TOL
    assert (got - replay).abs().max().item() <= TOL
    assert torch.equal(vk.variant_rows(dp, ent, ws, st, 4, csize=csize), got)
    one = vk.variant_rows(dp, ent, ws, st, 4, csize=1)
    if mode == "full":
        assert torch.equal(got, one)
    else:
        assert (got - one).abs().max().item() <= CLUSTER_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [13, 15, 16])
def test_kernel_tiles_count_on_the_global_path_only(card, n):
    """``variant_rows.tiled`` counts a rows launch that takes tile passes
    (16 to 20 qubits), and none on the shared-memory path (13, 15)."""
    if n not in _WIDE_CHAINS:
        _WIDE_CHAINS[n] = _wide_chain(n - 3)
    virt = _WIDE_CHAINS[n]
    fn, _ = vk.make_folded_chunk_kernel(virt, "frag0", 36, device=card)
    blk = _block(virt, 36, 2).to(card)
    before = vk.variant_rows.tiled
    got = vk.label_rows(fn.plan, blk, fn.weigh)
    torch.cuda.synchronize()
    tiled = n > kernel_build.CLUSTER_QUBITS
    assert vk.variant_rows.tiled == before + tiled
    assert vk.variant_rows.last_launch["tiled"] == tiled
    assert (vk.variant_rows.last_launch["window"] is None) != tiled
    want = vk.plain_variant_rows(fn.plan, fn.plan.gather_entries(blk),
                                 fn.weigh(blk))
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("labels", [1, 7, 8192, 9000])
def test_kernel_schedule_sizes_on_card(card, labels):
    """Chunks of labels drawn with repeats (equal neighbours resume past
    the last segment) from one to past the 8192 one schedule launch
    sorts (then two launches): rows within 1e-5 of the plain version."""
    virt = _chain()
    fn, _ = vk.make_folded_chunk_kernel(virt, "frag0", labels, device=card)
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, total = label_strides(specs, range(len(specs)))
    vidx = variant_index_table(range(len(specs)), strides, n_inst, total)
    pick = np.random.default_rng(labels).integers(0, total, labels)
    blk = torch.as_tensor(vidx[pick], dtype=torch.int64, device=card)
    before = vk.variant_rows.launches
    got = vk.label_rows(fn.plan, blk, fn.weigh)
    torch.cuda.synchronize()
    assert vk.variant_rows.launches == before + (2 if labels > 8192 else 1)
    want = vk.plain_variant_rows(fn.plan, fn.plan.gather_entries(blk),
                                 fn.weigh(blk))
    assert (got - want).abs().max().item() <= TOL


def _deep_chain(nbig: int = 14):
    """A 16-qubit fragment whose suffix is long: entangling layers after
    each of two cuts, so small windows give many segments."""
    cut = Circuit([Register("frag0", nbig), Register("frag1", 2)], nbig + 2)
    cut.h(0)
    for i in range(nbig - 1):
        cut.cx(i, i + 1)
    cut.append(Instruction("vgate", [nbig - 1, nbig],
                           op=VirtualGateOp("cz")))
    for i in range(nbig - 1):
        cut.ry(0.3 + 0.05 * i, i)
        cut.cx(i, i + 1)
    cut.append(Instruction("vgate", [0, nbig],
                           op=VirtualGateOp("cp", params=(0.7,))))
    for i in range(0, nbig - 2, 2):
        cut.cz(i, i + 2)
        cut.rx(0.2 + 0.1 * i, i + 1)
    cut.cx(nbig, nbig + 1)
    for q in range(nbig + 2):
        cut.measure(q, q)
    return VirtualCircuit(cut)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [8, 13, 14])
@pytest.mark.parametrize("pinned", [3, 5])
@pytest.mark.parametrize("labels", [1, 3, 36])
def test_blocked_kernel_matches_plain_on_card(card, window, pinned, labels):
    """Every segment launch counted; the prefix and the rows against the
    plain version, a second launch equal bit for bit, and the rows,
    marginalised, against the variant kernel's."""
    virt = _deep_chain()
    assert virt.programs["frag0"].num_sim_qubits >= 15
    blk = _block(virt, labels, 2).to(card)
    fn, pos = bk.make_blocked_chunk_kernel(virt, "frag0", labels,
                                           window=window, force=True,
                                           device=card, pinned=pinned)
    dp = fn.plan
    assert dp.plan.w == window and dp.plan.pinned == pinned
    assert dp.plan.n_prefix >= 1
    if window == 8:
        assert len(dp.plan.segments) >= 3
    prefix_err = (dp.prefix - bk.plain_prefix_state(dp)).abs().max().item()
    assert prefix_err <= TOL
    ent = dp.gather_entries(blk)
    before = bk.blocked_rows.launches
    got = bk.blocked_rows(dp, ent)
    torch.cuda.synchronize()
    assert bk.blocked_rows.launches == before + len(dp.plan.segments)
    assert torch.equal(bk.blocked_rows(dp, ent), got)
    want = bk.plain_blocked_rows(dp, ent)
    assert (got - want).abs().max().item() <= TOL
    v_fn, v_pos = vk.make_chunk_kernel(virt, "frag0", labels, device=card)
    assert v_pos == pos
    assert (fn(blk) - v_fn(blk)).abs().max().item() <= TOL


def _pauli_chain(nbig: int = 14):
    """A 16-qubit fragment whose gates fuse into signed permutations with
    phases (cx, y, swap, x), so segments fold moves with phases into
    their copies, around a cut and a dense gate."""
    cut = Circuit([Register("frag0", nbig), Register("frag1", 2)], nbig + 2)
    cut.h(0)
    cut.ry(0.4, 3)
    for i in range(nbig - 1):
        cut.cx(i, i + 1)
        cut.y(i)
    cut.append(Instruction("vgate", [nbig - 1, nbig],
                           op=VirtualGateOp("cz")))
    for i in range(nbig - 1):
        cut.swap(i, i + 1)
        cut.x(i + 1)
    cut.rx(0.3, 5)
    for i in range(nbig - 1):
        cut.cx(i + 1, i)
        cut.y(i + 1)
    cut.rx(0.2, 9)
    cut.cx(nbig, nbig + 1)
    for q in range(nbig + 2):
        cut.measure(q, q)
    return VirtualCircuit(cut)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [8, 13])
@pytest.mark.parametrize("pinned", [0, 3])
def test_blocked_kernel_folded_moves_match_plain(card, window, pinned):
    """Moves with phases folded into the gathers and scatters, with
    4-float copies (3 pinned bits) and with 1-float ones (none): the
    prefix and the rows equal the plain version's."""
    virt = _pauli_chain()
    fn, _ = bk.make_blocked_chunk_kernel(virt, "frag0", 3, window=window,
                                         force=True, device=card,
                                         pinned=pinned)
    dp = fn.plan
    assert dp.plan.pinned == pinned
    assert any(a for a, _ in dp.plan.phased)
    assert any(b for _, b in dp.plan.phased)
    assert sum(a + b for a, b in dp.plan.folded) > 0
    assert (dp.prefix - bk.plain_prefix_state(dp)).abs().max().item() <= TOL
    ent = dp.gather_entries(_block(virt, 3, 5).to(card))
    got = bk.blocked_rows(dp, ent)
    assert torch.equal(bk.blocked_rows(dp, ent), got)
    assert (got - bk.plain_blocked_rows(dp, ent)).abs().max().item() <= TOL


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


@pytest.mark.cuda
@pytest.mark.parametrize("window", [8, 13])
def test_blocked_kernel_moves_on_the_low_bits_match_plain(card, window):
    """4-float copies (3 pinned bits) on segments that start with a cx on
    tile bit 0 or 1 and a bit above: the card's prefix equals the plain
    version's and the rows the uncut oracle's, a second launch bit for
    bit."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
        simulate_circuit,
    )

    circ = _low_bit_ladder()
    virt = VirtualCircuit(circ)
    name = virt.fragments[0].name
    fn, pos = bk.make_blocked_chunk_kernel(virt, name, 1, window=window,
                                           force=True, device=card,
                                           pinned=3)
    dp = fn.plan
    starts = [dp.plan.table.rows[r0] for r0, r1, _, _ in
              dp.plan.row_segments if r1 > r0]
    assert any(r[0] == op_rewrite.OP_PERM2
               and min(r[1], r[2]) < 2 <= max(r[1], r[2]) for r in starts)
    assert (dp.prefix - bk.plain_prefix_state(dp)).abs().max().item() <= TOL
    blk = torch.zeros((1, 0), dtype=torch.int64, device=card)
    got = fn(blk)
    assert torch.equal(fn(blk), got)
    want = simulate_circuit(circ, device=card)
    assert list(want.bit_positions) == pos
    err = np.abs(got[0].cpu().numpy() - np.asarray(want.values)).max()
    assert err <= TOL


@pytest.mark.cuda
def test_blocked_plan_cache_is_per_device(card):
    """The plan cache keeps one entry a device: the CPU's plan and the
    card's are built apart and agree."""
    virt = _deep_chain()
    cpu_fn, _ = bk.make_blocked_chunk_kernel(virt, "frag0", 3, window=13,
                                             force=True, device="cpu")
    card_fn, _ = bk.make_blocked_chunk_kernel(virt, "frag0", 3, window=13,
                                              force=True, device=card)
    assert cpu_fn.plan is not card_fn.plan
    assert len(virt.__dict__[bk._CACHE]) == 2
    again, _ = bk.make_blocked_chunk_kernel(virt, "frag0", 3, window=13,
                                            force=True, device=card)
    assert again.plan is card_fn.plan
    blk = _block(virt, 3, 2)
    assert (card_fn(blk.to(card)).cpu() - cpu_fn(blk)).abs().max().item() \
        <= TOL


@pytest.mark.cuda
def test_blocked_kernel_refuses_a_wrong_state(card):
    """On a CUDA tensor the wrapper launches or raises: a state of the
    wrong shape, or a strided one (segments run in place on one layout,
    so the wrapper copies nothing), is refused before any launch."""
    virt = _deep_chain()
    fn, _ = bk.make_blocked_chunk_kernel(virt, "frag0", 3, window=8,
                                         force=True, device=card)
    dp = fn.plan
    ent = dp.gather_entries(_block(virt, 3, 2).to(card))
    big = 1 << dp.plan.n
    bad = torch.zeros((2, 2, big), device=card)
    strided = torch.zeros((3, 2, 2 * big), device=card)[:, :, ::2]
    before = bk.blocked_rows.launches
    with pytest.raises(ValueError, match="shape"):
        bk.apply_segment(dp, 0, bad, ent)
    with pytest.raises(ValueError, match="contiguous"):
        bk.apply_segment(dp, 1, strided, ent)
    assert bk.blocked_rows.launches == before


def _stored_cut(family: str, n: int, depth: int, cap: int, stored: str):
    """genCirc(family, n, depth, seed=0) cut into 2 partitions of at most
    ``cap`` qubits by the plan ``stored`` in the port's ``plans``."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch import (  # noqa: E501
        plans,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc,
    )

    cutter = Cutter(genCirc(family, n, depth, seed=0), maxNPartitions=2,
                    maxNQubitsPerPartition=cap, maxNQpdCuts=5, maxNCuts=5,
                    maxCutsPerPartitions=5)
    cutter.use_plan(plans.load_plan(stored))
    return VirtualCircuit(cutter.getResultCircs()[3])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 20])
def test_variant_prefix_built_on_card(card, n):
    """Kernel 1's shared prefix is built on the card by kernel 4's segment
    launches: one a prefix segment, counted in ``blocked_rows.launches``
    and in ``DevicePlan.prefix_launches``; the state within 1e-5 of the
    plain version's, and kernel 1's rows from it within 1e-5 of
    ``plain_variant_rows``.  n = 16: the deep chain's fragment; n = 20:
    both fragments of syc-32 d3 (the stored P2 Q17 plan)."""
    if n == 16:
        virt = _deep_chain()
        names = ["frag0"]
    else:
        virt = _stored_cut("syc", 32, 3, 17, "syc32_d3_p2_q17")
        names = [reg.name for reg in virt.fragments]
    for name in names:
        before = bk.blocked_rows.launches
        fn, _ = vk.make_folded_chunk_kernel(virt, name, 64, device=card)
        torch.cuda.synchronize()
        dp = fn.plan
        assert dp.plan.n == n and dp.prefix.device.type == "cuda"
        segments = bk.plan_prefix(dp.plan.prefix_ops, n).n_prefix
        assert dp.prefix_launches == segments >= 1
        assert bk.blocked_rows.launches == before + segments
        plain, none = bk.build_prefix(dp.plan.prefix_ops, n, "cpu")
        assert none == 0
        assert (dp.prefix.cpu() - plain).abs().max().item() <= TOL
        blk = _block(virt, 64, 5).to(card)
        got = vk.label_rows(dp, blk, fn.weigh)
        want = vk.plain_variant_rows(dp, dp.gather_entries(blk),
                                     fn.weigh(blk))
        assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
def test_narrow_prefix_on_card(card, n):
    """A chain on fewer than 3 qubits is run by the kernel as the low
    amplitudes of a 3-qubit state (window 2): one launch a segment,
    counted in ``blocked_rows.launches``, and the state within 1e-5 of
    the plain version's on the CPU."""
    rng = np.random.default_rng(n)

    def unitary(k):
        z = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
        return np.linalg.qr(z)[0]

    ops = [("u", unitary(2), (q,)) for q in range(n)]
    if n == 2:
        ops += [("u", unitary(4), (0, 1)), ("u", unitary(2), (1,))]
    before = bk.blocked_rows.launches
    state, launches = bk.build_prefix(ops, n, card)
    torch.cuda.synchronize()
    assert state.shape == (2, 1 << n) and state.is_contiguous()
    assert launches >= 1 and bk.blocked_rows.launches == before + launches
    want, none = bk.build_prefix(ops, n, "cpu")
    assert none == 0
    assert (state.cpu() - want).abs().max().item() <= TOL
    assert abs((want ** 2).sum().item() - 1) <= TOL


@pytest.mark.cuda
def test_blocked_prefix_through_the_shared_routine(card):
    """Kernel 4's hwe-40 prefix (the stored P2 Q21 plan, 22-qubit
    fragments) comes from the routine kernel 1's prefix uses: its plan's
    prefix segments are ``plan_prefix``'s, row for row, and
    ``build_prefix`` on the same gates launches as many segments and
    gives the device plan's prefix bit for bit, within 1e-5 of the plain
    version's."""
    virt = _stored_cut("hwe", 40, 2, 21, "hwe40_d2_p2_q21")
    for reg in virt.fragments:
        dp = bk.device_plan(virt, reg.name, bk.DEFAULT_WINDOW,
                            bk.DEFAULT_PINNED, card)
        ops, _, prog = op_rewrite._plan_ops(virt, reg.name)
        pre = bk.plan_prefix(ops, prog.num_sim_qubits)
        g = pre.n_prefix
        assert dp.plan.n_prefix == g
        assert dp.plan.row_segments[:g] == pre.row_segments
        r1, p1 = (dp.plan.row_segments[g - 1][1::2] if g else (0, 0))
        assert np.array_equal(dp.plan.table.rows[:r1], pre.table.rows)
        assert np.array_equal(dp.plan.table.pool[:p1], pre.table.pool)
        assert np.array_equal(dp.plan.tables[:g], pre.tables)
        assert np.array_equal(dp.plan.phases[:g], pre.phases)
        before = bk.blocked_rows.launches
        state, launches = bk.build_prefix(ops, prog.num_sim_qubits, card)
        torch.cuda.synchronize()
        assert launches == g
        assert bk.blocked_rows.launches == before + g
        assert torch.equal(state, dp.prefix)
        assert (dp.prefix - bk.plain_prefix_state(dp)).abs().max().item() \
            <= TOL


@pytest.mark.cuda
def test_hwe40_depth4_request_on_card_equals_two_blocks(card):
    """A request of the benchmark's cell ``hwe40-sweep`` at full size:
    hwe-40 at depth 4, fresh angles, through ``run_virtual_circuit(
    engine="pallas")``; kernel 4 computes every row (1296 labels x 2
    fragments of 24 qubits), kernel 1 none, and the 2^20 marginal is
    within the cell's limit of the two-block reference (complex128)."""
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from portbench.cell import Port, instances, load_cell, run_kwargs

    cell = load_cell("hwe40-sweep")
    inst = instances(cell, 3)[0]
    rows, variant = bk.blocked_rows.rows, vk.variant_rows.launches
    answer, _ = Port().serve(cell, inst, card, **run_kwargs(cell))
    assert bk.blocked_rows.rows - rows == 1296 * 2
    assert vk.variant_rows.launches == variant
    assert len(answer["values"]) == 1 << 20
    assert cell.check.compare(cell, inst, answer, card) <= \
        cell.config["limit"]


# ---------------------------------------------------------------------------
# The collapse kernel (csrc/collapse_kernel.cu)
# ---------------------------------------------------------------------------

def _qft_gamma_cut(n: int):
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc,
    )

    cutter = Cutter(genCirc("qft", n, 1), maxNPartitions=2,
                    maxNQubitsPerPartition=n - 1, gammaMode=True)
    assert cutter.solve()
    return VirtualCircuit(cutter.getResultCircs()[3])


_COLLAPSE_CUTS: dict = {}


def _collapse_case(n: int):
    """(virt, fragment name) whose collapse-mode state has ``n`` qubits:
    qft-9 cut 8|1 gives n = 8 and n = 1, qft-16 cut 15|1 n = 15."""
    total = 16 if n == 15 else 9
    if total not in _COLLAPSE_CUTS:
        _COLLAPSE_CUTS[total] = _qft_gamma_cut(total)
    virt = _COLLAPSE_CUTS[total]
    frag = next(r.name for r in virt.fragments
                if virt.programs[r.name].num_data_qubits == n)
    return virt, frag


COLLAPSE_EPILOGUES = {
    "rows": {},
    "marginal": {"keep_clbits": {0, 1, 2, 3}},
    "z": {"z_sets": [{0}, {1, 2}, set(range(16))]},
}


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", sorted(COLLAPSE_EPILOGUES))
@pytest.mark.parametrize("labels", [1, 3, 1024, 4096])
@pytest.mark.parametrize("n", [1, 8, 15])
def test_collapse_kernel_matches_plain_on_card(card, n, labels, epilogue):
    """Random labels, draws, measure flags and weights: picked bits equal
    (a flip only within 1e-6 of a threshold), rows within 1e-5, one
    launch counted."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        collapse_kernel as ck,
    )

    virt, frag = _collapse_case(n)
    plan = ck.build_plan(virt, frag, **COLLAPSE_EPILOGUES[epilogue])
    assert plan.n == n and len(plan.site_meta) >= 8
    dp = ck.CollapseDevicePlan(plan, card)
    rng = np.random.default_rng(100 * n + labels)
    lab = np.stack([rng.integers(0, vg.spec.num_instantiations, labels)
                    for vg in virt.vgates], axis=1)
    cscal = np.empty((labels, plan.n_sites, 4), np.float32)
    cscal[:, :, 0] = rng.random((labels, plan.n_sites))
    cscal[:, :, 1] = rng.integers(0, 2, (labels, plan.n_sites))
    cscal[:, :, 2:] = rng.uniform(-1, 1, (labels, plan.n_sites, 2))
    ent = dp.gather_entries(torch.as_tensor(lab, device=card))
    cscal = torch.as_tensor(cscal, device=card)
    before = ck.collapse_rows.launches
    got, bits = ck.collapse_rows(dp, ent, cscal)
    torch.cuda.synchronize()
    assert ck.collapse_rows.launches == before + 1
    want, wbits, margins = ck.plain_collapse_rows(dp, ent, cscal,
                                                  with_margins=True)
    assert got.shape == want.shape == (labels, plan.out_width)
    assert torch.isfinite(got).all()
    agree, near, far = ck.compare_picks(bits, wbits, margins)
    assert far == 0 and near <= max(1, labels // 100)
    assert (got - want)[agree].abs().max().item() <= TOL
    # a second launch repeats the first bit for bit (fixed-order sums)
    again, bits2 = ck.collapse_rows(dp, ent, cscal)
    assert torch.equal(again, got) and torch.equal(bits2, bits)


@pytest.mark.cuda
def test_collapse_kernel_refuses_wrong_scalars(card):
    """On a CUDA tensor the wrapper launches or raises: a scalar block of
    the wrong shape is refused before any launch."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        collapse_kernel as ck,
    )

    virt, frag = _collapse_case(8)
    dp = ck.CollapseDevicePlan(ck.build_plan(virt, frag), card)
    ent = dp.gather_entries(torch.zeros((3, len(virt.vgates)),
                                        dtype=torch.int64, device=card))
    before = ck.collapse_rows.launches
    with pytest.raises(ValueError, match="shape"):
        ck.collapse_rows(dp, ent, torch.zeros((3, 1, 4), device=card))
    assert ck.collapse_rows.launches == before


def _collapse_wide(n: int):
    """frag0: ``n`` data qubits, cut from a 1-qubit frag1 by two cz gate
    cuts, one on qubit 0 (flat bit n-1: the split bit of a 15-qubit state
    held by two CTAs) and one on qubit n-1; between them a cx chain, a cp
    ladder from qubit 0 and dense rotations, so the rewritten table holds
    every row kind."""
    cut = Circuit([Register("frag0", n), Register("frag1", 1)], n + 1)
    for q in range(n):
        cut.h(q)
    for q in range(n - 1):
        cut.cx(q, q + 1)
    cut.append(Instruction("vgate", [0, n], op=VirtualGateOp("cz")))
    for q in range(1, n):
        cut.cp(0.3 * q, 0, q)
    cut.ry(0.4, 0)
    cut.rx(0.3, n - 1)
    cut.append(Instruction("vgate", [n - 1, n], op=VirtualGateOp("cz")))
    cut.cx(0, n - 1)
    cut.h(n)
    for q in range(n + 1):
        cut.measure(q, q)
    return VirtualCircuit(cut)


def _replica_block(plan, virt, order, seed):
    """Label rows the way the sampled engine lays them out: unique labels,
    each repeated side by side (one of them 150 times, past the run cap),
    the replicas differing only in u; some labels measure nowhere.
    ``order="shuffled"``: the same rows in a random order."""
    rng = np.random.default_rng(seed)
    uniq = np.stack([rng.integers(0, vg.spec.num_instantiations, 40)
                     for vg in virt.vgates], axis=1)
    counts = rng.integers(1, 9, 40)
    counts[7] = 150
    ns = plan.n_sites
    mflag = rng.integers(0, 2, (40, ns)).astype(np.float32)
    mflag[::5] = 0.0                       # these measure nowhere
    w = rng.uniform(-1, 1, (40, ns, 2)).astype(np.float32)
    lab = np.repeat(uniq, counts, axis=0)
    cscal = np.empty((len(lab), ns, 4), np.float32)
    cscal[:, :, 0] = rng.random((len(lab), ns))
    cscal[:, :, 1] = np.repeat(mflag, counts, axis=0)
    cscal[:, :, 2:] = np.repeat(w, counts, axis=0)
    if order == "shuffled":
        perm = rng.permutation(len(lab))
        lab, cscal = lab[perm], cscal[perm]
    return lab, cscal


RUN_EPILOGUES = {
    "rows": lambda n: {},
    "marginal_split": lambda n: {"keep_clbits": {0, 1, n - 1}},
    "marginal_low": lambda n: {"keep_clbits": {2, 3}},
    "z": lambda n: {"z_sets": [{0}, {1, 2}, set(range(n))]},
}
RUN_CASES = [(n, order, epi) for n in (13, 14, 15, 16, 20)
             for order in ("replicas", "shuffled")
             for epi in sorted(RUN_EPILOGUES)
             if epi != "rows" or n <= 15]
_WIDE_COLLAPSE: dict = {}


@pytest.mark.cuda
@pytest.mark.parametrize("n,order,epilogue", RUN_CASES)
def test_collapse_kernel_replica_runs_on_card(card, n, order, epilogue):
    """Replica runs at every state layout: one CTA's shared memory (13,
    14), a two-CTA cluster (15, no global scratch), global scratch (16,
    20).  Picks equal to the plain version's (a flip only within 1e-6 of
    its threshold), rows within 1e-5, a launch repeats bit for bit."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        collapse_kernel as ck,
    )

    if n not in _WIDE_COLLAPSE:
        _WIDE_COLLAPSE[n] = _collapse_wide(n)
    virt = _WIDE_COLLAPSE[n]
    plan = ck.build_plan(virt, "frag0", **RUN_EPILOGUES[epilogue](n))
    assert plan.n == n and len(plan.site_meta) == 2
    dp = ck.CollapseDevicePlan(plan, card)
    lab, cscal = _replica_block(plan, virt, order, n)
    ent = dp.gather_entries(torch.as_tensor(lab, device=card))
    cscal = torch.as_tensor(cscal, device=card)
    before = ck.collapse_rows.launches
    got, bits = ck.collapse_rows(dp, ent, cscal)
    torch.cuda.synchronize()
    launch = dict(ck.collapse_rows.last_launch)
    assert ck.collapse_rows.launches == before + 1
    assert launch["cluster"] == (2 if n == 15 else 1)
    assert (launch["scratch_bytes"] == 0) == (n <= 15)
    if order == "replicas":
        assert int(launch["runs"]) < len(lab) // 2
    want, wbits, margins = ck.plain_collapse_rows(dp, ent, cscal,
                                                  with_margins=True)
    assert got.shape == want.shape and torch.isfinite(got).all()
    agree, near, far = ck.compare_picks(bits, wbits, margins)
    assert far == 0 and near <= max(1, len(lab) // 100)
    assert (got - want)[agree].abs().max().item() <= TOL
    again, bits2 = ck.collapse_rows(dp, ent, cscal)
    assert torch.equal(again, got) and torch.equal(bits2, bits)


def _sv_case(n: int, cut_gate: str):
    """frag0: ``n`` data qubits under a chain of fixed gates (2q gates in
    both qubit orders), cut from a 2-qubit frag1 by a gate cut (``"cz"``)
    or a wire cut (``"move"``) on its last qubit, more gates after the
    slot.  Every qubit is measured at n <= 8 (k = n), every second one at
    n = 13 (the epilogue sums the others away)."""
    cut = Circuit([Register("frag0", n), Register("frag1", 2)], n + 2)
    cut.h(0)
    for q in range(n - 1):
        if q % 2:
            cut.cx(q + 1, q)
        else:
            cut.cx(q, q + 1)
    for q in range(n):
        cut.ry(0.2 * (q + 1), q)
        cut.rz(0.1 * (q + 1), q)
    cut.append(Instruction("vgate", [n - 1, n], op=VirtualGateOp(cut_gate)))
    cut.rx(0.7, n - 1)
    if n > 1:
        cut.cp(0.9, n - 1, 0)
    cut.cx(n, n + 1)
    step = 2 if n > 8 else 1
    for c, q in enumerate(list(range(0, n, step)) + [n, n + 1]):
        cut.measure(q, c)
    return VirtualCircuit(cut)


@pytest.mark.cuda
@pytest.mark.parametrize("cut_gate", ["cz", "move"])
@pytest.mark.parametrize("lanes", [1, 12, 4096])
@pytest.mark.parametrize("n", [1, 8, 13])
def test_sv_kernel_matches_plain_on_card(card, n, lanes, cut_gate):
    virt = _sv_case(n, cut_gate)
    fn, table, meta = sv.build_fragment_kernel(virt, "frag0", device=card)
    dp = fn.plan
    assert dp.plan.n == n and dp.plan.k == len(range(0, n, 2 if n > 8 else 1))
    # lanes drawn with a seed: the kernel takes their indices, the plain
    # version their rows of the fragment's lane table
    pick = np.random.default_rng(n * 31 + lanes).integers(
        0, meta["total"], lanes)
    idx = torch.as_tensor(pick, device=card)
    before = sv.sv_rows.launches
    got = sv.sv_rows(dp, idx)
    again = sv.sv_rows(dp, idx)
    torch.cuda.synchronize()
    assert sv.sv_rows.launches == before + 2
    want = sv.plain_sv_rows(dp, torch.as_tensor(table[pick], device=card))
    assert got.shape == want.shape == (lanes, 1 << dp.plan.k)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    assert torch.equal(got, again)  # fixed summation order: bit for bit


@pytest.mark.cuda
def test_sv_kernel_whole_fragment_against_the_batched_engine(card):
    """The entry point on the card: the kernel's ``FragmentResult`` of both
    fragments against the batched engine's (2e-5, the tolerance of the JAX
    package's own comparison of the two)."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.variant_engine import (  # noqa: E501
        run_fragment,
    )

    virt = _sv_case(8, "move")
    for reg in virt.fragments:
        got = sv.run_fragment_kernel(virt, reg.name, device=card)
        want = run_fragment(virt, reg.name, device=card)
        assert got.values.is_cuda
        assert got.bit_positions == want.bit_positions
        assert got.touching == want.touching
        assert (got.values - want.values).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_sv_kernel_refuses_a_wrong_lane_table(card):
    """The kernel takes lane indices, not a lane table: anything else is
    refused before a launch."""
    virt = _sv_case(8, "cz")
    fn, table, meta = sv.build_fragment_kernel(virt, "frag0", device=card)
    good = torch.arange(4, device=card)
    before = sv.sv_rows.launches
    with pytest.raises(ValueError, match="shape"):
        sv.sv_rows(fn.plan, good[None, :].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        sv.sv_rows(fn.plan, torch.as_tensor(table[:4], device=card))
    with pytest.raises(ValueError, match="contiguous"):
        sv.sv_rows(fn.plan, torch.arange(8, device=card)[::2])
    with pytest.raises(ValueError, match="outside"):
        sv.sv_rows(fn.plan, good + meta["total"])
    assert sv.sv_rows.launches == before
    assert sv.build_fragment_kernel(_sv_case(14, "cz"), "frag0",
                                    device=card) is None


def _sv_cut(name, n, cap, depth):
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc,
    )

    cutter = Cutter(genCirc(name, n, depth, seed=0), maxNPartitions=2,
                    maxNQubitsPerPartition=cap, maxNQpdCuts=5, maxNCuts=5,
                    maxCutsPerPartitions=5)
    assert cutter.solve()
    return VirtualCircuit(cutter.getResultCircs()[3])


def _slot_free():
    cut = Circuit([Register("frag0", 4)], 4)
    cut.h(0)
    for q in range(3):
        cut.cx(q, q + 1)
    cut.ry(0.3, 2)
    for q in range(4):
        cut.measure(q, q)
    return VirtualCircuit(cut)


SV_CASES = {
    "hwe16": lambda: _sv_cut("hwe", 16, 10, 5),
    "sup20": lambda: _sv_cut("sup", 20, 10, 1),
    "wide13": lambda: _sv_case(13, "move"),
    "slot_free": _slot_free,
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SV_CASES))
def test_sv_kernel_reads_no_lane_table_on_card(card, case, monkeypatch):
    """The entry point on the card builds no host lane table
    (``_slot_lane_params`` raises if called): every lane against the plain
    version on the JAX contract's lane table, 1e-5 absolute and relative
    to the fragment's largest entry."""
    virt = SV_CASES[case]()
    tables = {}
    for reg in virt.fragments:
        plan = sv.build_plan(virt, reg.name)
        tables[reg.name] = sv._slot_lane_params(
            virt, virt.programs[reg.name], plan.meas_vgates, plan.slots)[0]

    def refuse(*args, **kw):
        raise AssertionError("a lane table was built on the card's route")

    monkeypatch.setattr(sv, "_slot_lane_params", refuse)
    for reg in virt.fragments:
        before = sv.sv_rows.launches
        got = sv.run_fragment_kernel(virt, reg.name, device=card)
        torch.cuda.synchronize()
        assert sv.sv_rows.launches == before + 1
        dp = sv.SvDevicePlan(sv.build_plan(virt, reg.name), card)
        par = tables[reg.name]
        if par.shape[1] == 0:
            par = np.zeros((par.shape[0], 1), np.float32)
        want = sv.plain_sv_rows(dp, torch.as_tensor(par, device=card))
        got = got.values.reshape(want.shape)
        err = (got - want).abs().max().item()
        assert err <= TOL and err <= TOL * want.abs().max().item() + 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,n", [("collapse", 1), ("collapse", 8),
                                      ("collapse", 15), ("sv", 1),
                                      ("sv", 8), ("sv", 13)])
def test_collapse_and_sv_prefix_built_on_card(card, kernel, n):
    """Kernels 3 and 5 build their shared prefix as kernel 1 does, by
    kernel 4's segment launches on the card (``build_prefix``): one a
    prefix segment, none for an empty chain (qft-9's 1-qubit fragment),
    counted in ``blocked_rows.launches`` and in the device plan's
    ``prefix_launches``; the state within 1e-5 of the plain version's
    (``plain_prefix_state``, through ``build_prefix`` on the CPU).
    n = 15: qft-16's wide fragment, the ``qft16-sampled`` cell's; n = 1:
    a chain run as the low amplitudes of a 3-qubit state."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        collapse_kernel as ck,
    )

    before = bk.blocked_rows.launches
    if kernel == "collapse":
        virt, frag = _collapse_case(n)
        dp = ck.CollapseDevicePlan(ck.build_plan(virt, frag), card)
    else:
        dp = sv.SvDevicePlan(sv.build_plan(_sv_case(n, "cz"), "frag0"),
                             card)
    torch.cuda.synchronize()
    assert dp.plan.n == n and dp.prefix.device.type == "cuda"
    assert (dp.prefix_launches >= 1) == bool(dp.plan.prefix_ops)
    assert bk.blocked_rows.launches == before + dp.prefix_launches
    plain, none = bk.build_prefix(dp.plan.prefix_ops, n, "cpu")
    assert none == 0 and dp.prefix.shape == plain.shape == (2, 1 << n)
    assert (dp.prefix.cpu() - plain).abs().max().item() <= TOL


# ---------------------------------------------------------------------------
# The streamed scan without a kernel (plain PyTorch): the card against the
# same scan on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, 5e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("share_prefix", [False, True])
def test_streamed_scan_on_card_matches_cpu(card, dtype, tol, share_prefix):
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
        make_streamed_knit,
    )

    virt = _chain()
    got = {}
    for dev in ("cpu", card):
        step, xs, meta = make_streamed_knit(virt, 4, share_prefix=share_prefix,
                                            dtype=dtype, device=dev)
        got[dev] = step(xs).cpu().numpy()
        assert meta["pallas_fragments"] == {r.name: False
                                            for r in virt.fragments}
    np.testing.assert_allclose(got[card], got["cpu"], atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-2, 5e-2])
def test_streamed_truncation_on_card_matches_cpu(card, eps):
    """Certified truncation that drops labels (cp cuts of small angle:
    skewed QPD weights), with banks, so the card runs the gather over the
    kept labels and the per-label staged suffix: equal to the same scan
    on the CPU, within the certified L1 bound of the exact result."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
        make_streamed_knit,
        run_virtual_circuit_streamed,
    )

    n = 6
    circ = Circuit(n, n)
    for q in range(n):
        circ.h(q)
    circ.cp(np.pi / 8, 0, n - 1)
    circ.cp(np.pi / 16, 1, n - 2)
    for i in range(n - 1):
        circ.cx(i, i + 1)
    for q in range(n):
        circ.measure(q, q)
    cutter = Cutter(circ, maxNPartitions=2, maxNQubitsPerPartition=4,
                    maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    assert cutter.solve()
    virt = VirtualCircuit(cutter.getResultCircs()[3])
    exact = run_virtual_circuit_streamed(virt, 32, device=card).values
    got = {}
    for dev in ("cpu", card):
        step, xs, meta = make_streamed_knit(virt, 32, trunc_eps=eps,
                                            share_prefix=True, device=dev)
        got[dev] = step(xs).cpu().numpy()
    assert meta["kept_labels"] < meta["global_labels"]
    assert all(sp is not None for sp in meta["splits"])
    np.testing.assert_allclose(got[card], got["cpu"], atol=TOL)
    assert meta["dropped_mass"] <= eps
    assert float(np.abs(got[card].astype(np.float64) - exact).sum()) \
        <= meta["dropped_mass"] + TOL


@pytest.mark.cuda
def test_streamed_shots_on_card(card):
    """Device shots: counts on the card's draw, non-negative, summing to 1,
    only on outcomes the exact distribution holds."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.sampling import (  # noqa: E501
        sample_indices_device,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
        run_virtual_circuit_streamed,
    )

    virt = _chain()
    exact = run_virtual_circuit_streamed(virt, 4, project=True, device="cpu")
    dist = run_virtual_circuit_streamed(virt, 4, shots=4000, device=card)
    assert (dist.values >= 0).all()
    assert abs(float(dist.values.sum()) - 1.0) < 1e-6
    assert set(np.nonzero(dist.values)[0]) <= set(
        np.nonzero(exact.values > 0)[0])
    probs = torch.tensor([0.0, 0.25, 0.0, 0.75], device=card)
    idx = sample_indices_device(probs, 4096,
                                torch.Generator(device=card).manual_seed(0))
    assert idx.device.type == "cuda" and idx.shape == (4096,)
    assert set(idx.tolist()) <= {1, 3}


# ---------------------------------------------------------------------------
# Noisy execution (plain PyTorch, no kernel): the card against the same
# draws on the CPU
# ---------------------------------------------------------------------------

def _port_cut(name, n, cap):
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc,
    )

    cutter = Cutter(genCirc(name, n, 1), maxNPartitions=2,
                    maxNQubitsPerPartition=cap, maxNQpdCuts=5, maxNCuts=5,
                    maxCutsPerPartitions=5)
    assert cutter.solve()
    return cutter.getResultCircs()[3]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ghz6_routed", "sup12_t4"])
@pytest.mark.parametrize("engine", ["streamed", "auto"])
def test_noisy_routes_on_card_match_cpu(card, case, engine):
    """``run_noisy_virtual_circuit`` with ``fake_kolkata_v2`` (routed onto
    the heavy hex, calibrated gate and readout rates): the card's result
    equals the CPU's from the same seed (the branch indices are numpy
    draws), within 1e-5; so does the noisy streamed observable."""
    import dataclasses

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        noise,
        streamed,
    )

    cut = (_port_cut("ghz", 6, 4) if case == "ghz6_routed"
           else _port_cut("sup", 12, 7))
    nm = dataclasses.replace(noise.fake_kolkata_v2(), trajectories=4)
    got = {}
    for dev in ("cpu", card):
        got[dev], _ = noise.run_noisy_virtual_circuit(
            VirtualCircuit(cut), nm, engine=engine, seed=3, chunk_size=64,
            device=dev)
    np.testing.assert_allclose(got[card].values, got["cpu"].values, atol=TOL)
    virt = VirtualCircuit(cut)
    z = sorted(c for p in virt.programs.values() for c in p.clbit_sources
               if c < virt.num_clbits)[:2]
    zs = [streamed.streamed_expectation_z(virt, z, chunk=64, noise=nm,
                                          seed=4, device=dev)
          for dev in ("cpu", card)]
    assert abs(zs[0] - zs[1]) <= TOL


@pytest.mark.cuda
def test_noisy_uncut_simulator_on_card_matches_cpu(card):
    """``simulate_noisy_circuit``: routed trajectories and the
    untranspiled first-order mixture, card against CPU."""
    import dataclasses

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        noise,
    )

    circ = genCirc("ghz", 8, 1)
    for nm in (dataclasses.replace(noise.fake_kolkata_v2(), trajectories=4),
               dataclasses.replace(noise.fake_kolkata_v2(),
                                   untranspiled=True)):
        a = noise.simulate_noisy_circuit(circ, nm, seed=2, device="cpu")
        b = noise.simulate_noisy_circuit(circ, nm, seed=2, device=card)
        np.testing.assert_allclose(b.values, a.values, atol=TOL)


# ---------------------------------------------------------------------------
# The sampled engine's rows without a kernel (plain PyTorch) against the
# kernels' rows on the card, from the same labels and draws
# ---------------------------------------------------------------------------

def _sampled_block(virt, count, seed):
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        qpd_sampling as tq,
    )

    uniq, counts = tq.sample_label_counts(virt, 4 * count, seed)
    lab, _ = tq._expand_measuring_counts(virt, uniq,
                                         counts.astype(np.float64))
    return lab[:count]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 15])
def test_collapse_rows_without_kernel_match_kernel_on_card(card, n):
    """``make_sim_fn(collapse=True)`` rows (the scan's route without a
    kernel) against the collapse kernel's full rows, on a block of the
    size the scan takes for that route, with the same draws: picked
    branches equal (a flip only within 1e-6 of its threshold, counted
    apart), the other rows within 1e-5; the route launches no kernel."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        collapse_kernel as ck,
        qpd_sampling as tq,
        variant_engine as ve,
    )

    virt, frag = _collapse_case(n)
    fn, _, ns, _ = tq._collapse_row_builder(virt, frag, device=card)
    kfn = tq._collapse_row_builder_pallas(virt, frag, device=card)[0]
    block = tq._label_block(virt, [True] * len(virt.fragments),
                            states=[fn.state] * len(virt.fragments))
    lab = torch.as_tensor(_sampled_block(virt, block, 5), device=card)
    u = torch.as_tensor(np.random.default_rng(n).random(
        (lab.shape[0], ns)).astype(np.float32), device=card)
    before = ck.collapse_rows.launches
    picks = []
    rows, _ = fn(lab, u, picks)
    assert ck.collapse_rows.launches == before
    krows, _ = kfn(lab, u)
    bits, margins = ve.picked_bits(picks)
    agree, near, far = ck.compare_picks(bits, kfn.rows_fn.last_bits,
                                        margins)
    assert far == 0, (near, far)
    err = (rows - krows).abs()[agree].max().item()
    assert err <= TOL, err


@pytest.mark.cuda
def test_ancilla_rows_without_kernel_match_kernel_on_card(card):
    """Deferred-measurement rows folded per label without a kernel
    against the variant kernel's full rows folded the same way, on a
    scan block of sup-12's labels (two 9-qubit fragments)."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        qpd_sampling as tq,
        variant_kernel as vk,
    )

    virt = VirtualCircuit(_port_cut("sup", 12, 7))
    for reg in virt.fragments:
        fn, _, _, _ = tq._ancilla_row_builder(virt, reg.name, device=card)
        kfn = tq._ancilla_row_builder_pallas(virt, reg.name, device=card)[0]
        block = tq._label_block(virt, [False] * len(virt.fragments),
                                states=[fn.state] * len(virt.fragments))
        lab = torch.as_tensor(_sampled_block(virt, block, 3), device=card)
        before = vk.variant_rows.launches
        rows, pos = fn(lab)
        assert vk.variant_rows.launches == before
        krows, kpos = kfn(lab, None)
        assert pos == kpos
        assert (rows - krows).abs().max().item() <= TOL


@pytest.mark.cuda
def test_noisy_sampled_rows_on_card_match_cpu(card):
    """The sampled engine's noisy rows (``fake_kolkata_v2``, 4
    trajectories, routed): the card's block against the CPU's from the
    same numpy draws, within 1e-5 (absolute and of the largest entry);
    ``run_noisy_virtual_circuit(engine="sampled")`` the same."""
    import dataclasses

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        noise,
        qpd_sampling as tq,
    )

    cut = _port_cut("sup", 12, 7)
    nm = dataclasses.replace(noise.fake_kolkata_v2(), trajectories=4)
    virt = VirtualCircuit(cut)
    lab_np = _sampled_block(virt, 64, 2)
    for fi, reg in enumerate(virt.fragments):
        rows = {}
        for dev in ("cpu", card):
            fn = tq._noisy_row_builder(virt, reg.name, nm, dev)[0]
            lab = torch.as_tensor(lab_np, device=dev)
            rows[dev] = fn.rows(lab, fn.prepare(len(lab_np), 7 + fi)).cpu()
        err = (rows[card] - rows["cpu"]).abs().max().item()
        assert err <= TOL and err <= TOL * rows["cpu"].abs().max().item()
    got = [noise.run_noisy_virtual_circuit(VirtualCircuit(cut), nm,
                                           shots=500, seed=3,
                                           engine="sampled", device=dev)[0]
           for dev in ("cpu", card)]
    np.testing.assert_allclose(got[1].values, got[0].values, atol=TOL)


@pytest.mark.cuda
def test_noisy_rows_kernel_matches_plain_on_card(card):
    """Kernel 1's noisy rows (``variant_kernel.make_noisy_chunk_kernel``)
    on one chunk of the ``sup20-kolkata-noisy`` cell's fragment 0: 15
    qubits, a two-CTA cluster, the chunk's 32 labels x 8 trajectories
    (256 rows) under the scan's draws, against the plain replay of the
    same plan on the card and against the per-gate plan without a kernel,
    within 1e-5 absolute; ``variant_rows.noisy`` counts the 256 rows."""
    from portbench.cell import Port, instances, load_cell
    from portbench.entries import noisy as entry

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        streamed,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.variant_engine import (  # noqa: E501
        _slot_tables,
        make_sim_fn,
    )

    cell = load_cell("sup20-kolkata-noisy")
    virt = Port().front_end(cell, instances(cell, 0)[0])
    nm = entry.model(cell)
    name = virt.fragments[0].name
    prog = virt.programs[name]
    specs = [vg.spec for vg in virt.vgates]
    sim_fn = make_sim_fn(virt, name, noise=nm, build_matrices=False)[0]
    c, t = 32, nm.trajectories
    vidx = _block(virt, c, 5).to(card)
    pidx = torch.as_tensor(streamed._sample_pauli_indices(
        np.random.default_rng(9),
        [(pr, bank) for (_, _, pr, bank, _) in sim_fn.noise_sites], c, t),
        dtype=torch.int64, device=card)
    fn = vk.make_noisy_chunk_kernel(sim_fn, prog, specs, card)
    assert fn.plan.plan.n == 15 and fn.plan.plan.fold is None
    before = vk.variant_rows.noisy
    got = fn(vidx, pidx)
    assert vk.variant_rows.noisy - before == c * t == 256
    assert vk.variant_rows.last_launch["cluster"] == 2
    idx = torch.cat([vidx.repeat_interleave(t, dim=0),
                     pidx.reshape(c * t, -1)], dim=1)
    dp = fn.plan
    replay = vk.plain_variant_rows(dp, dp.gather_entries(idx),
                                   torch.ones((c * t, 1, 2), device=card))
    assert (got - replay).abs().max().item() <= TOL
    tables = [[torch.as_tensor(x, device=card) for x in tabs]
              for tabs in _slot_tables(prog, specs, fused=False)]
    mats = [tuple(x[vidx[:, sl.vgate_idx]].repeat_interleave(t, dim=0)
                  for x in tabs) for sl, tabs in zip(prog.slots, tables)]
    flat = pidx.reshape(c * t, -1)
    pauli = {s: torch.as_tensor(sim_fn.site_banks[s], device=card)[
        flat[:, s]] for s in sim_fn.active_sites}
    plain = sim_fn(mats, card, pauli)
    assert (got - plain).abs().max().item() <= TOL


@pytest.mark.cuda
def test_streamed_pallas_staged_false_equals_staged_on_card(card):
    """``make_streamed_knit(pallas_staged=False)``: the variant kernel
    without its per-slot checkpoints gives the staged kernel's values."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
        make_streamed_knit,
    )

    virt = _chain()
    vals = {}
    for staged in (True, False):
        step, xs, meta = make_streamed_knit(virt, 24, pallas_variant=True,
                                            pallas_staged=staged,
                                            device=card)
        assert set(meta["fragment_kernels"].values()) == {"variant"}
        assert all(p.plan.staged == staged
                   for p in meta["fragment_plans"].values())
        vals[staged] = step(xs).cpu().numpy()
    np.testing.assert_allclose(vals[False], vals[True], atol=TOL)


def _tfim_energy(n, device, mesh=None, **kw):
    """A 2-partition cut TFIM-n VQE energy (ry layers as ParamRefs
    around a cx chain), built with the port alone."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
        ParamRef,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.hamiltonian import (  # noqa: E501
        make_hamiltonian_energy,
    )

    th = np.linspace(0.2, 1.7, 2 * n)
    c = Circuit(n, n)
    for q in range(n):
        c.ry(ParamRef(q, float(th[q])), q)
    for i in range(n - 1):
        c.cx(i, i + 1)
    for q in range(n):
        c.ry(ParamRef(n + q, float(th[n + q])), q)
    terms = []
    for i in range(n - 1):
        p = ["I"] * n
        p[i] = p[i + 1] = "Z"
        terms.append((-1.0, "".join(p)))
    for i in range(n):
        p = ["I"] * n
        p[i] = "X"
        terms.append((-0.7, "".join(p)))
    kw_cut = dict(maxNPartitions=2, maxNQubitsPerPartition=n // 2 + 1,
                  maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    energy, _ = make_hamiltonian_energy(c, kw_cut, terms, device=device,
                                        mesh=mesh, **kw)
    return energy, th


def _value_and_grad(energy, th, device):
    t = torch.tensor(th, dtype=torch.float32, device=device,
                     requires_grad=True)
    e = energy(t)
    e.backward()
    return float(e.detach()), t.grad.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [{"contract": True}, {"contract": False},
                                  {"num_samples": 3000, "sample_seed": 2}],
                         ids=["contract", "distribution", "sampled"])
def test_vqe_autograd_on_card_equals_cpu(card, mode):
    """Energy and gradient of the variational path (plain PyTorch and
    autograd, no kernel) on the card against the CPU: 1e-5 and 2e-5."""
    got = {}
    for dev in ("cpu", card):
        energy, th = _tfim_energy(8, dev, **mode)
        got[dev] = _value_and_grad(energy, th, dev)
    assert abs(got[card][0] - got["cpu"][0]) <= 1e-5
    np.testing.assert_allclose(got[card][1], got["cpu"][1], atol=2e-5)


@pytest.mark.cuda
def test_vqe_and_population_on_a_mesh_of_one_on_card(card):
    """``mesh=`` a mesh of one on the card: the energy, its gradient and
    a population's energies are the unsharded ones within 1e-6."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.optim import (  # noqa: E501
        population_energy,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.parallel.mesh import (  # noqa: E501
        make_mesh,
    )

    mesh = make_mesh(1, device=card)
    plain, th = _tfim_energy(8, card)
    meshed, _ = _tfim_energy(8, None, mesh=mesh)
    a, ga = _value_and_grad(plain, th, card)
    b, gb = _value_and_grad(meshed, th, card)
    assert abs(a - b) <= 1e-6
    np.testing.assert_allclose(ga, gb, atol=1e-6)
    thetas = torch.as_tensor(
        th + np.random.default_rng(0).normal(0, 0.2, (6, th.size)),
        dtype=torch.float32, device=card)
    want = population_energy(plain)(thetas)
    got = population_energy(plain, mesh)(thetas)
    loop = torch.stack([plain(t) for t in thetas])
    assert (got - want).abs().max().item() <= 1e-6
    assert (want - loop).abs().max().item() <= 1e-5
