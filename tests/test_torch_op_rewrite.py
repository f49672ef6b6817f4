"""The host rewrite of the kernels' op tables (ops/op_rewrite.py) and the
recounted work of every kernel, on the CPU.

A rewritten table (identities dropped, diagonal runs merged, signed
permutations as moves, collapse sites fused with their slot gates) is
replayed in plain PyTorch and held to the replay of the table it came
from within 1e-6: on seeded random chains, on qft-16's two collapse
fragments, and on the whole-fragment kernel's hwe-16 and sup-20
fragments.  The work counts are held to hand-computed small cases."""
import math

import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
    Circuit,
    Instruction,
    Register,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
    Cutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.qft import (  # noqa: E501
    library_qft,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
    genCirc,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    collapse_kernel as ck,
    op_rewrite as rw,
    qpd_sampling as tq,
    sv_kernel as sv,
    variant_kernel as vk,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    apply_matrix_host,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.plans import (  # noqa: E501
    load_plan,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_gates import (  # noqa: E501
    VirtualGateOp,
)
import torch_threads  # noqa: F401 (torch's threads: a share of the cores)

TOL = 1e-6


def qft16():
    """qft-16 of the sampled engine's flagship (an h and a seeded rz on
    every qubit, ``library_qft(16)``, all measured), cut 15|1 by the
    stored gamma-mode plan."""
    rng = np.random.default_rng(5)
    circ = Circuit(16, 16)
    for q in range(16):
        circ.h(q)
        circ.rz(float(rng.uniform(0, 2 * math.pi)), q)
    for ins in library_qft(16).instructions:
        circ.instructions.append(ins.copy())
    for q in range(16):
        circ.measure(q, q)
    cutter = Cutter(circ, maxNPartitions=2, maxNQubitsPerPartition=15,
                    gammaMode=True)
    cutter.use_plan(load_plan("qft16_prepped_p2_q15_gamma"))
    return VirtualCircuit(cutter.getResultCircs()[3])


def cut(name, n, cap, depth):
    cutter = Cutter(genCirc(name, n, depth, seed=0), maxNPartitions=2,
                    maxNQubitsPerPartition=cap, maxNQpdCuts=5, maxNCuts=5,
                    maxCutsPerPartitions=5)
    assert cutter.solve()
    return VirtualCircuit(cutter.getResultCircs()[3])


@pytest.fixture(scope="module")
def qft16_virt():
    return qft16()


# ---------------------------------------------------------------------------
# Random chains of every gate kind
# ---------------------------------------------------------------------------

def _random_gate(rng, kind, d):
    if kind == "identity":
        return np.eye(d, dtype=complex)
    if kind == "diagonal":
        return np.diag(np.exp(1j * rng.uniform(0, 2 * np.pi, d)))
    if kind == "permutation":
        mat = np.eye(d, dtype=complex)[rng.permutation(d)]
        return mat * np.asarray([1, 1j, -1, -1j])[rng.integers(0, 4, d)]
    q, _ = np.linalg.qr(rng.normal(size=(d, d))
                        + 1j * rng.normal(size=(d, d)))
    return q


@pytest.mark.parametrize("seed", range(6))
def test_rewritten_random_chain_replays_the_original(seed):
    rng = np.random.default_rng(seed)
    n = 5
    ops, kinds = [], []
    for _ in range(40):
        kind = rng.choice(["identity", "diagonal", "permutation", "dense"],
                          p=[0.2, 0.35, 0.25, 0.2])
        nq = int(rng.integers(1, 3))
        js = [int(j) for j in rng.choice(n, nq, replace=False)]
        ops.append(("u", _random_gate(rng, kind, 1 << nq), js))
        kinds.append(kind)
    table = rw.rewrite(ops)
    assert len(table.rows) < len(ops) - kinds.count("identity") + 1
    assert rw.OP_DIAG in table.kinds and set(table.kinds) <= {
        rw.OP_GATE1, rw.OP_GATE2, rw.OP_DIAG, rw.OP_PERM1, rw.OP_PERM2}
    st0 = rng.normal(size=(3, 2, 1 << n))
    st0 = (st0 / np.sqrt((st0 ** 2).sum(axis=(1, 2), keepdims=True))
           ).astype(np.float32)   # unit states, as the kernels hold
    want = st0.copy()
    for _, mat, js in ops:
        want = np.stack([apply_matrix_host(w, mat, tuple(n - 1 - j
                                                         for j in js), n)
                         for w in want])
    got = rw.replay(torch.as_tensor(st0), table, n)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_classify_and_permutation_codes():
    cx = np.eye(4)[[0, 1, 3, 2]]
    y = np.array([[0, -1j], [1j, 0]])
    assert rw.classify(np.eye(2)) == "identity"
    assert rw.classify(np.diag([1, 1, 1, np.exp(0.3j)])) == "diagonal"
    assert rw.classify(cx) == "permutation" == rw.classify(y)
    assert rw.classify(np.array([[6e-17, -1], [1, 6e-17]])) == "permutation"
    assert rw.classify(np.array([[1, 1], [1, -1]]) / np.sqrt(2)) == "dense"
    for mat in (cx, y, np.eye(4)[[3, 0, 2, 1]] * 1j):
        d = len(mat)
        np.testing.assert_array_equal(rw.perm_matrix(rw.perm_code(mat), d),
                                      mat)


# ---------------------------------------------------------------------------
# The kernels' own tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frag", ["frag0", "frag1"])
def test_collapse_table_replays_the_original_on_qft16(qft16_virt, frag):
    """The collapse kernel's rewritten table against the plain version
    (the original table) on 96 sampled label rows with their draws; the
    15-qubit fragment's 137 rows become 56."""
    virt = qft16_virt
    fn, _, ns, _ = tq._collapse_row_builder_pallas(
        virt, frag, keep_clbits=[0, 1, 2, 3], device="cpu")
    dp = fn.rows_fn.plan
    if dp.plan.n == 15:
        assert (len(dp.plan.ops), len(dp.plan.table.rows)) == (137, 56)
    uniq, counts = tq.sample_label_counts(virt, 3000, 17, method="lhs")
    lab, _ = tq._expand_measuring_counts(virt, uniq,
                                         counts.astype(np.float64))
    lab = torch.as_tensor(lab[-96:], dtype=torch.int64)
    u = torch.as_tensor(np.random.default_rng(1).random(
        (len(lab), max(1, ns))).astype(np.float32))
    ent, cscal = dp.gather_entries(lab), fn.scalars(lab, u)
    want, wbits = ck.plain_collapse_rows(dp, ent, cscal)
    got, bits = ck.replay_kernel_table(dp, ent, cscal)
    assert torch.equal(bits, wbits) and (bits >= 0).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)


@pytest.mark.parametrize("name", ["hwe16", "sup20"])
def test_sv_table_replays_the_original(name):
    """The whole-fragment kernel's prefix and rewritten table against the
    plain version's original table from |0..0>, on 64 lanes."""
    virt = (cut("hwe", 16, 10, 5) if name == "hwe16"
            else cut("sup", 20, 10, 1))
    for reg in virt.fragments:
        plan = sv.build_plan(virt, reg.name)
        assert len(plan.table.rows) < len(plan.ops) - len(plan.prefix_ops)
        dp = sv.SvDevicePlan(plan, "cpu")
        lanes = np.random.default_rng(3).integers(0, plan.total, 64)
        want = sv.plain_sv_rows(dp, torch.as_tensor(
            sv.lane_params(plan, lanes)))
        got = sv.replay_kernel_table(dp, lanes)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)


def _chain_cut(nbig: int = 8):
    """The JAX kernel tests' two-fragment chain (fixed 1q/2q gates, a
    measuring cz and a parametrised cp slot), built in the port."""
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


VARIANT_CASES = {
    # (circuit, fragments, fold keywords: None = full rows)
    "chain_cut": lambda: (_chain_cut(), ["frag0", "frag1"], {}),
    "chain_cut_full_rows": lambda: (_chain_cut(), ["frag0"], None),
    "chain_cut_z": lambda: (_chain_cut(), ["frag0"],
                            {"z_clbits": [0, 3, 7]}),
    "sup20": lambda: (cut("sup", 20, 10, 1), None, {}),
}


@pytest.mark.parametrize("case", sorted(VARIANT_CASES))
def test_variant_table_replays_the_original(case):
    """The variant kernel's rewritten table against the plain version's
    original table, whole and segment by segment (the rewrite cuts its
    segments at the same slots), on 8 labels of the label grid; sup-20's
    15-qubit fragments, 38 / 39 rows, become 35 each."""
    virt, names, kw = VARIANT_CASES[case]()
    names = names or [r.name for r in virt.fragments]
    specs = [vg.spec for vg in virt.vgates]
    rng = np.random.default_rng(4)
    blk = torch.as_tensor(np.stack(
        [rng.integers(0, s.num_instantiations, 8) for s in specs], axis=1))
    for name in names:
        if kw is None:
            fn, _ = vk.make_chunk_kernel(virt, name, 8, device="cpu")
        else:
            fn, _ = vk.make_folded_chunk_kernel(virt, name, 8, device="cpu",
                                                **kw)
        plan = fn.plan.plan
        assert len(plan.row_segments) == len(plan.segments) >= 1
        if case == "sup20":
            assert len(plan.table.rows) == 35 < len(plan.ops)
        ent = fn.plan.gather_entries(blk)
        st = fn.plan.prefix.expand(8, 2, 1 << plan.n)
        want, got = st, st
        for (a, b), (ka, kb) in zip(plan.segments, plan.row_segments):
            for row in plan.ops[a:b]:
                want = rw.apply_row(want, row, plan.n, plan.fixed, ent)
            seg = rw.Table(plan.table.rows[ka:kb], plan.table.pool)
            got = rw.replay(got, seg, plan.n, entries=ent)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)


# ---------------------------------------------------------------------------
# Recounted work
# ---------------------------------------------------------------------------

def _table(gates, n):
    """An OpTable-format op list of fixed gates on flat bits."""
    ops, fixed = [], []
    for mat, js in gates:
        mat = np.asarray(mat, complex)
        ops.append((len(js), js[0], js[1] if len(js) == 2 else 0,
                    len(fixed)))
        fixed.extend(mat.real.astype(np.float32).ravel())
        fixed.extend(mat.imag.astype(np.float32).ravel())
    return np.asarray(ops, np.int32), np.asarray(fixed, np.float32)


def test_an_identity_chain_costs_nothing_and_a_cp_its_one_entry():
    n = 6
    ops, fixed = _table([(np.eye(2), [j]) for j in range(n)]
                        + [(np.eye(4), [0, 3])], n)
    assert rw.op_costs(ops, fixed, n).sum() == 0
    assert rw.rewrite([("u", np.eye(2), [j]) for j in range(n)]).rows.size == 0
    cp = np.diag([1, 1, 1, np.exp(0.7j)])
    ops, fixed = _table([(cp, [1, 4])], n)
    # one complex entry (6 operations) on each of the 2^n / 4 quads
    assert rw.op_costs(ops, fixed, n).tolist() == [[6 * (1 << n) // 4]]
    table = rw.rewrite([("u", cp, [1, 4]), ("u", cp, [2, 5])])
    assert table.kinds == [rw.OP_DIAG] and table.rows[0, 1] == 2


def _one_site_chain():
    """frag0: 3 data qubits, a cz gate cut on qubit 0 then a dense 1q
    rotation after it; frag1 one qubit."""
    cut_c = Circuit([Register("frag0", 3), Register("frag1", 1)], 4)
    for q in range(3):
        cut_c.h(q)
    cut_c.cx(0, 1)
    cut_c.append(Instruction("vgate", [0, 3], op=VirtualGateOp("cz")))
    cut_c.ry(0.4, 2)
    cut_c.rx(0.3, 0)
    for q in range(4):
        cut_c.measure(q, q)
    return VirtualCircuit(cut_c)


@pytest.mark.parametrize("reps", [1, 5])
def test_a_replica_run_counts_its_shared_prefix_once(reps):
    virt = _one_site_chain()
    plan = ck.build_plan(virt, "frag0", keep_clbits=[0, 1, 2])
    assert len(plan.site_meta) == 1
    big = 1 << plan.n
    dp = ck.CollapseDevicePlan(plan, "cpu")
    lab = torch.zeros((reps, len(virt.vgates)), dtype=torch.int64)
    ent = dp.gather_entries(lab)
    cscal = torch.ones((reps, 1, 4))
    cscal[:, 0, 0] = torch.linspace(0.1, 0.9, reps)
    work = ck.work_counts(plan, ent, cscal)
    assert work["runs"] == 1
    cost = rw.op_costs(plan.ops, plan.fixed, plan.n, ent.numpy())[0]
    at = plan.ops[:, 0].tolist().index(0)          # the collapse site
    shared = int(cost[:at].sum()) + 5 * big         # and its Born sums
    per_row = int(cost[at + 1:].sum()) + 2 * big + (3 + 1) * big
    assert work["flops"] == shared + reps * per_row
    # a run that measures nowhere: every op and its epilogue once
    cscal[:, 0, 1] = 0.0
    none = ck.work_counts(plan, ent, cscal)
    assert none["flops"] == int(cost.sum()) + 4 * big
    assert none["passes"] < work["passes"] or reps == 1
