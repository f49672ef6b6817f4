"""The port's whole-fragment kernel module (ops/sv_kernel.py) on the CPU
against the JAX package's ``ops/pallas_sv.py`` in interpret mode.

The same cut circuit, built with the JAX package and carried across with
``convert``, goes through ``run_fragment_pallas(..., interpret=True)`` and
through ``run_fragment_kernel(device="cpu")`` (the kernel's plain PyTorch
version): ``values`` within 2e-6 (f32, the same gate order, sums in
another order), the same ``bit_positions`` and ``touching``.  The lane
table ``_slot_lane_params`` is held to the JAX package's bit for bit: a
wrong index there goes unnoticed until the knit.  The four cases of
``tests/test_pallas_engine.py`` run through the port against its batched
engine (2e-5, that file's tolerance)."""
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
    Instruction as JInstruction,
    Register as JRegister,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (
    pallas_sv as jsv,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_gates import (  # noqa: E501
    VirtualGateOp as JVirtualGateOp,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    hellinger_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    op_rewrite,
    sv_kernel as sv,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.knit import (  # noqa: E501
    knit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    simulate_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.variant_engine import (  # noqa: E501
    run_fragment,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from torch_port_common import cut_pair, to_port

TOL_JAX = 2e-6      # plain version vs the JAX kernel in interpret mode
TOL_ENGINE = 2e-5   # kernel module vs the batched engine


def _vgate(name, qubits, params=()):
    return JInstruction("vgate", list(qubits), params=list(params),
                        op=JVirtualGateOp(name, tuple(params)))


def _gate_cut_cz():
    cut = JCircuit([JRegister("frag0", 2), JRegister("frag1", 2)], 4)
    cut.h(0)
    cut.cx(0, 1)
    cut.ry(0.3, 2)
    cut.append(_vgate("cz", [1, 2]))
    cut.rx(0.7, 1)
    cut.cx(2, 3)
    for i, q in enumerate([0, 1, 2, 3]):
        cut.measure(q, i)
    return cut


def _wire_cut_move():
    cut = JCircuit([JRegister("frag0", 2), JRegister("frag1", 2)], 3)
    cut.h(0)
    cut.cx(0, 1)
    cut.append(_vgate("move", [1, 2]))
    cut.cx(2, 3)
    cut.measure(0, 0)
    cut.measure(2, 1)
    cut.measure(3, 2)
    return cut


def _mixed_cuts():
    """(original, cut) of the mixed gate-cut circuit, cut by the JAX
    package's solver."""
    orig = JCircuit(4, 4)
    orig.h(0)
    orig.ry(0.4, 1)
    orig.h(2)
    orig.rz(0.2, 3)
    orig.cz(0, 1)
    orig.cp(1.1, 1, 2)
    orig.cx(2, 3)
    for q in range(4):
        orig.measure(q, q)
    cutter = JCutter(orig, 2, 3, maxNQpdCuts=5, maxNCuts=5,
                     maxCutsPerPartitions=5)
    assert cutter.solve()
    return orig, cutter.getResultCircs()[3]


def _no_slot():
    """A fragment no vgate touches beside one that a cut does."""
    cut = JCircuit([JRegister("frag0", 2), JRegister("frag1", 1),
                    JRegister("frag2", 2)], 5)
    cut.h(0)
    cut.cx(0, 1)
    cut.ry(0.8, 2)
    cut.append(_vgate("cz", [1, 3]))
    cut.cx(3, 4)
    for q in range(5):
        cut.measure(q, q)
    return cut


def _k0():
    """frag0 measures no data qubit (k = 0): its rows are the branch
    code's alone; one of its qubits is never measured and is summed
    away."""
    cut = JCircuit([JRegister("frag0", 2), JRegister("frag1", 2)], 2)
    cut.h(0)
    cut.cx(0, 1)
    cut.rx(0.4, 0)
    cut.append(_vgate("cz", [1, 2]))
    cut.h(2)
    cut.cx(2, 3)
    cut.measure(2, 0)
    cut.measure(3, 1)
    return cut


def _reversed_2q():
    """2q gates whose first qubit is the higher one (``qa > qb``), a
    non-symmetric matrix among them, clbits in another order than the
    qubits, and an unmeasured qubit in the middle."""
    cut = JCircuit([JRegister("frag0", 4), JRegister("frag1", 2)], 5)
    cut.h(0)
    cut.ry(0.6, 3)
    cut.cx(3, 1)
    cut.cp(0.9, 2, 0)
    cut.cx(1, 0)
    cut.rx(0.3, 2)
    cut.append(_vgate("cx", [2, 4]))
    cut.cx(3, 2)
    cut.cx(5, 4)
    cut.measure(3, 0)
    cut.measure(0, 1)
    cut.measure(2, 2)
    cut.measure(5, 3)
    cut.measure(4, 4)
    return cut


def _wide(n):
    """One fragment of ``n`` data qubits with a gate cut to a second."""
    cut = JCircuit([JRegister("frag0", n), JRegister("frag1", 1)], 2)
    cut.h(0)
    for q in range(n - 1):
        cut.cx(q, q + 1)
    cut.append(_vgate("cz", [n - 1, n]))
    cut.measure(0, 0)
    cut.measure(n, 1)
    return cut


CIRCUITS = {
    "gate_cut_cz": _gate_cut_cz,
    "wire_cut_move": _wire_cut_move,
    "mixed_cuts": lambda: _mixed_cuts()[1],
    "no_slot": _no_slot,
    "k0": _k0,
    "reversed_2q": _reversed_2q,
    "hwe10_d2_p2q6": lambda: cut_pair(
        "hwe", 10, 2, 6, seed=0, maxNQpdCuts=2, maxNCuts=2,
        maxCutsPerPartitions=2)[2]._circuit,
}
_PAIRS: dict = {}


def _pair(name):
    """(jax_virt, port_virt) of one test circuit, built once."""
    if name not in _PAIRS:
        cut = CIRCUITS[name]()
        _PAIRS[name] = (JVirtualCircuit(cut), TVirtualCircuit(to_port(cut)))
    return _PAIRS[name]


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_slot_lane_params_equal_the_jax_table(name):
    jv, tv = _pair(name)
    for reg in jv.fragments:
        jplan = jsv._plan(jv, reg.name)
        tplan = sv.build_plan(tv, reg.name)
        assert jplan is not None and tplan is not None
        jslots = [e[1] for e in jplan[3] if e[0] == "slot"]
        want, v_count, total = jsv._slot_lane_params(
            jv, jplan[0], jplan[2], jslots, 1
        )
        got, t_v_count, t_total = sv._slot_lane_params(
            tv, tv.programs[reg.name], tplan.meas_vgates, tplan.slots
        )
        assert (t_v_count, t_total) == (v_count, total)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_rows_match_the_jax_kernel(name):
    jv, tv = _pair(name)
    for reg in jv.fragments:
        want = jsv.run_fragment_pallas(jv, reg.name, interpret=True)
        got = sv.run_fragment_kernel(tv, reg.name, device="cpu")
        assert want is not None and got is not None
        assert got.bit_positions == want.bit_positions
        assert got.touching == want.touching
        assert got.values.dtype == torch.float32
        np.testing.assert_allclose(got.values.numpy(), want.values,
                                   atol=TOL_JAX, err_msg=reg.name)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_rows_match_the_batched_engine(name):
    """``tests/test_pallas_engine.py``'s comparison, inside the port."""
    _, tv = _pair(name)
    for reg in tv.fragments:
        got = sv.run_fragment_kernel(tv, reg.name, device="cpu")
        want = run_fragment(tv, reg.name, device="cpu")
        assert got.touching == want.touching
        assert got.bit_positions == want.bit_positions
        np.testing.assert_allclose(got.values.numpy(), want.values.numpy(),
                                   atol=TOL_ENGINE, err_msg=reg.name)


def test_mixed_cuts_full_knit_fidelity():
    orig, cut = _mixed_cuts()
    tv = TVirtualCircuit(to_port(cut))
    results = [sv.run_fragment_kernel(tv, reg.name, device="cpu")
               for reg in tv.fragments]
    assert all(r is not None for r in results)
    knitted = knit(tv, results)
    ideal = simulate_circuit(to_port(orig), device="cpu")
    assert hellinger_fidelity(ideal, knitted) > 1 - 1e-5


def test_hwe10_lane_count_and_knit():
    """The generated case: two cx cuts, 144 lanes a fragment."""
    circ, tcirc, _, tv = cut_pair("hwe", 10, 2, 6, seed=0, maxNQpdCuts=2,
                                  maxNCuts=2, maxCutsPerPartitions=2)
    results = []
    for reg in tv.fragments:
        fn, params, meta = sv.build_fragment_kernel(tv, reg.name,
                                                    device="cpu")
        assert meta["total"] == params.shape[0] == 144
        assert params.shape[1] == sv.SLOT_PARAMS * len(fn.plan.plan.slots)
        results.append(sv.run_fragment_kernel(tv, reg.name, device="cpu"))
    ideal = simulate_circuit(tcirc, device="cpu")
    assert hellinger_fidelity(ideal, knit(tv, results)) > 1 - 1e-5


def _refused_reset():
    cut = JCircuit([JRegister("frag0", 2)], 2)
    cut.h(0)
    cut.reset(0)
    cut.measure(0, 0)
    cut.measure(1, 1)
    return cut


def _refused_condition():
    cut = JCircuit([JRegister("frag0", 2)], 2)
    cut.h(0)
    cut.measure(0, 0)
    cut.append(JInstruction("x", [1], condition=(0, 1)))
    cut.measure(1, 1)
    return cut


def _refused_mid_measure():
    cut = JCircuit([JRegister("frag0", 2)], 3)
    cut.h(0)
    cut.measure(0, 0)
    cut.cx(0, 1)
    cut.measure(0, 1)
    cut.measure(1, 2)
    return cut


def _refused_three_qubit_gate():
    cut = JCircuit([JRegister("frag0", 3)], 3)
    cut.h(0)
    cut.append(JInstruction("ccx", [0, 1, 2]))
    for q in range(3):
        cut.measure(q, q)
    return cut


REFUSED = {
    "reset": _refused_reset,
    "condition": _refused_condition,
    "mid_circuit_measure": _refused_mid_measure,
    "three_qubit_gate": _refused_three_qubit_gate,
    "width_14": lambda: _wide(14),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_none_where_the_jax_kernel_returns_none(name):
    cut = REFUSED[name]()
    jv, tv = JVirtualCircuit(cut), TVirtualCircuit(to_port(cut))
    assert jsv._plan(jv, "frag0") is None
    assert sv.build_plan(tv, "frag0") is None
    assert sv.build_fragment_kernel(tv, "frag0", device="cpu") is None
    assert sv.run_fragment_kernel(tv, "frag0", device="cpu") is None


def test_width_13_is_inside_the_gate():
    cut = _wide(13)
    tv = TVirtualCircuit(to_port(cut))
    plan = sv.build_plan(tv, "frag0")
    assert plan is not None and plan.n == 13 == sv.MAX_KERNEL_QUBITS
    assert plan.k == 1 and plan.positions == [0, 2]


def test_plan_layout_and_work_counts():
    """Flat bit i < k carries the qubit read by the i-th data clbit; the
    dropped qubits follow; the gates before the first slot are the host's
    prefix; the work counts follow the op table and the lanes' own slot
    coefficients."""
    _, tv = _pair("reversed_2q")
    plan = sv.build_plan(tv, "frag0")
    assert (plan.n, plan.k) == (4, 3)
    assert plan.data_positions == [0, 1, 2]
    assert [plan.terminal_sources[c] for c in plan.data_positions] == [3, 0, 2]
    kinds = plan.ops[:, 0].tolist()
    assert kinds.count(3) == len(plan.slots) == 1
    slot_row = plan.ops[kinds.index(3)]
    assert slot_row[1] == 2 and slot_row[3] == 0   # qubit 2 is clbit 2: bit 2
    at = kinds.index(3)
    assert plan.prefix_ops == at
    assert plan.table.kinds[0] == op_rewrite.OP_SLOT   # the rest after it
    lanes = 6 << len(plan.meas_vgates)
    assert plan.total == lanes
    work = sv.work_counts(plan)
    assert work["bytes"] == 4 * (plan.table.rows.size + plan.table.pool.size
                                 + plan.prefix.size + plan.slot_tab.size
                                 + plan.slot_meta.size + lanes * 8)
    assert work["pass_bytes"] == lanes * (16 * len(plan.table.rows)
                                          + 24) * 16

    # the fixed gates before the slot count once, the later ones per lane,
    # each by what its matrix needs; the slot by each lane's pre and post
    def cost(row):
        d = 1 << int(row[0])
        mat = plan.fixed[row[3]:row[3] + 2 * d * d].reshape(2, d, d)
        return int(sv._matvec_ops(mat[0], mat[1])) * (16 // d)

    shared = sum(cost(r) for r in plan.ops[:at])
    per_lane = sum(cost(r) for r in plan.ops[at + 1:])
    assert shared > 0 and per_lane == 0   # the later cx permutes
    epilogue = 3 * 16 + (16 - 8)
    _, params, _ = sv.build_fragment_kernel(tv, "frag0", device="cpu")
    assert params.shape == (lanes, 18)
    pre = params[:, 0:8].reshape(lanes, 2, 2, 2)
    post = params[:, 10:18].reshape(lanes, 2, 2, 2)
    slot = int((sv._matvec_ops(pre[..., 0], pre[..., 1])
                + sv._matvec_ops(post[..., 0], post[..., 1])).sum()) * 8
    assert work["flops"] == shared + slot + lanes * (per_lane + epilogue)
    # a subset of lanes counts its own
    some = sv.work_counts(plan, np.arange(3))
    assert some["flops"] < work["flops"] and some["bytes"] < work["bytes"]

    # h and cx before the slot (12 a pair of amplitudes, and nothing), an
    # rx after it (12 a pair), 2 qubits, all 4 amplitudes kept
    plan = sv.build_plan(_pair("gate_cut_cz")[1], "frag0")
    assert plan.ops[:, 0].tolist() == [1, 2, 3, 1] and plan.n == plan.k == 2
    assert plan.prefix_ops == 2
    assert plan.table.kinds == [op_rewrite.OP_SLOT, op_rewrite.OP_GATE1]
    par = sv.lane_params(plan)
    pre, post = (par[:, a:a + 8].reshape(-1, 2, 2, 2) for a in (0, 10))
    slot = int((sv._matvec_ops(pre[..., 0], pre[..., 1])
                + sv._matvec_ops(post[..., 0], post[..., 1])).sum()) * 2
    assert sv.work_counts(plan)["flops"] == 24 + slot + plan.total * (24 + 12)


MATVEC_OPS = {
    # per group of d amplitudes: 6 a complex entry, 2 a real or imaginary
    # one, 0 a unit one, 2 per further term of a row
    "identity": (np.eye(2), 0),
    "x": (np.array([[0, 1], [1, 0]]), 0),
    "s": (np.diag([1, 1j]), 0),
    "cx": (np.eye(4)[[0, 1, 3, 2]], 0),
    "cz": (np.diag([1, 1, 1, -1]), 0),
    "ry_pi_rounded": (np.array([[6e-17, -1], [1, 6e-17]]), 0),
    "t": (np.diag([1, np.exp(0.25j * np.pi)]), 6),
    "h": (np.array([[1, 1], [1, -1]]) / np.sqrt(2), 12),
    "rx": (np.array([[0.8, -0.6j], [-0.6j, 0.8]]), 12),
    "dense_1q": (np.array([[0.6 + 0.1j, 0.2 - 0.3j],
                           [0.5j + 0.1, 0.3 + 0.2j]]), 28),
    "dense_2q": (np.full((4, 4), 0.25 + 0.25j), 120),
}


@pytest.mark.parametrize("name", sorted(MATVEC_OPS))
def test_matvec_ops_counts_what_the_matrix_needs(name):
    mat, want = MATVEC_OPS[name]
    mat = np.asarray(mat, complex)
    re, im = mat.real.astype(np.float32), mat.imag.astype(np.float32)
    assert int(sv._matvec_ops(re, im)) == want
    # over a leading axis, as the lane table's slot blocks come
    both = sv._matvec_ops(np.stack([re, re * 0]), np.stack([im, im * 0]))
    assert both.tolist() == [want, 0]


def test_run_fragment_kernel_adds_its_stage_times():
    _, tv = _pair("gate_cut_cz")
    stage = {}
    first = sv.run_fragment_kernel(tv, "frag0", device="cpu", timings=stage)
    assert set(stage) == {"plan_s", "upload_and_kernel_s"}
    once = dict(stage)
    again = sv.run_fragment_kernel(tv, "frag1", device="cpu", timings=stage)
    assert all(stage[k] > once[k] > 0 for k in once)
    plain = sv.run_fragment_kernel(tv, "frag0", device="cpu")
    assert torch.equal(plain.values, first.values) and again is not None


def test_wrapper_counts_no_launch_on_the_cpu_and_refuses_other_devices():
    _, tv = _pair("gate_cut_cz")
    fn, params, _ = sv.build_fragment_kernel(tv, "frag0", device="cpu")
    before = sv.sv_rows.launches
    rows = sv.sv_rows(fn.plan)
    assert sv.sv_rows.launches == before
    assert torch.equal(rows, sv.plain_sv_rows(fn.plan,
                                              torch.as_tensor(params)))
    pick = torch.tensor([5, 0, 5], dtype=torch.int64)
    assert torch.equal(sv.sv_rows(fn.plan, pick), rows[pick])
    assert torch.equal(fn(pick), rows[pick])
    with pytest.raises(ValueError, match="dtype"):
        sv.sv_rows(fn.plan, pick.float())
    with pytest.raises(ValueError, match="outside"):
        sv.sv_rows(fn.plan, pick + fn.plan.plan.total)
    with pytest.raises(ValueError, match="unsupported device"):
        sv.sv_rows(sv.SvDevicePlan(fn.plan.plan, "meta"))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tv = _pair("gate_cut_cz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sv.run_fragment_kernel(tv, "frag0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sv.build_fragment_kernel(tv, "frag0")
