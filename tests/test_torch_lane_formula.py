"""The whole-fragment kernel's lane formula (ops/sv_kernel.py), on the CPU.

The kernel reads no lane table: it derives a lane's variant digit for each
slot's vgate from the lane index and reads that slot's small table.
``lane_params`` mirrors the kernel's formula; it is held bit for bit to
``_slot_lane_params``, the JAX package's lane table (itself held to the
JAX package's in ``test_torch_sv_kernel.py``), on hwe-16, sup-20, a
13-qubit fragment under a gate cut and a wire cut, and a wire cut alone.
``run_fragment_kernel`` never calls ``_slot_lane_params``."""
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
    Circuit,
    Instruction,
    Register,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    sv_kernel as sv,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_gates import (  # noqa: E501
    VirtualGateOp,
)
from test_torch_op_rewrite import cut


def _wide13():
    """frag0: 13 data qubits under a gate cut (cz) and a wire cut (move)
    to a 2-qubit frag1, every second qubit measured."""
    n = 13
    c = Circuit([Register("frag0", n), Register("frag1", 2)], n + 2)
    c.h(0)
    for q in range(n - 1):
        c.cx(q, q + 1)
    for q in range(n):
        c.ry(0.2 * (q + 1), q)
    c.append(Instruction("vgate", [n - 1, n], op=VirtualGateOp("cz")))
    c.rx(0.7, n - 1)
    c.cp(0.9, n - 1, 0)
    c.append(Instruction("vgate", [1, n + 1], op=VirtualGateOp("move")))
    c.cx(n, n + 1)
    for k, q in enumerate(list(range(0, n, 2)) + [n, n + 1]):
        c.measure(q, k)
    return VirtualCircuit(c)


def _wire_cut():
    c = Circuit([Register("frag0", 3), Register("frag1", 2)], 4)
    c.h(0)
    c.cx(0, 1)
    c.ry(0.5, 2)
    c.append(Instruction("vgate", [2, 3], op=VirtualGateOp("move")))
    c.cx(3, 4)
    for k, q in enumerate([0, 1, 3, 4]):
        c.measure(q, k)
    return VirtualCircuit(c)


CASES = {
    "hwe16": lambda: cut("hwe", 16, 10, 5),
    "sup20": lambda: cut("sup", 20, 10, 1),
    "wide13": _wide13,
    "wire_cut": _wire_cut,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_formula_equals_the_lane_table(case):
    virt = CASES[case]()
    for reg in virt.fragments:
        plan = sv.build_plan(virt, reg.name)
        want, v_count, total = sv._slot_lane_params(
            virt, virt.programs[reg.name], plan.meas_vgates, plan.slots)
        assert (plan.v_count, plan.total) == (v_count, total)
        got = sv.lane_params(plan)
        if want.shape[1] == 0:
            want = np.zeros((total, 1), np.float32)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got, want)
        # a slot's table holds 2 rows per digit of its vgate
        assert len(plan.slot_tab) == 2 * int(plan.slot_meta[:, 1].sum())
        pick = np.random.default_rng(1).integers(0, total, 17)
        assert np.array_equal(sv.lane_params(plan, pick), want[pick])


def test_the_route_builds_no_lane_table(monkeypatch):
    virt = _wide13()
    want = [sv.run_fragment_kernel(virt, r.name, device="cpu")
            for r in virt.fragments]

    def refuse(*args, **kw):
        raise AssertionError("the route built a lane table")

    monkeypatch.setattr(sv, "_slot_lane_params", refuse)
    for r, w in zip(virt.fragments, want):
        got = sv.run_fragment_kernel(virt, r.name, device="cpu")
        assert torch.equal(got.values, w.values)
    with pytest.raises(AssertionError, match="lane table"):
        sv.build_fragment_kernel(virt, "frag0", device="cpu")
