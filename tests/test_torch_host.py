"""The torch port's host layers against the JAX package's: the same
generator and cutter give the same plan, fragments, fused streams, slot
tables, label tables and fold weights; circuits round-trip through
``convert``."""
import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.solver import (  # noqa: E501
    plan_signature as j_plan_signature,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
    fusion as j_fusion,
    knit as j_knit,
    variant_engine as j_ve,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_from_instructions,
    circuit_to_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
    Cutter as TCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.solver import (  # noqa: E501
    plan_signature as t_plan_signature,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
    genCirc as t_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    fusion as t_fusion,
    knit as t_knit,
    variant_engine as t_ve,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from torch_port_common import to_port

CASES = {
    # name: (genCirc args, Cutter kwargs)
    "sup20_seed0": (("sup", 20, 1, 0), dict(
        maxNPartitions=2, maxNQubitsPerPartition=10, maxNQpdCuts=5,
        maxNCuts=5, maxCutsPerPartitions=5)),
    "sup12_seed5": (("sup", 12, 1, 5), dict(
        maxNPartitions=2, maxNQubitsPerPartition=10, maxNQpdCuts=5,
        maxNCuts=5, maxCutsPerPartitions=5)),
    "ghz10": (("ghz", 10, 1, None), dict(
        maxNPartitions=2, maxNQubitsPerPartition=5, maxNQpdCuts=2,
        maxNCuts=2)),
}


def _both(case):
    (name, n, depth, seed), kw = CASES[case]
    out = []
    for gen, cutter_cls, virt_cls in ((j_gen_circ, JCutter, JVirtualCircuit),
                                      (t_gen_circ, TCutter, TVirtualCircuit)):
        circ = gen(name, n, depth, seed=seed)
        cutter = cutter_cls(circ, **kw)
        assert cutter.solve()
        out.append((circ, cutter, virt_cls(cutter.getResultCircs()[3])))
    return out


def _same(a, b):
    """Structural equality over tuples/lists/dicts/arrays/scalars."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    return a == b


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_circuit_and_plan(case):
    (jc, jcut, _), (tc, tcut, _) = _both(case)
    assert _same(circuit_to_instructions(jc), circuit_to_instructions(tc))
    assert j_plan_signature(jcut.plan) == t_plan_signature(tcut.plan)


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_fragment_programs(case):
    (_, _, jv), (_, _, tv) = _both(case)
    assert [r.name for r in jv.fragments] == [r.name for r in tv.fragments]
    assert [(vg.base_name, vg.params) for vg in jv.vgates] == \
        [(vg.base_name, vg.params) for vg in tv.vgates]
    for reg in jv.fragments:
        jp, tp = jv.programs[reg.name], tv.programs[reg.name]
        assert (jp.num_data_qubits, jp.num_sim_qubits) == \
            (tp.num_data_qubits, tp.num_sim_qubits)
        assert jp.touching == tp.touching
        assert jp.clbit_sources == tp.clbit_sources
        assert [(s.vgate_idx, s.side, s.qubit, s.ancilla) for s in jp.slots] \
            == [(s.vgate_idx, s.side, s.qubit, s.ancilla) for s in tp.slots]
        assert _same(jp.ops, tp.ops)


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_kernel_host_tables(case):
    """fused_stream, _slot_tables, label_strides, variant_index_table and
    fold_weights: the tables the kernel consumes."""
    (_, _, jv), (_, _, tv) = _both(case)
    specs_j = [vg.spec for vg in jv.vgates]
    specs_t = [vg.spec for vg in tv.vgates]
    for reg in jv.fragments:
        jp, tp = jv.programs[reg.name], tv.programs[reg.name]
        js, jm = j_fusion.fused_stream(j_ve._fuse_slot_ops(jp.ops), 2)
        ts, tm = t_fusion.fused_stream(t_ve._fuse_slot_ops(tp.ops), 2)
        assert js == ts and _same(jm, tm)
        for fused in (True, False):
            assert _same(j_ve._slot_tables(jp, specs_j, fused=fused),
                         t_ve._slot_tables(tp, specs_t, fused=fused))
        js_, jn, jc = j_ve.label_strides(specs_j, jp.touching)
        ts_, tn, tc = t_ve.label_strides(specs_t, tp.touching)
        assert (js_, jn, jc) == (ts_, tn, tc)
        padded = jc + 5
        assert _same(
            j_ve.variant_index_table(jp.touching, js_, jn, padded,
                                     clamp_to=jc),
            t_ve.variant_index_table(tp.touching, ts_, tn, padded,
                                     clamp_to=tc),
        )
        assert _same(j_knit.fold_weights(jv, reg.name),
                     t_knit.fold_weights(tv, reg.name))


@pytest.mark.parametrize("noise", [0.1, 1e-9])
def test_nearest_probability_distribution_matches(noise):
    """A few large entries over noise: 0.1 discards a short negative tail,
    1e-9 (an exact knit's rounding noise) cuts about half the entries."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
        Distribution as JDist,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
        Distribution as TDist,
    )

    vals = np.random.default_rng(0).normal(0.0, noise, 256).astype(np.float32)
    vals[:8] += 1.0
    j = j_knit.nearest_probability_distribution(JDist(vals, list(range(8)), 8))
    t = t_knit.nearest_probability_distribution(TDist(vals, list(range(8)), 8))
    np.testing.assert_array_equal(j.values, t.values)


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_round_trip(case):
    """A JAX cut circuit (vgate payloads included) carried into the port
    and back out is the same plain data, and builds the same fragments."""
    (_, jcut, jv), _ = _both(case)
    jcirc = jcut.getResultCircs()[3]
    data = circuit_to_instructions(jcirc)
    tcirc = circuit_from_instructions(*data)
    assert _same(circuit_to_instructions(tcirc), data)
    assert any(i["op"] is not None and i["op"]["kind"] == "vgate"
               for i in data[3])
    tv = TVirtualCircuit(to_port(jcirc))
    assert [tv.programs[r.name].num_sim_qubits for r in tv.fragments] == \
        [jv.programs[r.name].num_sim_qubits for r in jv.fragments]


def test_convert_rejects_register_mismatch():
    nq, nc, regs, instrs = circuit_to_instructions(t_gen_circ("ghz", 4, 1))
    with pytest.raises(ValueError):
        circuit_from_instructions(nq + 1, nc, regs, instrs)


def test_port_refuses_what_it_does_not_carry():
    """Unported generators, qasm and gamma mode say which ROADMAP item
    ports them."""
    with pytest.raises(NotImplementedError, match="zoo generators"):
        t_gen_circ("aqft", 8, 1)
    circ = t_gen_circ("ghz", 4, 1)
    with pytest.raises(NotImplementedError, match="qasm"):
        circ.to_qasm()
    with pytest.raises(NotImplementedError, match="gamma"):
        TCutter(circ, maxNPartitions=2, maxNQubitsPerPartition=2,
                gammaMode=True)
