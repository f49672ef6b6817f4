"""The sharded engine in one process: the port's mesh of one (no process
group) against the JAX package's one-device mesh.

Port twins of the single-device JAX tests
(tests/test_sharded_fragment.py::test_sharded_fragment_single_device,
tests/test_bf16_serving.py::test_bf16_sharded_fragment_close_to_f32 and
::test_bf16_dp_tp_knit_step_close_to_f32), the mesh helpers, and
``run_virtual_circuit(engine="sharded")`` with its keywords.  The
exchanges between ranks run in tests/test_torch_sharded_dist.py.
Tolerances are JAX's: 1e-6 for f32, 5e-3 for bf16.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
    Instruction as JInstruction,
    Register as JRegister,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (
    sharded_fragment as jsf,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
    simulate_circuit as j_simulate,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.parallel.sharded import (  # noqa: E501
    make_sharded_step as j_make_sharded_step,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.run import (
    run_virtual_circuit as j_run,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_gates import (  # noqa: E501
    VirtualGateOp as JVirtualGateOp,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    sharded_fragment as tsf,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.sharded_sv import (  # noqa: E501
    ShardCtx,
    sharded_probabilities,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    compile_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.parallel import (  # noqa: E501
    mesh as tmesh,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.parallel.sharded import (  # noqa: E501
    make_sharded_step,
    streamed_values_dp,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from torch_port_common import CUT_KW, to_port

CPU = "cpu"


def _jmesh(*names):
    return JMesh(np.array(jax.devices()[:1]).reshape((1,) * len(names)),
                 names)


def _tmesh(*names):
    return tmesh.Mesh(np.zeros((1,) * len(names), np.int64), names,
                      device=CPU)


def _small_cut():
    """tests/test_sharded_fragment.py's single-device case: a 2+2 split
    under one cz cut."""
    cut = JCircuit([JRegister("frag0", 2), JRegister("frag1", 2)], 4)
    cut.h(0)
    cut.cx(0, 1)
    cut.append(JInstruction("vgate", [1, 2], op=JVirtualGateOp("cz")))
    cut.cx(2, 3)
    for q in range(4):
        cut.measure(q, q)
    return JVirtualCircuit(cut), TVirtualCircuit(to_port(cut))


def _chain(n=8, cap=5):
    """An n-qubit CX chain with rz, cut at capacity ``cap`` by the JAX
    cutter (the JAX sharded tests' chain)."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
        Cutter as JCutter,
    )

    circ = JCircuit(n, n)
    circ.h(0)
    for i in range(n - 1):
        circ.cx(i, i + 1)
    for q in range(n):
        circ.rz(0.1 * (q + 1), q)
    for q in range(n):
        circ.measure(q, q)
    cutter = JCutter(circ, maxNPartitions=2, maxNQubitsPerPartition=cap,
                     **CUT_KW)
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    return circ, JVirtualCircuit(cut), TVirtualCircuit(to_port(cut))


def test_sharded_fragment_single_device():
    """dp=1, amp=1: the port's mesh of one reproduces the JAX package's
    one-device co-sharded rows."""
    jv, tv = _small_cut()
    for reg in tv.fragments:
        want = jsf.run_fragment_sharded(jv, reg.name, _jmesh("dp", "amp"))
        got = tsf.run_fragment_sharded(tv, reg.name, _tmesh("dp", "amp"))
        np.testing.assert_allclose(got.values.numpy(),
                                   np.asarray(want.values), atol=1e-6)
        assert got.bit_positions == want.bit_positions
        assert got.touching == want.touching


def test_bf16_sharded_fragment_close_to_f32():
    """bf16 local blocks (exchanges too, where there are any): within
    bf16 rounding of the JAX package's f32 rows, on the JAX test's
    8-qubit chain cut at capacity 5."""
    _, jv, tv = _chain(8, 5)
    name = tv.fragments[0].name
    f32 = jsf.run_fragment_sharded(jv, name, _jmesh("dp", "amp"))
    b16 = tsf.run_fragment_sharded(tv, name, _tmesh("dp", "amp"),
                                   dtype=torch.bfloat16)
    assert b16.values.dtype == torch.float32
    err = np.abs(np.asarray(f32.values) - b16.values.numpy()).max()
    assert 0 < err < 5e-3, err


def test_bf16_dp_tp_knit_step_close_to_f32():
    """The dp x tp knit step on a mesh of one: f32 as JAX's within 1e-6,
    bf16 within 5e-3 of JAX's f32 (hwe-8, depth 2, capacity 5)."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
        Cutter as JCutter,
    )

    cutter = JCutter(j_gen_circ("hwe", 8, 2), maxNPartitions=2,
                     maxNQubitsPerPartition=5, **CUT_KW)
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    jv, tv = JVirtualCircuit(cut), TVirtualCircuit(to_port(cut))
    jstep, jargs, jshard, jpos = j_make_sharded_step(jv, _jmesh("dp", "tp"))
    want = np.asarray(jax.jit(jstep, in_shardings=jshard)(*[
        jax.device_put(a, s) for a, s in zip(jargs, jshard)]))
    outs = {}
    for key, dt in (("f32", None), ("bf16", torch.bfloat16)):
        step, args, pos = make_sharded_step(tv, _tmesh("dp", "tp"),
                                            dtype=dt)
        assert pos == jpos
        for a, ja in zip(args, jargs):
            np.testing.assert_array_equal(a, np.asarray(ja))
        outs[key] = step(*args).numpy()
    np.testing.assert_allclose(outs["f32"], want, atol=1e-6)
    assert np.abs(outs["bf16"] - want).max() < 5e-3


def test_sharded_probabilities_on_a_mesh_of_one():
    """ShardCtx with every qubit local (amp = 1): the JAX oracle's
    distribution, a mid-circuit measurement included."""
    circ = JCircuit(3, 4)
    circ.h(0)
    circ.cx(0, 1)
    circ.measure(0, 3)
    circ.h(0)
    circ.ry(0.7, 2)
    circ.cx(1, 2)
    for q in range(3):
        circ.measure(q, q)
    want = j_simulate(circ)
    got = sharded_probabilities(compile_circuit(to_port(circ)),
                                _tmesh("amp"))
    assert got.bit_positions == want.bit_positions
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               atol=1e-6)


def test_mesh_of_one_and_its_helpers():
    """Without a process group: a world of one whose collectives are the
    identity, make_mesh's (dp, tp) shape, the JAX sharding descriptors,
    fragment_mesh's (1, 1) whatever max_local_qubits asks, and the JAX
    ValueError for a mesh without the fragment's axes."""
    assert tmesh.world() == (1, 0)
    m = tmesh.make_mesh(device=CPU)
    assert m.shape == {"dp": 1, "tp": 1}
    assert m.coords == {"dp": 0, "tp": 0} and m.member
    t = torch.arange(3.0)
    assert m.all_reduce(t, "dp") is t
    assert torch.equal(m.all_gather(t, "dp"), t)
    assert tmesh.variant_sharding(m).spec == ("dp",)
    assert tmesh.replicated(m).spec == ()
    fm = tsf.fragment_mesh(30, max_local_qubits=24, device=CPU)
    assert fm.shape == {"dp": 1, "amp": 1}
    jm = jsf.fragment_mesh(30, max_local_qubits=24,
                           devices=jax.devices()[:1])
    assert dict(jm.shape) == fm.shape
    _, tv = _small_cut()
    with pytest.raises(ValueError, match="needs a mesh with"):
        tsf.run_fragment_sharded(tv, "frag0", m)
    three = type("ThreeShards", (), {"shape": {"amp": 3}})()
    with pytest.raises(AssertionError, match="power of 2"):
        ShardCtx(4, three, "amp")


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_engine_sharded_matches_jax(dtype):
    """``run_virtual_circuit(engine="sharded")`` with ``max_local_qubits``
    on one device (mesh (1, 1) for every fragment) equals JAX's
    ``engine="sharded"`` within 1e-6; with ``dtype=torch.bfloat16``
    within 5e-3 of it (``dtype`` is allowed on "sharded")."""
    circ, jv, tv = _chain(8, 5)
    want, _ = j_run(jv, engine="sharded", max_local_qubits=4,
                    project=False)
    got, info = run_virtual_circuit(tv, engine="sharded",
                                    max_local_qubits=4, project=False,
                                    dtype=dtype, device=CPU)
    assert got.bit_positions == want.bit_positions
    tol = 1e-6 if dtype is None else 5e-3
    assert np.abs(got.values - np.asarray(want.values)).max() < tol
    assert info.knit_time >= 0.0


def test_engine_sharded_checkpoint_and_shots(tmp_path):
    """``checkpoint_dir`` and ``shots`` apply after the sharded
    fragments, as in the JAX package: the checkpoint is written and
    equals JAX's checkpointed run within 1e-6, a rerun loads it
    unchanged, and the rows' shots (drawn on the device, as on "xla")
    knit near the oracle."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
        hellinger_fidelity,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
        simulate_circuit,
    )

    circ, jv, tv = _chain(6, 4)
    want, _ = j_run(jv, engine="sharded", checkpoint_dir=tmp_path / "jax")
    got, _ = run_virtual_circuit(tv, engine="sharded",
                                 checkpoint_dir=tmp_path / "port",
                                 device=CPU)
    assert (tmp_path / "port" / "fragment_results.json").exists()
    again, _ = run_virtual_circuit(tv, engine="sharded",
                                   checkpoint_dir=tmp_path / "port",
                                   device=CPU)
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               atol=1e-6)
    np.testing.assert_array_equal(again.values, got.values)
    shot, _ = run_virtual_circuit(tv, engine="sharded", shots=20000,
                                  seed=4, device=CPU)
    oracle = simulate_circuit(to_port(circ), device=CPU)
    assert hellinger_fidelity(oracle, shot) > 0.99


def test_streamed_dp_helper_on_a_mesh_of_one():
    """``streamed_values_dp`` on a mesh of one is the whole scan."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
        make_streamed_knit,
    )

    _, _, tv = _chain(6, 4)
    step, xs, meta = make_streamed_knit(tv, chunk=8, share_prefix=True,
                                        device=CPU)
    got = streamed_values_dp(meta, xs, tmesh.make_mesh(device=CPU))
    np.testing.assert_allclose(got.numpy(), step(xs).numpy(), atol=1e-7)


def test_sharded_entry_points_default_to_cuda(monkeypatch):
    """No card: a mesh without ``device``, and the sharded engine without
    one, raise; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    _, tv = _small_cut()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_virtual_circuit(tv, engine="sharded")


def test_engine_sharded_in_a_process_group_of_one(tmp_path):
    """Inside a ``gloo`` process group of one (the card's NCCL group of
    one, on the CPU): the meshes' collectives run on groups of one and
    give the mesh-of-one values; destroying the group releases the
    subgroups the meshes made, and a new group starts anew."""
    import gc

    import torch.distributed as dist

    _, _, tv = _chain(6, 4)
    want, _ = run_virtual_circuit(tv, engine="sharded", project=False,
                                  device=CPU)
    for attempt in range(2):
        dist.init_process_group("gloo", rank=0, world_size=1,
                                init_method=f"file://{tmp_path}/s{attempt}")
        try:
            mesh = tmesh.make_mesh(device=CPU)
            assert mesh.groups["dp"] is not None
            t = torch.ones(3)
            assert torch.equal(mesh.all_reduce(t, "dp"), torch.ones(3))
            got, _ = run_virtual_circuit(tv, engine="sharded",
                                         project=False, device=CPU)
            np.testing.assert_array_equal(got.values, want.values)
            assert len(tmesh._GROUPS) == 1
            del mesh
        finally:
            dist.destroy_process_group()
        gc.collect()
        assert len(tmesh._GROUPS) == 0
