"""The port's sparse knit (``virt/sparse_knit.py``) against the JAX
package's: on the same fragment rows (the JAX package's, carried into
the port) ``sparse_knit`` gives the same quasi-distribution within 1e-9;
the port's shot-sampled rows (kernel 2's full rows, here its plain
version) knit to the uncut distribution at JAX's own bar."""
import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.variant_engine import (  # noqa: E501
    run_all_fragments as j_run_all_fragments,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.sparse_knit import (  # noqa: E501
    sparse_knit as j_sparse_knit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    fragment_result_from_other,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    hellinger_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    variant_kernel,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    simulate_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.sparse_knit import (  # noqa: E501
    sampled_sparse_fragment_rows,
    sparse_knit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from torch_port_common import to_port


def _circ(kind, n):
    circ = JCircuit(n, n)
    if kind == "ghz":
        circ.h(0)
        for i in range(n - 1):
            circ.cx(i, i + 1)
    else:
        rng = np.random.default_rng(2)
        for q in range(n):
            circ.ry(float(rng.standard_normal()), q)
        for i in range(n - 1):
            circ.cx(i, i + 1)
        circ.rzz(0.4, 0, n - 1)
    for q in range(n):
        circ.measure(q, q)
    return circ


def _cut(circ, cap):
    cutter = JCutter(circ, maxNPartitions=2, maxNQubitsPerPartition=cap,
                     maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    return JVirtualCircuit(cut), TVirtualCircuit(to_port(cut))


@pytest.mark.parametrize("kind", ["ghz", "mixed"])
def test_sparse_knit_matches_jax_on_the_same_rows(kind):
    jv, tv = _cut(_circ(kind, 5), 3)
    jres = j_run_all_fragments(jv)
    tres = [fragment_result_from_other(r, device="cpu") for r in jres]
    want = j_sparse_knit(jv, jres)
    got = sparse_knit(tv, tres)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_allclose(got.vals, want.vals, rtol=0, atol=1e-9)


def test_sampled_sparse_rows_knit_converges_to_exact(monkeypatch):
    """ghz-8 cut at 5: 100000 shots a row (seed 11 + i), knitted and
    projected, fidelity > 0.998 to the port's oracle (JAX's own bar).
    The rows come from kernel 2's plain version; with the kernel taken
    away (``make_chunk_kernel`` returning None, as past its width gate)
    the route without a kernel draws the same counts."""
    circ = _circ("ghz", 8)
    _, tv = _cut(circ, 5)
    rows = {
        reg.name: sampled_sparse_fragment_rows(
            tv, reg.name, shots=100_000, seed=11 + i, device="cpu")
        for i, reg in enumerate(tv.fragments)
    }
    q = sparse_knit(tv, rows=rows).nearest_probability_distribution()
    fid = hellinger_fidelity(q.to_dict(),
                             simulate_circuit(to_port(circ), device="cpu"))
    assert fid > 0.998, fid
    monkeypatch.setattr(variant_kernel, "make_chunk_kernel",
                        lambda *a, **k: None)
    name = tv.fragments[0].name
    plain = sampled_sparse_fragment_rows(tv, name, shots=100_000, seed=11,
                                         device="cpu")
    assert [r.to_dict() for r in plain] == \
        [r.to_dict() for r in rows[name]]
