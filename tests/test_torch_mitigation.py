"""The port's error mitigation (``ops/mitigation.py``) on the CPU against
the JAX package: readout inversion bit for bit (both are host numpy in
float64), noise scaling field for field, the extrapolations exactly, and
ZNE over the noisy streamed observable within 1e-6 a scale (the same
trajectory draws, f32 sums in another order)."""
import dataclasses

import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (
    mitigation as jmit,
    noise as jn,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
    Distribution as JDistribution,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    noise_model_from_other,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    mitigation as tmit,
    noise as tn,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    Distribution,
)
from torch_port_common import cut_pair


@pytest.mark.parametrize("bit_qubits", [None, [3, 0, 8, 1]])
def test_mitigate_readout_inverts_and_matches(bit_qubits):
    jm = jn.fake_kolkata_v2()
    tm = noise_model_from_other(jm)
    vals = np.random.default_rng(1).dirichlet(np.ones(16)).astype(np.float32)
    pos = [0, 2, 3, 5]
    noisy = tn.apply_readout_error(Distribution(vals, pos, 6), tm,
                                   bit_qubits=bit_qubits, device="cpu")
    got = tmit.mitigate_readout(noisy, tm, bit_qubits=bit_qubits)
    np.testing.assert_allclose(got.values, vals, atol=1e-6)
    want = jmit.mitigate_readout(JDistribution(noisy.values, pos, 6), jm,
                                 bit_qubits=bit_qubits)
    assert np.array_equal(got.values, want.values)


def test_scale_noise_and_extrapolations_match():
    jm = jn.fake_kolkata_v2(relaxation=True)
    tm = noise_model_from_other(jm)
    for f in (0.0, 1.5, 3.0):
        a, b = jmit.scale_noise(jm, f), tmit.scale_noise(tm, f)
        for fld in dataclasses.fields(b):
            x, y = getattr(a, fld.name), getattr(b, fld.name)
            if isinstance(y, np.ndarray):
                assert np.array_equal(x, y), fld.name
            elif fld.name != "coupling":
                assert x == y, fld.name
    s, v = [1.0, 2.0, 3.0], [0.9, 0.82, 0.75]
    for order in (None, 1):
        assert (tmit.richardson_extrapolate(s, v, order)
                == jmit.richardson_extrapolate(s, v, order))
    assert (tmit.exponential_extrapolate(s, v)
            == jmit.exponential_extrapolate(s, v))
    with pytest.raises(ValueError):
        tmit.scale_noise(tm, -1.0)


def test_zne_matches_jax_with_relaxation_and_fragment_list():
    """GHZ-6 cut into two fragments, depolarising + T1/T2 per fragment:
    ZNE's per-scale <Z^6> equal JAX's within 1e-6, and so does the
    extrapolation."""
    _, _, jv, tv = cut_pair("ghz", 6, 1, 4)
    jm = jn.NoiseModel(p1=0.004, p2=0.02, readout01=0.0, readout10=0.0,
                       t1=40e-6, t2=50e-6, trajectories=8)
    z = sorted(c for p in tv.programs.values() for c in p.clbit_sources
               if c < tv.num_clbits)
    for method, noise in (("exp", jm), ("richardson", [jm, jm])):
        want, wvals = jmit.zne_expectation_z(jv, z, noise, method=method,
                                             seed=1, chunk=16)
        tnoise = (noise_model_from_other(jm) if method == "exp"
                  else [noise_model_from_other(m) for m in noise])
        got, gvals = tmit.zne_expectation_z(tv, z, tnoise, method=method,
                                            seed=1, chunk=16, device="cpu")
        np.testing.assert_allclose(gvals, wvals, atol=1e-6)
        assert abs(got - want) < 1e-6
        assert gvals[2] < gvals[0] < 1.0
    with pytest.raises(ValueError, match="unknown extrapolation"):
        tmit.zne_expectation_z(tv, z, tnoise, method="cubic", device="cpu")
