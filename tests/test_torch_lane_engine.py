"""The port's lane-layout engine (``ops/lane_engine.py``, chunk axis
trailing, plain PyTorch) against the JAX package's lane engine and the
port's own ``make_sim_fn`` rows, from the same gathered slot tables, on
the JAX test's circuits (gate cuts, wire cuts with deferral ancillas,
fragments without slots)."""
import jax
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.lane_engine import (  # noqa: E501
    make_lane_sim as j_make_lane_sim,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.lane_engine import (  # noqa: E501
    make_lane_sim,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.variant_engine import (  # noqa: E501
    make_sim_fn,
)
from torch_port_common import cut_pair


@pytest.mark.parametrize("kind,n,d,q", [("hwe", 8, 2, 5), ("aqft", 6, 1, 4)])
def test_lane_rows_match_jax_and_make_sim_fn(kind, n, d, q):
    _, _, jv, tv = cut_pair(kind, n, d, q, seed=None)
    for reg in tv.fragments:
        prog = tv.programs[reg.name]
        sim_fn, all_mats, pos, v = make_sim_fn(tv, reg.name)
        sim_chunk, pos2, v2 = make_lane_sim(tv, reg.name, device="cpu")
        j_chunk, j_pos, j_v = j_make_lane_sim(jv, reg.name)
        assert (pos, v) == (pos2, v2) == (list(j_pos), j_v)
        if not prog.slots:
            np.testing.assert_allclose(
                sim_chunk([])[:, 0].numpy(), sim_fn([], "cpu")[0].numpy(),
                atol=1e-6)
            continue
        for c in sorted({min(v, 32), min(v, 12)}):
            mats = [tuple(m[:c] for m in t) for t in all_mats]
            lane = sim_chunk([tuple(torch.as_tensor(m) for m in t)
                              for t in mats])
            lead = sim_fn([tuple(torch.as_tensor(m) for m in t)
                           for t in mats])
            want = np.asarray(jax.jit(j_chunk)(mats))
            assert tuple(lane.shape) == want.shape == tuple(lead.T.shape)
            np.testing.assert_allclose(lane.numpy(), want, atol=1e-6)
            np.testing.assert_allclose(lane.numpy(), lead.T.numpy(),
                                       atol=1e-6)
