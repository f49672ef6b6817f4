"""The port's analytic roofline (``ops/roofline.py``) against the JAX
package's: on the circuits of ``tests/test_roofline.py`` and
``tests/test_ici_roofline.py`` every count of ``FragmentCost``,
``StepModel``, ``ShardedCost`` and ``SampledCost`` equals JAX's (the
port walks its own ``make_sim_fn`` plan with the same rules).  The chip
constants are the H100's; the sampled kernel floor keeps JAX's value up
to the on-chip width and counts the state's passes past it."""
import dataclasses

import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (
    roofline as j_roof,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
    compile_circuit as j_compile,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    roofline as t_roof,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    compile_circuit as t_compile,
)
from torch_port_common import chain_cut_pair, cut_pair, qft_gamma_pair, to_port


def _pair(name):
    if name == "chain6":
        return chain_cut_pair(6)
    if name == "chain16":
        return chain_cut_pair(16)
    if name == "qft6_gamma":
        return qft_gamma_pair(6, 5)
    kind, n, d, q = {"hwe8": ("hwe", 8, 2, 5), "aqft10": ("aqft", 10, 1, 6),
                     "sup12": ("sup", 12, 1, 7)}[name]
    _, _, jv, tv = cut_pair(kind, n, d, q, seed=None)
    return jv, tv


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("name", ["hwe8", "aqft10", "sup12", "chain6"])
def test_fragment_and_step_models_match_jax(name):
    jv, tv = _pair(name)
    for reg in tv.fragments:
        assert _asdict(t_roof.fragment_cost(tv, reg.name)) == \
            _asdict(j_roof.fragment_cost(jv, reg.name))
    for kw in (dict(chunk=16), dict(chunk=64, keep_clbits=[0, 1]),
               dict(chunk=32, share_prefix=True),
               dict(chunk=32, share_prefix=True, hoist_banks=True)):
        want = j_roof.streamed_step_model(jv, **kw)
        got = t_roof.streamed_step_model(tv, **kw)
        assert _asdict(got) == _asdict(want), kw
        assert got.seconds() == got.total_bytes / 3.35e12


def test_sharded_models_match_jax():
    jv, tv = chain_cut_pair(6)
    for dp, amp, nbytes in ((2, 4, 4), (1, 2, 2), (4, 1, 4)):
        want = j_roof.sharded_fragment_cost(jv, "frag0", dp, amp, nbytes)
        got = t_roof.sharded_fragment_cost(tv, "frag0", dp, amp, nbytes)
        assert _asdict(got) == _asdict(want)
        assert got.seconds() == max(got.hbm_bytes / 3.35e12,
                                    got.ici_bytes / 450e9)
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
        genCirc,
    )

    circ = genCirc("ghz", 10, 1)
    for amp in (2, 8):
        want = j_roof.sharded_sv_cost(j_compile(circ), amp, 10)
        got = t_roof.sharded_sv_cost(t_compile(to_port(circ)), amp, 10)
        assert _asdict(got) == _asdict(want)


@pytest.mark.parametrize("name", ["qft6_gamma", "chain6", "chain16"])
def test_sampled_models_match_jax(name):
    """Without a kernel every count is JAX's; the kernel floor is JAX's
    up to 15 simulated qubits (the state on chip) and adds the state's
    passes through global memory past that (chain16: 16 qubits)."""
    jv, tv = _pair(name)
    for reg in tv.fragments:
        for collapse in (True, False):
            for keep in (None, [0, 1]):
                kw = dict(keep_clbits=keep, collapse=collapse)
                want = j_roof.sampled_collapse_row_cost(jv, reg.name, **kw)
                assert t_roof.sampled_collapse_row_cost(
                    tv, reg.name, **kw) == want
                jp = j_roof.sampled_collapse_row_cost(jv, reg.name,
                                                      pallas=True, **kw)
                tp = t_roof.sampled_collapse_row_cost(tv, reg.name,
                                                      pallas=True, **kw)
                assert tp[1] == jp[1]
                if name != "chain16":
                    assert tp == jp
                elif reg.name == "frag0":
                    assert tp[0] > jp[0]
    for kw in (dict(collapse="auto"), dict(collapse=True, pallas=True),
               dict(keep_clbits=[0], second_moment=False)):
        want = j_roof.sampled_estimate_model(jv, rows=100, **kw)
        got = t_roof.sampled_estimate_model(tv, rows=100, **kw)
        if name == "chain16" and kw.get("pallas"):
            assert got.total_bytes > want.total_bytes
            continue
        assert _asdict(got) == _asdict(want), kw
