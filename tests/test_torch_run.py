"""The torch port end to end on the CPU against the JAX package's
``engine="pallas"`` (its kernel in interpret mode where a fragment fits
it), and the uncut oracles against each other.  Distributions within
1e-6 (f32 sums in another order), fidelity > 1 - 1e-6."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.evaluate import (  # noqa: E501
    hellinger_fidelity as j_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
    simulate_circuit as j_simulate,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.streamed import (  # noqa: E501
    streamed_expectation_z as j_expectation_z,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.run import (
    run_virtual_circuit as j_run,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    compare_original_with_cut,
    hellinger_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    simulate_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
    make_streamed_knit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit,
)
from torch_port_common import cut_pair

CONFIGS = {
    # (genCirc name, n, depth, partition cap, seed, Cutter limits, chunk)
    "ghz10_p2q5": ("ghz", 10, 1, 5, None,
                   dict(maxNQpdCuts=2, maxNCuts=2), 12),
    "sup12_p2q7": ("sup", 12, 1, 7, 1,
                   dict(maxNQpdCuts=3, maxNCuts=3, maxCutsPerPartitions=3),
                   72),
}


def _pair(key):
    name, n, depth, cap, seed, kw, chunk = CONFIGS[key]
    return cut_pair(name, n, depth, cap, seed=seed, **kw) + (chunk,)


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_run_matches_jax_engine_pallas(key):
    jc, tc, jv, tv, chunk = _pair(key)
    want, _ = j_run(jv, engine="pallas", chunk_size=chunk)
    got, info = run_virtual_circuit(tv, engine="pallas", chunk_size=chunk,
                                    device="cpu")
    assert got.bit_positions == want.bit_positions
    np.testing.assert_allclose(got.values, want.values, atol=1e-6)
    assert info.run_time > 0 and info.knit_time == 0.0
    assert hellinger_fidelity(simulate_circuit(tc, device="cpu"), got) \
        > 1 - 1e-6
    assert j_fidelity(j_simulate(jc), got.to_dict()) > 1 - 1e-6


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_simulate_circuit_matches_jax(key):
    jc, tc, _, _, _ = _pair(key)
    want = j_simulate(jc)
    got = simulate_circuit(tc, device="cpu")
    assert got.bit_positions == want.bit_positions
    assert got.num_clbits == want.num_clbits
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               atol=1e-6)


def test_marginal_knit_matches_jax():
    jc, tc, jv, tv, chunk = _pair("sup12_p2q7")
    keep = [0, 3, 5, 10]
    want, _ = j_run(jv, engine="pallas", chunk_size=chunk,
                    keep_clbits=keep, project=False)
    got, _ = run_virtual_circuit(tv, chunk_size=chunk, keep_clbits=keep,
                                 project=False, device="cpu")
    assert got.bit_positions == want.bit_positions == keep
    np.testing.assert_allclose(got.values, want.values, atol=1e-6)


def test_z_contraction_matches_jax():
    """z mode of the in-kernel fold: every data bit contracted, the carry
    a scalar (the JAX streamed_expectation_z with pallas_variant)."""
    jc, tc, jv, tv, chunk = _pair("sup12_p2q7")
    zc = [1, 4, 9]
    want = j_expectation_z(jv, zc, chunk=chunk, pallas_variant=True)
    step, xs, _ = make_streamed_knit(tv, chunk, z_clbits=frozenset(zc),
                                     device="cpu")
    assert abs(float(step(xs).reshape(())) - want) < 1e-6


def test_compare_original_with_cut():
    jc, tc, jv, tv, chunk = _pair("ghz10_p2q5")
    res = compare_original_with_cut(tc, tv._circuit, chunk_size=chunk,
                                    device="cpu")
    assert res.cut_vs_uncut_fidelity > 1 - 1e-6
    assert res.input_fidelity == pytest.approx(1.0)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device=`` every entry point asks for CUDA, and raises when
    there is none instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc, _, tv, chunk = _pair("ghz10_p2q5")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_virtual_circuit(tv, chunk_size=chunk)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_circuit(tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_streamed_knit(tv, chunk)


@pytest.mark.parametrize("engine", ["auto", "xla", "streamed", "sharded",
                                    "sampled"])
def test_unported_engines_name_their_roadmap_item(engine):
    _, _, _, tv, _ = _pair("ghz10_p2q5")
    with pytest.raises(NotImplementedError, match="ROADMAP H100 port"):
        run_virtual_circuit(tv, engine=engine, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(shots=100), dict(noise=object()), dict(trunc_eps=0.01),
    dict(share_prefix=True), dict(dtype=torch.bfloat16),
])
def test_streamed_refusals(kw):
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
        run_virtual_circuit_streamed,
    )

    _, _, _, tv, chunk = _pair("ghz10_p2q5")
    with pytest.raises(NotImplementedError, match="ROADMAP H100 port"):
        run_virtual_circuit_streamed(tv, chunk, device="cpu", **kw)


def test_chip_smoke_refuses_without_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where there
    is no card, and where it stands alone without the package."""
    import pathlib
    import shutil

    root = pathlib.Path(__file__).resolve().parent.parent
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(root / "chip_smoke.py", alone)
    for script in (root / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
