"""``run_virtual_circuit(tracer=)`` in the port against the JAX package:
the same phases (names, order and meta) on the batched engine (with a
checkpoint saved, then loaded, and shots), the sampled engine and the
streamed scans; the traced result equals the untraced one bit for bit;
a ``profile_dir`` gets a ``torch.profiler`` Chrome trace; and an untraced
call never waits for the card."""
import json

import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.run import (
    run_virtual_circuit as j_run,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.utils.profiling import (  # noqa: E501
    Tracer as JTracer,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.utils import (  # noqa: E501
    profiling,
)
from torch_port_common import cut_pair


def _phases(tracer):
    return [(p.name, p.meta) for p in tracer.phases]


@pytest.mark.parametrize("engine,kw", [
    ("xla", dict(shots=500, checkpoint_dir="ckpt")),
    ("sampled", dict(shots=400, sample_pallas=False)),
    ("sampled", dict(sample_eps=0.05, shots=4000)),
    ("pallas", {}),
], ids=["xla", "sampled", "sampled_eps", "pallas"])
def test_phases_match_jax(engine, kw, tmp_path, monkeypatch):
    _, _, jv, tv = cut_pair("ghz", 6, 1, 4, seed=None)
    calls = []
    real_sync = profiling._sync
    monkeypatch.setattr(profiling, "_sync",
                        lambda d: (calls.append(d), real_sync(d)))
    runs = 2 if "checkpoint_dir" in kw else 1
    for _ in range(runs):
        before = len(calls)
        jkw = dict(kw)
        tkw = dict(kw)
        if "checkpoint_dir" in kw:
            jkw["checkpoint_dir"] = tmp_path / "jax"
            tkw["checkpoint_dir"] = tmp_path / "port"
        jt, tt = JTracer(), profiling.Tracer(profile_dir=tmp_path / "prof")
        want, _ = j_run(jv, engine=engine, tracer=jt, **jkw)
        got, _ = run_virtual_circuit(tv, engine=engine, tracer=tt,
                                     device="cpu", **tkw)
        assert _phases(tt) == _phases(jt)
        assert [p["name"] for p in tt.report()["phases"]] == \
            [p.name for p in jt.phases]
        assert "phase timings" in str(tt) and tt.total() >= 0
        n_sync = len(calls)
        assert n_sync - before == 2 * len(tt.phases) + len(tt.traces)
        assert set(calls[before:]) == {"cpu"}  # the run's device
        plain, _ = run_virtual_circuit(tv, engine=engine, device="cpu",
                                       **tkw)
        assert len(calls) == n_sync  # no tracer, no synchronise
        assert plain.bit_positions == got.bit_positions
        np.testing.assert_array_equal(plain.values, got.values)
    if engine == "xla":
        # the first run simulated inside a device trace; the second loaded
        # the checkpoint and traced nothing
        names = [p.name for p in tt.phases]
        assert names[0] == "load_checkpoint" and "simulate" not in names
        assert tt.traces == []
        trace = tmp_path / "prof" / "trace_0.json"
        assert trace.is_file() and json.loads(trace.read_text())
        out = tmp_path / "phases.json"
        tt.save(out)
        assert json.loads(out.read_text())["phases"][0]["name"] == \
            "load_checkpoint"
