"""The port's spans (``utils/profiling.span``) on the request path, under
``torch.profiler`` on the CPU: every span of a request (front end, host
build and its prefix, scan with its rows and knit, projection, fetch)
appears, nested and counted as the plan says, as a host-only event; a
traced answer equals the untraced one bit for bit; with no profiler
running a span is the shared null context, builds no record and never
waits for the card; a ``Tracer`` phase appears as ``port.phase.<name>``;
the trajectory-noise scan's spans (draws, routing, noisy rows) and row
counters, which the exact routes never enter.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
    Cutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    noise,
    streamed,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
    auto_chunk,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.utils import (  # noqa: E501
    profiling,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit,
)
from torch_port_common import CUT_KW, cut_pair

CHUNK = 4  # labels a chunk: several chunks on the small cut

ENGINES = ["pallas", "streamed"]


def _circuit():
    return cut_pair("ghz", 6, 1, 4)[1]


def _request(circ, engine, **kw):
    """A request as a user sends it: cut (solved, then adopted again as a
    stored plan), virtual circuit, run.  Returns (virt, distribution)."""
    cutter = Cutter(circ, maxNPartitions=2, maxNQubitsPerPartition=4,
                    **CUT_KW)
    assert cutter.solve()
    cutter.use_plan(cutter.plan)
    virt = VirtualCircuit(cutter.getResultCircs()[3])
    dist, _ = run_virtual_circuit(virt, engine=engine, chunk_size=CHUNK,
                                  device="cpu", **kw)
    return virt, dist


def _port_parent(event):
    """The innermost enclosing ``port.`` event's name, or None."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("port."):
        p = p.cpu_parent
    return None if p is None else p.name


def _traced(engine, **kw):
    circ = _circuit()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        virt, dist = _request(circ, engine, **kw)
    events = [e for e in prof.events() if e.name.startswith("port.")]
    return circ, virt, dist, events


@pytest.fixture(scope="module", params=ENGINES)
def traced(request):
    return (request.param,) + _traced(request.param)


def test_spans_nest_and_count_as_the_plan_says(traced):
    engine, _, virt, _, events = traced
    names = [e.name for e in events]
    frags = len(virt.fragments)
    labels = 1
    for vg in virt.vgates:
        labels *= vg.spec.num_instantiations
    chunks = math.ceil(labels / auto_chunk(virt, CHUNK))
    assert chunks > 1
    count = {n: names.count(n) for n in set(names)}
    assert {k: count.get(k, 0) for k in (
        "port.cutter", "port.cut", "port.virtual_circuit", "port.build",
        "port.scan", "port.rows", "port.knit", "port.project",
        "port.fetch")} == {
        "port.cutter": 1, "port.cut": 3, "port.virtual_circuit": 1,
        "port.build": 1, "port.scan": 1, "port.rows": chunks * frags,
        "port.knit": chunks, "port.project": 1, "port.fetch": 1}
    # kernel 1's plan builds one prefix a fragment; the plain route's
    # plan builder runs per fusion width it weighs
    want_prefix = frags if engine == "pallas" else 3 * frags
    assert count["port.build.prefix"] == want_prefix
    parents = {}
    for e in events:
        parents.setdefault(e.name, set()).add(_port_parent(e))
    assert parents == {
        "port.cutter": {None}, "port.cut": {None},
        "port.virtual_circuit": {None}, "port.build": {None},
        "port.build.prefix": {"port.build"}, "port.scan": {None},
        "port.rows": {"port.scan"}, "port.knit": {"port.scan"},
        "port.project": {None}, "port.fetch": {None}}


NOISY_SPANS = ("port.noise.draw", "port.noise.rows", "port.route")


def test_exact_routes_have_no_noise_spans(traced):
    assert not {e.name for e in traced[-1]} & set(NOISY_SPANS)


def test_noisy_run_records_its_spans_and_counts_its_rows(monkeypatch):
    """The trajectory-noise scan: one draw and one routing a fragment in
    the build, one ``port.noise.rows`` a fragment and chunk inside its
    ``port.rows``; ``noisy_rows.rows`` counts padded labels x
    trajectories a noisy fragment, ``.site_passes`` those rows x the
    fragment's active sites."""
    virt, _ = _request(_circuit(), "pallas")
    model = dataclasses.replace(noise.fake_kolkata_v2(27), trajectories=2)
    counted = streamed._SimRows.noisy_rows
    monkeypatch.setattr(counted, "rows", 0)
    monkeypatch.setattr(counted, "site_passes", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, info = noise.run_noisy_virtual_circuit(
            virt, model, engine="streamed", chunk_size=CHUNK, seed=3,
            device="cpu")
    events = [e for e in prof.events() if e.name in NOISY_SPANS]
    names = [e.name for e in events]
    frags = len(virt.fragments)
    labels = 1
    for vg in virt.vgates:
        labels *= vg.spec.num_instantiations
    chunk = auto_chunk(virt, CHUNK, 2, noisy=True)
    chunks = math.ceil(labels / chunk)
    assert chunks > 1
    assert {n: names.count(n) for n in NOISY_SPANS} == {
        "port.noise.draw": frags, "port.noise.rows": chunks * frags,
        "port.route": frags}
    parents = {}
    for e in events:
        parents.setdefault(e.name, set()).add(_port_parent(e))
    assert parents == {"port.noise.draw": {"port.build"},
                       "port.noise.rows": {"port.rows"},
                       "port.route": {"port.build"}}
    padded = chunks * chunk
    sites = [f["draws"].shape[2] for f in info.noise["fragments"]]
    assert counted.rows == padded * 2 * frags
    assert counted.site_passes == padded * 2 * sum(sites)


def test_spans_are_host_only_events(traced):
    events = traced[-1]
    assert events
    # a user annotation would get a device-side copy with CUDA activity
    assert not any(e.is_user_annotation for e in events)
    assert {e.device_type for e in events} == {torch.autograd.DeviceType.CPU}


def test_traced_answer_equals_untraced(traced):
    engine, circ, _, dist, _ = traced
    _, plain = _request(circ, engine)
    assert plain.bit_positions == dist.bit_positions
    np.testing.assert_array_equal(plain.values, dist.values)


def test_off_span_is_the_shared_null_context_and_never_waits(monkeypatch):
    built, waits = [], []
    real = profiling._Record
    monkeypatch.setattr(profiling, "_Record",
                        lambda name: (built.append(name), real(name))[1])
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: waits.append(a))
    assert profiling.span("port.x") is profiling._OFF
    assert profiling.span("port.y") is profiling.span("port.x")
    _request(_circuit(), "pallas")
    assert built == [] and waits == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("port.x"):
            pass
        _request(_circuit(), "pallas")
    assert built[0] == "port.x" and "port.build" in built
    assert waits == []


def test_device_span_is_a_user_annotation_only_under_a_profiler():
    """``device_span`` builds nothing with the profiler off; under it,
    a ``record_function`` (the annotation the profiler copies to the
    card) named as asked."""
    assert profiling.device_span("port.x") is profiling._OFF
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        block = profiling.device_span("port.x")
        assert isinstance(block, torch.autograd.profiler.record_function)
        with block:
            pass
    assert [e.name for e in prof.events()].count("port.x") == 1


def test_tracer_phase_is_a_span():
    tracer = profiling.Tracer()
    circ = _circuit()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _request(circ, "pallas", tracer=tracer)
    events = [e for e in prof.events() if e.name.startswith("port.")]
    phase = [e for e in events if e.name == "port.phase.stream_sim_knit"]
    assert len(phase) == 1 and not phase[0].is_user_annotation
    assert [p.name for p in tracer.phases] == ["stream_sim_knit"]
    inside = {_port_parent(e) for e in events if e.name in (
        "port.build", "port.scan", "port.project", "port.fetch")}
    assert inside == {"port.phase.stream_sim_knit"}
