"""The readers of the port's spans (``portbench/spans.py``) on a
synthetic trace: nested and repeated ``port.`` host events count once,
in ms a request, inside the window; a trace without them reads nothing;
and the spans leave the device's idle share as it was."""
import pytest

from portbench.cell import ROOT, named_module
from portbench.trace import Trace

SPANS = ("host_build_ms", "host_prefix_ms", "scan_host_ms", "cut_ms",
         "virtual_circuit_ms")


def _read(name, trace):
    return named_module(ROOT, "metrics", name).read(trace)


BENCH = [("portbench.window", 0.0, 1.0),
         ("portbench.frontend", 0.0, 0.2),
         ("portbench.entry", 0.2, 0.5),
         ("portbench.frontend", 0.5, 0.7),
         ("portbench.entry", 0.7, 1.0)]

PORT = [
    # request 1: cutter, two cut calls (one inside the other's time
    # would count once), the virtual circuit
    ("port.cutter", 0.00, 0.04),
    ("port.cut", 0.04, 0.06),
    ("port.cut", 0.06, 0.10),
    ("port.virtual_circuit", 0.12, 0.18),
    ("port.build", 0.20, 0.30),
    ("port.build.prefix", 0.21, 0.24),
    ("port.build.prefix", 0.25, 0.28),
    ("port.scan", 0.30, 0.45),
    ("port.rows", 0.31, 0.35),
    ("port.knit", 0.35, 0.36),
    # request 2: a cut call nested in the cutter's span; a build that
    # starts before the window ends and runs past it
    ("port.cutter", 0.50, 0.56),
    ("port.cut", 0.52, 0.54),
    ("port.virtual_circuit", 0.60, 0.64),
    ("port.build", 0.70, 0.80),
    ("port.build.prefix", 0.70, 0.80),
    ("port.scan", 0.80, 0.95),
    ("port.scan", 0.90, 0.99),   # overlaps the last
    ("port.build", 0.98, 1.20),  # past the window: 0.02 s of it inside
]

DEVICE = [("variant_rows_kernel(Params)", 0.31, 0.40),
          ("variant_rows_kernel(Params)", 0.81, 0.96)]


def _trace(host, device=DEVICE):
    return Trace(2, (0.0, 1.0), list(device), list(host), [0.2, 0.2],
                 card="NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("name,want_s", [
    ("host_build_ms", 0.10 + 0.10 + 0.02),
    ("host_prefix_ms", 0.03 + 0.03 + 0.10),
    ("scan_host_ms", 0.15 + 0.19),
    ("cut_ms", 0.10 + 0.06),
    ("virtual_circuit_ms", 0.06 + 0.04),
])
def test_span_readers_count_each_stretch_once(name, want_s):
    assert _read(name, _trace(BENCH + PORT)) == pytest.approx(
        1e3 * want_s / 2)


@pytest.mark.parametrize("name", SPANS)
def test_span_readers_read_nothing_without_their_spans(name):
    assert _read(name, _trace(BENCH)) is None
    # spans wholly outside the window are not in it
    late = [(n, s + 2.0, t + 2.0) for n, s, t in PORT]
    assert _read(name, _trace(BENCH + late)) is None


def test_port_spans_leave_the_idle_share_alone():
    plain, spanned = _trace(BENCH), _trace(BENCH + PORT)
    assert _read("idle_share", spanned) == _read("idle_share", plain)
    assert spanned.busy_s() == plain.busy_s()
    # the breakdown names the innermost span at each idle gap's middle:
    # 0-0.31 and 0.40-0.81 in a virtual circuit, 0.96-1.0 in a build
    labels = dict(spanned.breakdown()["idle_gaps"])
    assert labels == {"port.virtual_circuit": pytest.approx(0.31 + 0.41),
                      "port.build": pytest.approx(0.04)}
