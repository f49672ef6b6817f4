"""Structured phase timing + torch.profiler integration.

The reference's observability is two ad-hoc wall-clock pairs
(qvm/run.py:17-20,35,60-67 and the datetime pair around solve() in
benchmark.py:43-50).  Here every pipeline phase reports into one
:class:`Tracer` that can be printed, serialized to JSON, and optionally
wrapped in a device-level ``torch.profiler`` trace (CPU and CUDA
activities, written as a Chrome trace viewable in Perfetto).

Port of the JAX package's ``utils/profiling.py``, with the same fields,
phases and report.  Device work is asynchronous: a host clock read
around launches times the launches, not the work.  So a phase of a
:class:`Tracer` waits for the run's card (``torch.cuda.synchronize(
device)``, the device ``run_virtual_circuit`` binds to the tracer)
before it starts its clock and before it reads it.  A caller that
passes no tracer gets :data:`NO_TRACER`, whose phases are empty
contexts: tracing adds no synchronise to an untraced call.

:func:`span` names a stretch of the request path on the profiler's own
clock, the clock the card's kernels are on, so a trace shows what the
host was doing while the card waited.  With ``torch.profiler`` running it
enters a function-scope record (``_RecordFunctionFast``): a host-only
event.  ``record_function`` would not do: it is a user annotation, and
with CUDA activity on the profiler gives it a device-side copy that runs
from the first to the last kernel it launched, so a span around a scan
would count the idle gaps between its launches as device work.
:func:`device_span` is that user annotation, for a stretch whose kernels
run back to back and whose device time is read as the time of the
kernels inside its device-side copy.  A span never synchronises.  With
the profiler off, ``span`` and ``device_span`` read one module flag and
return a shared null context: no record is built and no clock is read
(0.2-0.4 us a span on the host CPU of an H100 machine).
"""
from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler

# a host-only record on the profiler's clock (the type is looked up at
# each call, so a test may count its constructions)
_Record = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context naming its block ``name`` in a running ``torch.profiler``
    trace; the shared null context when no profiler runs (the flag is a
    module attribute that the profiler rebinds, so it is read through
    the module)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Record(name)


def device_span(name: str):
    """A context naming its block ``name`` with a user annotation
    (``record_function``) in a running ``torch.profiler`` trace: a host
    event and, with CUDA activity on, a device-side copy from the start
    of the first kernel the block launched to the end of its last, so a
    trace can tell the block's kernels from those launched before and
    after it.  The shared null context when no profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _autograd_profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@dataclass
class Phase:
    name: str
    seconds: float
    meta: dict = field(default_factory=dict)


def _sync(device) -> None:
    """Wait for ``device``'s queue (None = the current card), where CUDA is
    in use in this process; a CPU device has no queue."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.synchronize(dev)


@dataclass
class Tracer:
    """Collects named phase timings; optionally drives torch.profiler.

    ``traces``: the Chrome trace files written so far, one per
    :meth:`start_device_trace` / :meth:`stop_device_trace` pair, under
    ``profile_dir``.  ``device``: the device whose queue a phase waits
    for (None = the current card); ``run_virtual_circuit`` sets it to its
    own ``device``."""

    phases: list[Phase] = field(default_factory=list)
    profile_dir: str | None = None
    traces: list[str] = field(default_factory=list)
    device: object = None
    _profiling: bool = False
    _profiler: object = None

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        _sync(self.device)
        t0 = time.perf_counter()
        try:
            # and a span on the kernels' clock, inside the phase's own
            with span("port.phase." + name):
                yield
        finally:
            _sync(self.device)
            self.phases.append(Phase(name, time.perf_counter() - t0, meta))

    def start_device_trace(self) -> None:
        """Begin a torch.profiler trace (host ops and, with a card, its
        kernels and copies)."""
        if self.profile_dir is None or self._profiling:
            return
        from torch.profiler import ProfilerActivity, profile

        pathlib.Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.start()
        self._profiling = True

    def stop_device_trace(self) -> None:
        if not self._profiling:
            return
        _sync(self.device)
        self._profiler.stop()
        path = (pathlib.Path(self.profile_dir)
                / f"trace_{len(self.traces)}.json")
        self._profiler.export_chrome_trace(str(path))
        self.traces.append(str(path))
        self._profiler = None
        self._profiling = False

    def total(self, name: str | None = None) -> float:
        return sum(
            p.seconds for p in self.phases if name is None or p.name == name
        )

    def report(self) -> dict:
        return {
            "phases": [
                # meta spreads after, but never overwrites, the measured
                # fields — a meta key named "seconds" would otherwise
                # silently replace the timing in the artifact
                {
                    "name": p.name,
                    "seconds": round(p.seconds, 6),
                    **{
                        k: v for k, v in p.meta.items()
                        if k not in ("name", "seconds")
                    },
                }
                for p in self.phases
            ],
            "total_seconds": round(sum(p.seconds for p in self.phases), 6),
        }

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.report(), indent=2))

    def __str__(self) -> str:
        lines = [
            f"  {p.name:<24} {p.seconds:9.4f}s"
            + (f"  {p.meta}" if p.meta else "")
            for p in self.phases
        ]
        return "phase timings:\n" + "\n".join(lines)


class _NoTracer:
    """What an untraced call uses: every phase an empty context, no clock,
    no synchronise."""

    @staticmethod
    def phase(name: str, **meta):
        return contextlib.nullcontext()

    def start_device_trace(self) -> None:
        pass

    def stop_device_trace(self) -> None:
        pass


NO_TRACER = _NoTracer()
