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
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import time
from dataclasses import dataclass, field


@dataclass
class Phase:
    name: str
    seconds: float
    meta: dict = field(default_factory=dict)


def _sync(device) -> None:
    """Wait for ``device``'s queue (None = the current card), where CUDA is
    in use in this process; a CPU device has no queue."""
    import torch

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
            yield
        finally:
            _sync(self.device)
            self.phases.append(Phase(name, time.perf_counter() - t0, meta))

    def start_device_trace(self) -> None:
        """Begin a torch.profiler trace (host ops and, with a card, its
        kernels and copies)."""
        if self.profile_dir is None or self._profiling:
            return
        import torch
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
