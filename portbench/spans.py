"""The port's own spans in a traced slice (``utils/profiling.span`` in
the port: host-only events on the profiler's clock, named ``port.*``).
A reader that finds none of its spans, as in a port that has none,
returns nothing."""


def span_ms(trace, names) -> float | None:
    """Host time inside any of the spans ``names``, in ms a request: the
    union of their events' intervals inside the window, so that a nested
    or repeated span counts once; None where the window holds none."""
    lo, hi = trace.window
    spans = sorted((max(s, lo), min(t, hi)) for name, s, t in trace.host
                   if name in names and t >= lo and s <= hi)
    if not spans:
        return None
    total, end = 0.0, lo
    for s, t in spans:
        if t > end:
            total += t - max(s, end)
            end = t
    return 1e3 * total / trace.requests
