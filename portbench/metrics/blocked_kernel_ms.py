"""Kernel 4 (``csrc/blocked_kernel.cu``, ``blocked_segment_kernel``):
device time per request from the profiler, in ms: every segment launch,
the rows' and the prefixes'."""


def matches(name: str) -> bool:
    return "blocked_segment_kernel" in name


def read(trace):
    seconds, launches = trace.device_time(matches)
    if not launches:
        return None
    return 1e3 * seconds / trace.requests
