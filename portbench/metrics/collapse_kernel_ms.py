"""Kernel 3 (``csrc/collapse_kernel.cu``, ``collapse_rows_kernel``):
device time per request from the profiler, in ms."""


def matches(name: str) -> bool:
    return "collapse_rows_kernel" in name


def read(trace):
    seconds, launches = trace.device_time(matches)
    if not launches:
        return None
    return 1e3 * seconds / trace.requests
