"""Kernel 4's host build (``ops/blocked_kernel.device_plan`` on a cache
miss: the segment plan, its tables, the uploads and the prefix
launches): the port's ``port.blocked.build`` span, host time a request,
in ms."""
from portbench.spans import span_ms


def read(trace):
    return span_ms(trace, {"port.blocked.build"})
