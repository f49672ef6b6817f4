"""Host build, its prefix (the numpy simulation of each fragment's gates
before its first cut, in ``ops/variant_kernel.build_plan`` and the other
plan builders): the port's ``port.build.prefix`` spans, host time a
request, in ms."""
from portbench.spans import span_ms


def read(trace):
    return span_ms(trace, {"port.build.prefix"})
