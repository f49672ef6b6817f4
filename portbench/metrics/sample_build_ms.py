"""Host build of the sampled engine's scan (``ops/qpd_sampling.
_build_scan``: each fragment's kernel 3 plan, its host prefix and
tables on the card): the port's ``port.sample.build`` span, host time a
request, in ms."""
from portbench.spans import span_ms


def read(trace):
    return span_ms(trace, {"port.sample.build"})
