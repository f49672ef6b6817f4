"""Label sampling (``ops/qpd_sampling``: drawing the QPD labels,
deduplicating them, and replicating each sample of a measuring label):
the port's ``port.sample.labels`` span, host time a request, in ms."""
from portbench.spans import span_ms


def read(trace):
    return span_ms(trace, {"port.sample.labels"})
