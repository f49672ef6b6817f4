"""The sampled engine's scan (``ops/qpd_sampling._scan_core``'s block
loop: each block's rows of every fragment and its weighted knit into
the accumulators): the port's ``port.sample.scan`` span, the host's time
issuing the scan a request, waits for the card included, in ms."""
from portbench.spans import span_ms


def read(trace):
    return span_ms(trace, {"port.sample.scan"})
