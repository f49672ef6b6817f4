"""Scan (``ops/streamed`` ``segment_fn``: every chunk's rows of every
fragment and its knit into the carry): the port's ``port.scan`` span,
the host's time issuing the scan a request, in ms.  Nothing in the scan
waits for the card, so this is no device time."""
from portbench.spans import span_ms


def read(trace):
    return span_ms(trace, {"port.scan"})
