"""Noise draws (``ops/streamed.make_streamed_knit``: every site's
balanced branch indices for every padded label and trajectory, numpy on
the host): the port's ``port.noise.draw`` span, host time a request, in
ms."""
from portbench.spans import span_ms


def read(trace):
    return span_ms(trace, {"port.noise.draw"})
