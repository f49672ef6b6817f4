"""Host build (``ops/streamed.make_streamed_knit``: label tables, each
fragment's kernel plan with its host prefix, the uploads): the port's
``port.build`` span, host time a request, in ms."""
from portbench.spans import span_ms


def read(trace):
    return span_ms(trace, {"port.build"})
