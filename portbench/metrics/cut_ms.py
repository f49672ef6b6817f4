"""Front end, the cut (``cutter/cutter.Cutter``: its construction, then
``use_plan`` or ``solve``, and ``getResultCircs``): the port's
``port.cutter`` and ``port.cut`` spans, host time a request, in ms."""
from portbench.spans import span_ms


def read(trace):
    return span_ms(trace, {"port.cutter", "port.cut"})
