"""Front end, the fragments' programs (``virt/virtual_circuit.
VirtualCircuit`` of the cut circuit): the port's ``port.virtual_circuit``
span, host time a request, in ms."""
from portbench.spans import span_ms


def read(trace):
    return span_ms(trace, {"port.virtual_circuit"})
