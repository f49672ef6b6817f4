"""Routing (``ops/variant_engine.make_sim_fn``'s noise branch:
``circuit/routing.route_stream`` of each noisy fragment onto the
device's coupling): the port's ``port.route`` span, host time a
request, in ms."""
from portbench.spans import span_ms


def read(trace):
    return span_ms(trace, {"port.route"})
