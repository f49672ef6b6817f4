"""Noisy rows (``ops/streamed._SimRows.noisy_rows``: each chunk's
(label, trajectory) rows with their sites' branches gathered, the mean
over trajectories and the readout channel): the port's
``port.noise.rows`` span, the host's time issuing them a request, waits
for the card included, in ms.  Records in ``trace.notes`` the port's
counters of that function, the rows simulated and the active sites
applied to them, as totals of the process (warm-up included), with the
sites a row."""
import importlib

from portbench.cell import PORT
from portbench.spans import span_ms


def read(trace):
    value = span_ms(trace, {"port.noise.rows"})
    sim = getattr(importlib.import_module(f"{PORT}.ops.streamed"),
                  "_SimRows", None)
    fn = getattr(sim, "noisy_rows", None)
    rows = getattr(fn, "rows", None)
    if value is not None and rows:
        trace.notes["noisy_rows"] = {
            "rows": rows, "site_passes": fn.site_passes,
            "sites_a_row": fn.site_passes / rows}
    return value
