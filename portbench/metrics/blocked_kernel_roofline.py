"""Kernel 4's share of its roofline, in %: the least work the traced
requests need (``portbench/roofline.py``, the count kernel 1's share
uses: from the cut fragments and the label grid, at the card's peaks)
over the device time of kernel 4's launches.  Records in
``trace.notes``: which of the two peaks bounds the work, the port's
counters of kernel 4 (process totals, warm-up included), and the rate
of kernel 4's own traffic, the bytes its segment plans move
(``blocked_kernel.work_counts`` of every suffix segment of every chunk
of the traced requests; the prefix's few passes left out) over its
time.  The plans are rebuilt here, on the host, after the window: from
the traced requests' instances (the inputs of ``trace.fragments``) at
the window, pinned bits and chunk of the port's last kernel-4 chunk of
each width (``blocked_rows.last``)."""
import importlib
import inspect

from portbench import roofline
from portbench.cell import PORT
from portbench.metrics.blocked_kernel_ms import matches


def _virtual_circuits(trace):
    """The traced requests' virtual circuits, cut anew from the instances
    ``trace.fragments`` cuts (None where it does not show them)."""
    inputs = inspect.getclosurevars(trace.fragments).nonlocals
    try:
        port, cell = inputs["port"], inputs["cell"]
        insts = [inputs["pool"][i] for i in inputs["win"]["sent"]]
    except (KeyError, TypeError):
        return None
    return [port.front_end(cell, inst) for inst in insts]


def _traffic(virts, last):
    """Bytes kernel 4's segment plans move for ``virts``' fragments that
    it ran (``last``: width -> window, pinned bits, chunk); None where a
    blocked fragment's width has no chunk on record."""
    bk = importlib.import_module(f"{PORT}.ops.blocked_kernel")
    total = 0
    for virt in virts:
        labels = 1
        for vg in virt.vgates:
            labels *= vg.num_instantiations
        for reg in virt.fragments:
            n = virt.programs[reg.name].num_sim_qubits
            if n <= bk.MAX_QUBITS:
                continue
            if n not in last:
                return None
            window, pinned, chunk = last[n]
            plan = bk.build_plan(virt, reg.name, window, pinned)
            total += -(-labels // chunk) * sum(
                bk.work_counts(plan, k, chunk)["bytes"]
                for k in range(len(plan.segments)))
    return total


def read(trace):
    seconds, launches = trace.device_time(matches)
    if not launches or trace.fragments is None:
        return None
    flops = nbytes = 0
    for f in trace.fragments():
        fl, b = roofline.count(f)
        flops, nbytes = flops + fl, nbytes + b
    bound = roofline.bound_s(flops, nbytes, trace.card)
    if bound is None:
        return None
    rows = getattr(importlib.import_module(f"{PORT}.ops.blocked_kernel"),
                   "blocked_rows", None)
    note = {"bound_by": bound[1], "flops": flops, "bytes": nbytes,
            "bound_s": bound[0], "kernel_s": seconds, "launches": launches,
            "counters": {"launches": getattr(rows, "launches", None),
                         "rows": getattr(rows, "rows", None)}}
    last = getattr(rows, "last", None)
    virts = _virtual_circuits(trace)
    traffic = None if not last or virts is None else _traffic(virts, last)
    if traffic is not None:
        note["last_chunk"] = {str(n): list(v) for n, v in last.items()}
        note["traffic_bytes"] = traffic
        note["traffic_bytes_per_s"] = traffic / seconds
    trace.notes["blocked_kernel_roofline"] = note
    return 100.0 * bound[0] / seconds
