"""Kernel 4's rows folded (``ops/streamed._fragment_rows``' blocked
route: each chunk's ``[chunk, 2^n]`` rows marginalised onto the written
clbits, then the ancillas folded with the labels' weights and the
clbits not kept summed out): the device time of the kernels and copies
launched inside the port's ``port.blocked.fold`` block, per request, in
ms.  The block is a user annotation, whose device-side copy runs from
the first of its kernels to the last; on the port's one stream nothing
else runs between them, so the device operations inside a copy are the
block's own.  The block's host time is not read: the host waits there
for kernel 4's launch queue, which is not the fold's work."""
import bisect

NAME = "port.blocked.fold"
SLACK_S = 1e-7   # the profiler's clock is read in microseconds


def read(trace):
    marks = sorted((s, t) for name, s, t in trace.device if name == NAME)
    if not marks:
        return None
    starts = [s for s, _ in marks]
    total = 0.0
    for name, s, t in trace.device:
        if name == NAME:
            continue
        i = bisect.bisect_right(starts, s + SLACK_S) - 1
        if i >= 0 and t <= marks[i][1] + SLACK_S:
            total += t - s
    return 1e3 * total / trace.requests
