"""A Monte-Carlo estimate with its error bar: ``run_virtual_circuit``
with the configuration's ``run`` options (``engine="sampled"``) on its
``keep_clbits``.  Each request samples with a seed of its own, drawn
from the instance it serves and from how often this process has served
that instance before: a run's seed gives its instances, so the seeds
follow the run's, and a repeated instance draws new labels.  The answer
carries the per-outcome standard error that the port returns in
``RunTimeInfo.stderr``, and with ``sample_probe`` the trajectory rows of
``RunTimeInfo.probe``.  A port that returns no standard error, or no
rows where they are asked for, fails the request."""
import collections
import hashlib

import numpy as np

_SERVED = collections.Counter()


def _instance_key(virt) -> bytes:
    """A digest of the cut circuit's gate matrices, fragment by
    fragment: equal for equal instances, apart for others."""
    h = hashlib.blake2b(digest_size=16)
    for reg in virt.fragments:
        for op in virt.programs[reg.name].ops:
            if op[0] == "u":
                h.update(np.ascontiguousarray(op[1]).tobytes())
                h.update(repr(op[2]).encode())
    return h.digest()


def sampling_seed(virt) -> int:
    """The request's sampling seed, below 2^31."""
    key = _instance_key(virt)
    n = _SERVED[key]
    _SERVED[key] += 1
    words = np.frombuffer(key, np.uint32).tolist() + [n]
    return int(np.random.SeedSequence(words).generate_state(1)[0] >> 1)


def answer(port, cell, virt, device, run_kw) -> dict:
    seed = sampling_seed(virt)
    dist, info = port.run_virtual_circuit(
        virt, device=device, keep_clbits=cell.config.get("keep_clbits"),
        seed=seed, **run_kw)
    stderr = getattr(info, "stderr", None)
    if stderr is None:
        raise RuntimeError("the sampled engine returned no standard error "
                           "(RunTimeInfo.stderr)")
    probe = getattr(info, "probe", None)
    if run_kw.get("sample_probe") and probe is None:
        raise RuntimeError("the sampled engine returned no trajectory rows "
                           "(RunTimeInfo.probe)")
    return {"values": np.asarray(dist.values),
            "bit_positions": list(dist.bit_positions),
            "stderr": np.asarray(stderr), "seed": seed, "probe": probe}
