"""A noisy run on a calibrated device: the port's
``ops.noise.run_noisy_virtual_circuit`` with the configuration's device
model (``noise``: the model's name, calibration seed, relaxation and
trajectories a label) and ``run`` options (``engine="streamed"``).  Each
request draws its noise with a seed of its own, from the instance it
serves and from how often this process has served that instance, as
``entries/sampled.py`` draws its sampling seed.  The answer carries the
port's record of its noise, ``RunTimeInfo.noise`` (the routed op
streams and the branch indices drawn), for the replay to hold the
answer to; a port whose ``RunTimeInfo`` has no such record fails the
request before it runs."""
import collections
import dataclasses
import importlib

import numpy as np

from portbench.cell import PORT
from portbench.entries.sampled import _instance_key

_SERVED = collections.Counter()


def noise_seed(virt) -> int:
    """The request's noise seed, below 2^31."""
    key = _instance_key(virt)
    n = _SERVED[key]
    _SERVED[key] += 1
    words = np.frombuffer(key, np.uint32).tolist() + [n]
    return int(np.random.SeedSequence(words).generate_state(1)[0] >> 1)


def model(cell):
    """The port's device model that the configuration names."""
    cfg = cell.config["noise"]
    noise = importlib.import_module(f"{PORT}.ops.noise")
    nm = getattr(noise, cfg["model"])(seed=cfg["calibration_seed"],
                                      relaxation=cfg["relaxation"])
    return dataclasses.replace(nm, trajectories=cfg["trajectories"])


def answer(port, cell, virt, device, run_kw) -> dict:
    info_cls = importlib.import_module(f"{PORT}.run").RunTimeInfo
    if "noise" not in {f.name for f in dataclasses.fields(info_cls)}:
        raise RuntimeError("the port's RunTimeInfo has no noise record")
    noise = importlib.import_module(f"{PORT}.ops.noise")
    seed = noise_seed(virt)
    dist, info = noise.run_noisy_virtual_circuit(
        virt, model(cell), seed=seed, device=device, **run_kw)
    if info.noise is None:
        raise RuntimeError("the noisy run returned no noise record "
                           "(RunTimeInfo.noise)")
    return {"values": np.asarray(dist.values),
            "bit_positions": list(dist.bit_positions), "seed": seed,
            "noise": info.noise}
