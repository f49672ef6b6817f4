"""Spawn a ``torch.distributed`` world of CPU processes for the port's
sharded engine tests.

JAX-free: it imports only the standard library, numpy and (in the
children) torch and the port, so it runs wherever the port does.  A
world is ``n`` processes on one ``gloo`` group, initialised from a
``file://`` store in the caller's directory (no TCP ports, so parallel
test workers cannot collide).  Each rank imports ``module`` (a module
beside this file, or on the repo root) and calls ``module.fn(rank,
world, payload)``; rank 0's returned dict of arrays is saved as an
``.npz``.  The world has a hard time limit: when it runs out, or a rank
fails, every rank is killed, so no rank is left blocked in a receive.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
TESTS = pathlib.Path(__file__).resolve().parent

_CHILD = """
import os, pickle, sys
sys.path[:0] = [{root!r}, {tests!r}]
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, size = int(sys.argv[1]), int(sys.argv[2])
out_dir = {out_dir!r}
dist.init_process_group("gloo", init_method="file://" + out_dir + "/store",
                        rank=rank, world_size=size)
with open(out_dir + "/payload.pkl", "rb") as fh:
    payload = pickle.load(fh)
mod = __import__({module!r}, fromlist=[{fn!r}])
result = getattr(mod, {fn!r})(rank, size, payload)
if rank == 0:
    np.savez(out_dir + "/result.npz", **result)
dist.barrier()
# the world ends here: leave without tearing the process groups down
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


class WorldFailed(AssertionError):
    """A world that timed out or had a rank fail; quotes every rank."""


def spawn_world(n: int, module: str, fn: str, out_dir, payload=None,
                timeout: float = 120.0) -> dict:
    """Run ``module.fn(rank, n, payload)`` on ``n`` ranks of a ``gloo``
    world and return rank 0's result (a dict of numpy arrays).  Raises
    :class:`WorldFailed` quoting each rank's exit code and stderr when a
    rank fails or the world outlives ``timeout`` seconds (every rank is
    killed then)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "payload.pkl", "wb") as fh:
        pickle.dump(payload, fh)
    code = _CHILD.format(root=str(ROOT), tests=str(TESTS),
                         out_dir=str(out_dir), module=module, fn=fn)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    logs = [open(out_dir / f"rank{r}.err", "w+") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(n)],
                              stdout=subprocess.DEVNULL, stderr=logs[r],
                              cwd=str(ROOT), env=env)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    failed = timed_out = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                failed = True
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    failed = failed or any(p.returncode != 0 for p in procs)
    if failed or timed_out:
        report = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            report.append(f"--- rank {r} (exit {p.returncode}) ---\n"
                          + log.read()[-4000:])
        for log in logs:
            log.close()
        what = f"timed out after {timeout:.0f} s" if timed_out else "failed"
        raise WorldFailed(f"{n}-rank world {module}.{fn} {what}:\n"
                          + "\n".join(report))
    for log in logs:
        log.close()
    with np.load(out_dir / "result.npz") as data:
        return {k: data[k] for k in data.files}


def probe_fail(rank, size, payload):
    """A world whose rank 1 raises (the harness's own test)."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    import torch.distributed as dist

    dist.barrier()
    return {}


def probe_hang(rank, size, payload):
    """A world whose rank 0 waits for a message nobody sends (the
    harness's own test: the time limit must kill it)."""
    import torch
    import torch.distributed as dist

    if rank == 0:
        dist.recv(torch.empty(1), src=1)
    return {}
