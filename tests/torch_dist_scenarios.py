"""What each rank of a ``gloo`` world runs for tests/test_torch_sharded_dist.py.

JAX-free: imports only torch, numpy and the port.  Circuits arrive as
``convert.circuit_to_instructions`` tuples in the payload (the parent
builds and cuts them with the JAX package).  Every entry point runs
with ``device="cpu"``.  A result is gathered from every rank
(:func:`_every_rank`) where the test checks that all ranks hold the
same answer.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_from_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    sharded_fragment,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.qpd_sampling import (  # noqa: E501
    sampled_expectation_z,
    sampled_knit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.sharded_fragment import (  # noqa: E501
    run_all_fragments_sharded,
    run_fragment_sharded,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.sharded_sv import (  # noqa: E501
    sharded_probabilities,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    compile_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
    make_streamed_knit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.parallel.mesh import (  # noqa: E501
    Mesh,
    make_mesh,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.parallel.sharded import (  # noqa: E501
    make_sharded_step,
    run_virtual_circuit_sharded,
    streamed_values_dp,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.utils import (  # noqa: E501
    checkpoint,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit,
)

CPU = "cpu"


def _virt(instructions) -> VirtualCircuit:
    return VirtualCircuit(circuit_from_instructions(*instructions))


def _every_rank(values) -> np.ndarray:
    """``[world, ...]``: every rank's copy of ``values``."""
    t = torch.as_tensor(np.asarray(values, np.float32)).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).numpy()


def world4(rank, size, payload) -> dict:
    """4 ranks: ShardCtx on an amp-only mesh (1 x 4), a fragment on dp=2
    x amp=2 (f32 and bf16), the sharded engine through
    ``run_virtual_circuit``, a mesh that leaves ranks out, and the knit
    step on dp=2 x tp=2."""
    out = {}
    amp4 = Mesh(np.arange(4), ("amp",), device=CPU)
    for name, ins in payload["sv"].items():
        circ = circuit_from_instructions(*ins)
        got = sharded_probabilities(compile_circuit(circ), amp4)
        out[f"sv_{name}"] = _every_rank(got.values)
        out[f"sv_{name}_pos"] = np.asarray(got.bit_positions)

    frag = _virt(payload["frag"])
    m22 = Mesh(np.arange(4).reshape(2, 2), ("dp", "amp"), device=CPU)
    res = run_fragment_sharded(frag, "frag0", m22)
    out["frag22"] = _every_rank(res.values.numpy())
    out["frag22_pos"] = np.asarray(res.bit_positions)
    out["frag22_touch"] = np.asarray(res.touching)
    b16 = run_fragment_sharded(frag, "frag0", m22, dtype=torch.bfloat16)
    out["frag22_bf16"] = b16.values.numpy()

    chain = _virt(payload["chain8"])
    biggest = max(p.num_sim_qubits for p in chain.programs.values())
    dist_, _ = run_virtual_circuit(chain, engine="sharded",
                                   max_local_qubits=biggest - 2,
                                   project=False, device=CPU)
    out["e2e"] = _every_rank(dist_.values)
    out["e2e_pos"] = np.asarray(dist_.bit_positions)
    out["e2e_biggest"] = np.asarray(biggest)

    # the largest power of two of ranks 0..2 is ranks 0 and 1: ranks 2
    # and 3 are outside the mesh and receive the rows
    for res in run_all_fragments_sharded(chain, devices=[0, 1, 2],
                                         device=CPU):
        out[f"left_out_{res.name}"] = _every_rank(res.values.numpy())

    knit22 = run_virtual_circuit_sharded(chain, make_mesh(4, tp=2,
                                                          device=CPU))
    out["step22"] = _every_rank(knit22.values)
    return out


def world2(rank, size, payload) -> dict:
    """2 ranks: the dp-sharded sampled scan, the streamed scan's chunks
    over dp (banks off and on, and the kernel route's plain versions),
    the knit step at dp=2, the sharded engine's default (2 x 1) meshes,
    and its checkpoints (:func:`_checkpoints`)."""
    out = {}
    mesh = make_mesh(2, device=CPU)
    qft = _virt(payload["qft7"])
    kw = payload["sampled_kw"]
    est, se = sampled_knit(qft, keep_clbits={0, 1}, with_stderr=True,
                           method="lhs", control_variate=True, mesh=mesh,
                           device=CPU, **kw)
    out["sampled"] = _every_rank(est.values)
    out["sampled_se"] = np.asarray(se)
    out["sampled_z"] = np.asarray(sampled_expectation_z(
        qft, [{0}, {0, 1, 2}], mesh=mesh, device=CPU, **kw))

    chain6 = _virt(payload["chain6"])
    for key, kw in (("streamed", {}), ("streamed_share",
                                       {"share_prefix": True}),
                    ("streamed_kernel", {"pallas_variant": True})):
        _step, xs, meta = make_streamed_knit(chain6, chunk=8, device=CPU,
                                             **kw)
        out[key] = _every_rank(streamed_values_dp(meta, xs, mesh).numpy())
        out[key + "_splits"] = np.asarray(
            sum(s is not None for s in meta["splits"]))
        out[key + "_chunks"] = np.asarray(meta["n_chunks"])

    step, args, _pos = make_sharded_step(chain6, mesh)
    out["step2"] = _every_rank(step(*args).numpy())

    chain = _virt(payload["chain8"])
    dist_, _ = run_virtual_circuit(chain, engine="sharded", project=False,
                                   device=CPU)
    out["e2e_dp2"] = _every_rank(dist_.values)
    out.update(_checkpoints(rank, chain, payload["checkpoint_dir"]))
    return out


def _checkpoints(rank, chain, directory) -> dict:
    """``engine="sharded"`` with ``checkpoint_dir``, three calls: the
    first simulates and rank 0 writes the checkpoint a second late (the
    other rank reaches the next call first); the second resumes on every
    rank; in the third, rank 1 cannot read the checkpoint, so every rank
    simulates again.  ``ckpt_simulated``: the calls that simulated, on
    each rank."""
    real_save = checkpoint.save_fragment_results
    real_load = checkpoint.load_fragment_results
    real_run = sharded_fragment.run_all_fragments_sharded
    simulated = []

    def late_save(*args, **kw):
        time.sleep(1.0)
        return real_save(*args, **kw)

    def counted_run(*args, **kw):
        simulated.append(1)
        return real_run(*args, **kw)

    checkpoint.save_fragment_results = late_save
    sharded_fragment.run_all_fragments_sharded = counted_run
    values, counts = [], []
    try:
        # no collective of this test's own between the calls: it would
        # hold the ranks together where only the engine should
        for call in range(3):
            if call == 2 and rank == 1:
                checkpoint.load_fragment_results = lambda *a, **kw: None
            got, _ = run_virtual_circuit(chain, engine="sharded",
                                         project=False,
                                         checkpoint_dir=directory,
                                         device=CPU)
            values.append(got.values)
            counts.append(len(simulated))
    finally:
        checkpoint.save_fragment_results = real_save
        checkpoint.load_fragment_results = real_load
        sharded_fragment.run_all_fragments_sharded = real_run
    out = {f"ckpt_{call}": _every_rank(v) for call, v in enumerate(values)}
    out["ckpt_simulated"] = _every_rank(counts)
    return out
