"""Shared builders for the torch-port differential tests (test_torch_*.py).

Every builder makes one circuit with the JAX package and carries it into
the torch package through ``convert.circuit_to_instructions`` /
``circuit_from_instructions``, so both packages start from the same
object.  Inputs that need randomness come from numpy with a fixed seed.
"""
from __future__ import annotations

import math

import numpy as np

import hardwareawareoptimalquantumcircuitcuttingandknitting_tpu as jpkg  # noqa: F401
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
    Instruction as JInstruction,
    Register as JRegister,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_gates import (  # noqa: E501
    VirtualGateOp as JVirtualGateOp,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_from_instructions,
    circuit_to_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
import torch_threads  # noqa: F401 (torch's threads: a share of the cores)

CUT_KW = dict(maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)


def to_port(jcirc):
    """A JAX-package circuit rebuilt as a torch-package circuit."""
    return circuit_from_instructions(*circuit_to_instructions(jcirc))


def chain_cut_pair(nbig: int = 8):
    """The JAX kernel tests' two-fragment chain (tests/test_pallas_variant
    ``_chain_cut``): fixed 1q/2q gates, a measuring cz and a parametrised
    cp slot, deferral ancillas.  Returns (jax_virt, port_virt)."""
    cut = JCircuit([JRegister("frag0", nbig), JRegister("frag1", 2)],
                   nbig + 2)
    cut.h(0)
    for i in range(nbig - 1):
        cut.cx(i, i + 1)
    for q in range(nbig):
        cut.rz(0.1 * (q + 1), q)
    cut.append(JInstruction("vgate", [nbig - 1, nbig],
                            op=JVirtualGateOp("cz")))
    cut.append(JInstruction("vgate", [0, nbig],
                            op=JVirtualGateOp("cp", params=(0.7,))))
    cut.cx(nbig, nbig + 1)
    for q in range(nbig + 2):
        cut.measure(q, q)
    return JVirtualCircuit(cut), TVirtualCircuit(to_port(cut))


def cut_pair(name: str, n: int, depth: int, cap: int, seed=0, **kw):
    """genCirc + Cutter in the JAX package, the cut circuit carried into
    the torch package.  Returns (jax_circ, port_circ, jax_virt,
    port_virt)."""
    circ = j_gen_circ(name, n, depth, seed=seed)
    cutter = JCutter(circ, maxNPartitions=2, maxNQubitsPerPartition=cap,
                     **(kw or CUT_KW))
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    return (circ, to_port(circ), JVirtualCircuit(cut),
            TVirtualCircuit(to_port(cut)))


def label_table(virt, chunk: int):
    """(vidx [padded, num_vgates] int32 over the global label order, total
    labels, padded) with padding rows clamped to the last label."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.variant_engine import (  # noqa: E501
        label_strides,
        variant_index_table,
    )

    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, total = label_strides(specs, range(len(specs)))
    padded = math.ceil(total / chunk) * chunk
    vidx = variant_index_table(range(len(specs)), strides, n_inst, padded,
                               clamp_to=total)
    return vidx, total, padded


def shuffled(vidx: np.ndarray, total: int, seed: int) -> np.ndarray:
    """Rows of ``vidx`` in a seeded random order (padding rows kept last)."""
    perm = np.random.default_rng(seed).permutation(total)
    return vidx[list(perm) + list(range(total, vidx.shape[0]))]


def qft_gamma_pair(n: int = 9, cap: int = 8):
    """qft-n cut (n-1)|1 by ``Cutter(gammaMode=True)`` in the JAX package
    (qft-9: 8 cp cuts, the JAX kernel tests' ``_qft_gamma_cut``), the cut
    circuit carried into the torch package.  Returns (jax_virt,
    port_virt)."""
    cutter = JCutter(j_gen_circ("qft", n, 1), maxNPartitions=2,
                     maxNQubitsPerPartition=cap, gammaMode=True,
                     maxNQpdCuts=20, maxNCuts=20, maxCutsPerPartitions=20)
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    return JVirtualCircuit(cut), TVirtualCircuit(to_port(cut))
