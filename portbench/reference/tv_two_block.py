"""The comparison ``tv_two_block``: half the L1 distance between the
port's distribution (``entries/distribution.py``'s answer) and the
exact distribution of the same instance from the two-block simulation
(``two_block.py``, split at the configuration's ``boundary``); the run
reads the worst over the answers compared."""
import numpy as np
import torch

from .two_block import distribution


def compare(cell, instance, answer, device="cpu") -> float:
    """The total variation; ``inf`` where the answer covers other
    clbits or another number of outcomes."""
    ref, clbits = distribution(instance, cell.config.get("keep_clbits"),
                               cell.config.get("boundary"), device)
    values = np.asarray(answer["values"])
    if list(answer["bit_positions"]) != clbits or \
            values.shape != (ref.numel(),):
        return float("inf")
    got = torch.as_tensor(values, device=device).to(torch.float64)
    return float(0.5 * (got - ref).abs().sum())
