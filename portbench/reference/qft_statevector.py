"""The uncut statevector of ``statevector.py`` for circuits with the
controlled phase ``cp(lambda)``: each ``cp`` on ``(a, b)`` is rewritten
into gates that ``statevector.py`` knows, exactly,

    p(lambda / 2) on a, cx(a, b), p(-lambda / 2) on b, cx(a, b),
    p(lambda / 2) on b,

and the rest is ``statevector.distribution`` unedited."""
from . import statevector


def cp_gates(qubits, lam: float) -> list:
    """``cp(lam)`` on ``qubits`` as ``p`` and ``cx`` gates."""
    a, b = qubits
    return [("p", (a,), (lam / 2,)), ("cx", (a, b), ()),
            ("p", (b,), (-lam / 2,)), ("cx", (a, b), ()),
            ("p", (b,), (lam / 2,))]


def rewrite(gates) -> list:
    """The gate list with every ``cp`` rewritten (:func:`cp_gates`)."""
    out = []
    for name, qubits, params in gates:
        if name == "cp":
            out.extend(cp_gates(qubits, params[0]))
        else:
            out.append((name, qubits, params))
    return out


def distribution(instance, keep=None, device="cpu"):
    """``statevector.distribution`` of the rewritten instance."""
    return statevector.distribution(
        dict(instance, gates=rewrite(instance["gates"])), keep, device)
