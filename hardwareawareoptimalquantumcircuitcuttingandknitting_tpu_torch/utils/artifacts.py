"""Per-run artifact directory management.

Mirrors the reference's benchmark artifact layout
(benchmarks/benchmark.py:31-37,75-88): a run directory named
``<circ>_<n>_<depth>_<P>_<Q>_<timestamp>`` holding ``run.log``, circuit
renders, instantiations, plus (new here) the serialized cut plan and a
metrics JSON — the checkpoint/resume surface the reference lacks (SURVEY §5).

Port of the JAX package's ``utils/artifacts.py``.  The DAG render draws
with matplotlib directly, on the compiler's DAG and its topological
generations (``models/graphs.py``), where the JAX package calls
networkx's drawing functions.
"""
from __future__ import annotations

import datetime
import json
import pathlib

from ..circuit.circuit import Circuit


def make_run_dir(base: str, tag: str) -> pathlib.Path:
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    path = pathlib.Path(base) / f"{tag}_{stamp}"
    n = 1
    while path.exists():  # same-second runs get a numeric suffix
        path = pathlib.Path(base) / f"{tag}_{stamp}-{n}"
        n += 1
    (path / "instantiations").mkdir(parents=True, exist_ok=True)
    return path


def save_circuit(circ: Circuit, directory, name: str) -> None:
    p = pathlib.Path(directory) / f"{name}.txt"
    with open(p, "w") as f:
        f.write(circ.draw())
        f.write("\n")


def save_metrics(directory, metrics: dict) -> None:
    with open(pathlib.Path(directory) / "metrics.json", "w") as f:
        json.dump(metrics, f, indent=2, default=str)


def save_circuit_png(circ: Circuit, directory, name: str) -> bool:
    """Matplotlib gate-grid render of a circuit, one PNG per call.

    The reference saves mpl circuit drawings for every pipeline stage and
    instantiation (Utilities.py:32-33, benchmark.py:75-88); the text draw
    (:func:`save_circuit`) stays the canonical artifact here, and this
    renderer is the optional visual twin (CLI ``--png``).  Returns False
    when matplotlib is unavailable.
    """
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # matplotlib genuinely optional
        return False

    n = circ.num_qubits
    # greedy moment packing: an op lands in the first column where every
    # wire in its vertical span is free (2q links draw a vertical line, so
    # the whole span must be clear, like the text draw)
    busy_until = [0] * n
    placed = []  # (col, instr)
    for ins in circ.instructions:
        if not ins.qubits:
            continue
        lo, hi = min(ins.qubits), max(ins.qubits)
        col = max(busy_until[q] for q in range(lo, hi + 1))
        placed.append((col, ins))
        for q in range(lo, hi + 1):
            busy_until[q] = col + 1
    n_cols = max((c for c, _ in placed), default=0) + 1

    # Agg refuses images beyond 2^16 px per side; at dpi=110 that is
    # ~595 in — clamp (a squeezed render beats an aborted pipeline)
    fig_w = min(max(3.0, 0.55 * n_cols + 1.6), 550.0)
    fig_h = min(max(1.6, 0.5 * n + 0.6), 550.0)
    fig, ax = plt.subplots(figsize=(fig_w, fig_h))
    for q in range(n):
        ax.plot([-0.7, n_cols - 0.3], [q, q], color="0.55", lw=1, zorder=0)
        ax.text(-0.85, q, f"q{q}", ha="right", va="center", fontsize=8)

    box = dict(boxstyle="round,pad=0.25", fc="white", ec="black", lw=0.9)
    vbox = dict(boxstyle="round,pad=0.25", fc="#fff3d6", ec="#c06000",
                lw=1.1, ls="--")
    for col, ins in placed:
        qs = ins.qubits
        label = ins.name
        if ins.params:
            label += "(" + ",".join(f"{p:.3g}" for p in ins.params) + ")"
        if ins.name == "barrier":
            ax.plot([col, col], [min(qs) - 0.4, max(qs) + 0.4],
                    color="0.4", lw=1, ls=":")
            continue
        if ins.name == "measure":
            ax.text(col, qs[0], f"M→c{ins.clbits[0]}", ha="center",
                    va="center", fontsize=7, bbox=box, zorder=3)
            continue
        if ins.name == "vgate" and len(qs) == 2:
            ax.plot([col, col], [qs[0], qs[1]], color="#c06000", lw=1.2,
                    ls="--", zorder=1)
            base = getattr(ins.op, "base_name", "v?")
            for q in qs:
                ax.text(col, q, f"v[{base}]", ha="center", va="center",
                        fontsize=7, bbox=vbox, zorder=3)
            continue
        if len(qs) == 2 and ins.name in ("cx", "cy", "cz", "cp", "rzz",
                                          "swap"):
            ax.plot([col, col], [qs[0], qs[1]], color="black", lw=1.2,
                    zorder=1)
            if ins.name == "cx":
                ax.plot(col, qs[0], "ko", ms=5, zorder=3)
                ax.plot(col, qs[1], "o", ms=9, mfc="white", mec="black",
                        zorder=3)
                ax.text(col, qs[1], "+", ha="center", va="center",
                        fontsize=9, zorder=4)
            elif ins.name == "cz":
                for q in qs:
                    ax.plot(col, q, "ko", ms=5, zorder=3)
            elif ins.name == "swap":
                for q in qs:
                    ax.text(col, q, "x", ha="center", va="center",
                            fontsize=10, zorder=3)
            else:
                ax.plot(col, qs[0], "ko", ms=5, zorder=3)
                ax.text(col, qs[1], label, ha="center", va="center",
                        fontsize=7, bbox=box, zorder=3)
            continue
        for q in qs:  # generic 1q (or unknown) boxes
            txt = label
            if ins.condition is not None:
                txt += f" if c{ins.condition[0]}={ins.condition[1]}"
            ax.text(col, q, txt, ha="center", va="center", fontsize=7,
                    bbox=box, zorder=3)

    ax.set_xlim(-1.4, n_cols)
    ax.set_ylim(n - 0.5, -0.5)  # qubit 0 on top, like the text draw
    ax.axis("off")
    ax.set_title(name, fontsize=9)
    try:
        fig.tight_layout()
        fig.savefig(pathlib.Path(directory) / f"{name}.png", dpi=110)
    except (ValueError, OSError):
        # rendering is best-effort (same contract as the matplotlib-less
        # path): never abort the pipeline over an unrenderable figure
        return False
    finally:
        plt.close(fig)
    return True


def save_dag_png(circ: Circuit, directory, name: str) -> bool:
    """Matplotlib render of the instruction DAG (reference's
    showCircuitsAndDags draws dag figures, Utilities.py:22-29).

    Nodes are laid out by topological generation (x) and mean qubit (y);
    edges are qubit-adjacency from the compiler DAG IR.  Returns False if
    matplotlib is unavailable.
    """
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    from ..compiler.dag import DAG
    from ..models.graphs import topological_generations

    dag = DAG(circ)
    pos = {}
    for gen_x, generation in enumerate(topological_generations(dag)):
        # spread nodes of one generation by their mean qubit index; nodes
        # that tie on it get a small x offset so they never render on top
        # of each other
        seen_y: dict[float, int] = {}
        for node in sorted(
            generation,
            key=lambda n: sum(dag.get_node_instr(n).qubits or [0]),
        ):
            ins = dag.get_node_instr(node)
            y = (
                sum(ins.qubits) / len(ins.qubits) if ins.qubits else 0.0
            )
            dup = seen_y.get(y, 0)
            seen_y[y] = dup + 1
            pos[node] = (gen_x + 0.25 * dup, -y)

    labels = {}
    colors = []
    for node in dag.nodes:
        ins = dag.get_node_instr(node)
        lab = ins.name
        if ins.name == "measure":
            lab = f"M c{ins.clbits[0]}"
        elif ins.name == "vgate":
            lab = f"v[{getattr(ins.op, 'base_name', '?')}]"
        labels[node] = f"{lab}\nq{','.join(map(str, ins.qubits))}"
        colors.append(
            "#fff3d6" if ins.name == "vgate"
            else "#e8eef9" if ins.name == "measure"
            else "white"
        )

    n_nodes = max(1, len(pos))
    fig, ax = plt.subplots(
        figsize=(max(3.5, 1.1 * (max(x for x, _ in pos.values()) + 1)),
                 max(2.5, 0.55 * circ.num_qubits + 1))
        if pos else (3.5, 2.5)
    )
    for u, v in dag.edges():
        ax.annotate("", xy=pos[v], xytext=pos[u], zorder=1,
                    arrowprops=dict(arrowstyle="-|>", color="0.6",
                                    mutation_scale=8, shrinkA=15,
                                    shrinkB=15))
    nodes = list(dag.nodes)
    ax.scatter([pos[n][0] for n in nodes], [pos[n][1] for n in nodes],
               s=900, c=colors, edgecolors="black", linewidths=0.8,
               zorder=2)
    for n in nodes:
        ax.text(pos[n][0], pos[n][1], labels[n], ha="center", va="center",
                fontsize=6, zorder=3)
    ax.set_title(f"{name} (dag, {n_nodes} nodes)", fontsize=9)
    ax.axis("off")
    try:
        fig.tight_layout()
        fig.savefig(pathlib.Path(directory) / f"{name}.png", dpi=110)
    except (ValueError, OSError):
        return False
    finally:
        plt.close(fig)
    return True
