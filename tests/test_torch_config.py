"""The port's typed pipeline config (``utils/config.py``) against the JAX
package's: JAX's ``to_json`` text loads into the port and writes back
unchanged, and ``make_cutter`` applies the same cost model."""
import dataclasses

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.utils import (
    config as j_config,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.utils import (  # noqa: E501
    config as t_config,
)
from torch_port_common import to_port


def _configs(mod):
    return [
        mod.PipelineConfig(),
        mod.PipelineConfig(
            mod.CutterConfig(
                max_n_partitions=3, max_n_qubits_per_partition=[4, 5, 6],
                force_n_wire_cuts=1,
                cost_model=mod.CostModel(wire_qpd_overhead=16,
                                         tele_latency=7)),
            mod.ExecutionConfig(shots=500, engine="streamed", seed=9),
            cut_only=True, results_dir="/tmp/x"),
    ]


def test_jax_json_round_trips_through_the_port():
    for jcfg, tcfg in zip(_configs(j_config), _configs(t_config)):
        text = jcfg.to_json()
        back = t_config.PipelineConfig.from_json(text)
        assert back == tcfg
        assert back.to_json() == text
        assert dataclasses.asdict(back) == dataclasses.asdict(jcfg)
    assert t_config.ExecutionConfig().engine == "auto"


def test_make_cutter_applies_cost_model():
    circ = JCircuit(3, 3)
    circ.cx(0, 1)
    circ.cx(1, 2)
    kw = dict(max_n_partitions=2, max_n_qubits_per_partition=2)
    jc = j_config.make_cutter(circ, j_config.CutterConfig(
        cost_model=j_config.CostModel(gate_qpd_overhead=11,
                                      wire_qpd_overhead=13), **kw))
    tc = t_config.make_cutter(to_port(circ), t_config.CutterConfig(
        cost_model=t_config.CostModel(gate_qpd_overhead=11,
                                      wire_qpd_overhead=13), **kw))
    assert tc.cfg.gate_qpd_cost == jc.cfg.gate_qpd_cost
    assert tc.cfg.wire_qpd_cost == jc.cfg.wire_qpd_cost
    assert tc.cfg.gate_qpd_cost[0] == 11 and tc.cfg.wire_qpd_cost[0] == 13
    assert not tc.cfg.has_default_costs()


def test_run_directory_artifacts_match_jax(tmp_path, monkeypatch):
    """The benchmark CLI's flow in the port: a JAX ``PipelineConfig``
    text -> ``make_cutter`` -> cut -> ``make_run_dir`` / ``save_circuit``
    / ``save_metrics`` write what the JAX package writes; the PNG
    renders (the DAG one drawn without networkx) write real files, and
    without matplotlib both return False."""
    import sys

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
        genCirc,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.utils import (  # noqa: E501
        artifacts as j_art,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.utils import (  # noqa: E501
        artifacts as t_art,
    )

    text = j_config.PipelineConfig(j_config.CutterConfig(
        max_n_qubits_per_partition=3)).to_json()
    cfg = t_config.PipelineConfig.from_json(text)
    circ = genCirc("ghz", 5, 1)
    jc = j_config.make_cutter(circ, j_config.PipelineConfig.from_json(
        text).cutter)
    tc = t_config.make_cutter(to_port(circ), cfg.cutter)
    assert jc.solve() and tc.solve()
    jcut, tcut = jc.getResultCircs()[3], tc.getResultCircs()[3]
    jdir = j_art.make_run_dir(str(tmp_path / "jax"), "ghz_5_1_2_3")
    tdir = t_art.make_run_dir(str(tmp_path / "port"), "ghz_5_1_2_3")
    assert (tdir / "instantiations").is_dir()
    assert t_art.make_run_dir(str(tmp_path / "port"), "ghz_5_1_2_3") != tdir
    for art, d, cut in ((j_art, jdir, jcut), (t_art, tdir, tcut)):
        art.save_circuit(cut, d, "cut")
        art.save_metrics(d, {"fidelity": 1.0, "cuts": 1, "cfg": cfg})
    for name in ("cut.txt", "metrics.json"):
        assert (tdir / name).read_text() == (jdir / name).read_text()
    assert t_art.save_circuit_png(tcut, tdir, "cut")
    assert t_art.save_dag_png(to_port(circ), tdir, "dag")
    for name in ("cut.png", "dag.png"):
        assert (tdir / name).stat().st_size > 2000
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not t_art.save_circuit_png(tcut, tdir, "none")
    assert not t_art.save_dag_png(tcut, tdir, "none")
