"""The rest of the port's jax-free core (``core/dot.py``,
``core/placement.py``, ``core/pipeline_partition.py``) and the CLI's
``--scheduler`` and ``--scenario`` modes, against the JAX reference.

* DOT: the round-trip, cut-edge and plain-digraph cases of
  tests/test_core_graph.py, and the port's text equal to the reference's.
* Pipeline stages: the plan cases of tests/test_pipeline_placement_executor.py;
  with the reference's peak rate passed in, every plan equals the
  reference's exactly (the port's default peak is the H100's).
* Expert placement: that file's placement cases, with the dispatched bytes
  counted in numpy (the reference counts them in ``repro/models/moe.py``,
  which is jax), and every placement equal to the reference's.
* CLI: ``--scheduler`` prints the reference's ``schedule_requests`` numbers;
  ``--arena --scenario`` prints the reference's simulated rows, with
  ``affinity-steal`` beside the default policies.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_config as jget_config
from repro.core import dot as jdot
from repro.core import pipeline_partition as jpp
from repro.core import placement as jplacement
from repro.core.graph import generate_paper_dag as jgenerate_paper_dag
from repro.launch import serve as jserve
from repro.launch.mesh import PEAK_FLOPS_BF16 as TPU_PEAK
from repro.models.moe import dispatch_bytes as jdispatch_bytes
from repro_torch.configs.registry import get_config
from repro_torch.core import pipeline_partition as tpp
from repro_torch.core.dot import parse_dot, roundtrip, to_dot
from repro_torch.core.graph import TaskGraph, generate_paper_dag
from repro_torch.core.placement import place_experts, random_placement, synth_coactivation
from repro_torch.launch import serve as tserve

ROOT = pathlib.Path(__file__).resolve().parent.parent
WALL_COLUMNS = (6, 7)  # decision_ms, offline_ms in core.arena.format_table


def dispatch_bytes(idx: np.ndarray, expert_to_shard: np.ndarray, d_model: int,
                   bytes_per: int = 2) -> float:
    """``repro.models.moe.dispatch_bytes`` in numpy: one send per (token,
    destination shard)."""
    shards = expert_to_shard[idx]                                   # (T, k)
    n_shards = int(expert_to_shard.max()) + 1
    dest_any = np.zeros((idx.shape[0], n_shards), bool)
    np.put_along_axis(dest_any, shards, True, axis=1)
    return float(dest_any.sum()) * d_model * bytes_per


# -- DOT ------------------------------------------------------------------------

def _paper_dag(generate):
    g = generate("matadd", out_bytes=64)
    for k in g.nodes.values():
        k.costs = {"cpu": 2.5, "gpu": 0.5} if k.op != "source" else {}
    return g


def test_dot_roundtrip_preserves_structure():
    g = _paper_dag(generate_paper_dag)
    g2 = roundtrip(g)
    assert set(g2.nodes) == set(g.nodes)
    assert {(e.src, e.dst) for e in g2.edges} == {(e.src, e.dst) for e in g.edges}
    assert g2.nodes["k3"].costs == {"cpu": 2.5, "gpu": 0.5}
    assert to_dot(g) == jdot.to_dot(_paper_dag(jgenerate_paper_dag))


def test_dot_partition_visualization_marks_cut_edges():
    g = TaskGraph()
    g.add("a")
    g.add("b")
    g.add_edge("a", "b", nbytes=10)
    txt = to_dot(g, assignment={"a": 0, "b": 1})
    assert "color=red" in txt          # cut edge highlighted
    assert "fillcolor" in txt
    jg = jdot.parse_dot("digraph g { a -> b [nbytes=10]; }")
    assert txt == jdot.to_dot(jg, assignment={"a": 0, "b": 1})


def test_dot_parse_plain_digraph():
    text = "digraph g { a -> b; b -> c [nbytes=42]; }"
    g = parse_dot(text)
    assert g.num_nodes() == 3
    assert g.edge("b", "c").nbytes == 42
    jg = jdot.parse_dot(text)
    assert {(e.src, e.dst, e.nbytes) for e in g.edges} == {
        (e.src, e.dst, e.nbytes) for e in jg.edges}


# -- pipeline stages --------------------------------------------------------------

PLANNERS = ("fm_stages", "dp_stages", "uniform_stages")


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "deepseek_moe_16b",
                                  "granite_3_2b"])
@pytest.mark.parametrize("n_stages", [2, 4])
def test_stage_plans_are_complete_partitions_equal_to_reference(arch, n_stages):
    cfg = get_config(arch)
    for name in PLANNERS:
        plan = getattr(tpp, name)(cfg, n_stages, batch=8, seq=2048)
        assert len(plan.assignment) == cfg.n_layers
        assert set(plan.assignment.values()) <= set(range(n_stages))
        assert sum(plan.loads_ms) > 0
        got = getattr(tpp, name)(cfg, n_stages, batch=8, seq=2048, peak_flops=TPU_PEAK)
        want = getattr(jpp, name)(jget_config(arch), n_stages, batch=8, seq=2048)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name


def test_dp_stages_optimal_contiguous():
    cfg = get_config("deepseek_moe_16b")   # heterogeneous: dense layer 0
    dp = tpp.dp_stages(cfg, 4, batch=8, seq=2048)
    uni = tpp.uniform_stages(cfg, 4, batch=8, seq=2048)
    assert dp.contiguous
    assert dp.bottleneck_ms <= uni.bottleneck_ms + 1e-9


def test_fm_stages_balance_reasonable():
    cfg = get_config("jamba_1_5_large_398b")
    plan = tpp.fm_stages(cfg, 4, batch=8, seq=2048)
    assert plan.imbalance < 1.4


def test_layer_graph_weights_follow_the_peak_passed_in():
    cfg = get_config("granite_3_2b")
    h100 = tpp.layer_graph(cfg, batch=8, seq=2048)
    tpu = tpp.layer_graph(cfg, batch=8, seq=2048, peak_flops=TPU_PEAK)
    assert tpp.PEAK_FLOPS_BF16 == 989e12
    for name, k in h100.nodes.items():
        flops = tpp.layer_flops(cfg, int(name[1:]), 8, 2048)
        assert k.costs["stage"] == max(flops / 989e12, 1e-9) * 1e3
        assert tpu.nodes[name].costs == jpp.layer_graph(
            jget_config("granite_3_2b"), batch=8, seq=2048).nodes[name].costs


# -- expert placement ---------------------------------------------------------------

def test_dispatch_bytes_in_numpy_equals_the_reference():
    _, idx = synth_coactivation(64, 6, 2048, n_clusters=16, seed=1)
    e2s = random_placement(64, 16, seed=0).expert_to_shard
    assert dispatch_bytes(idx, e2s, 2048) == float(
        jdispatch_bytes(jnp.array(idx), jnp.array(e2s), 2048))


def test_placement_beats_random_on_clustered_traffic():
    co, idx = synth_coactivation(64, 6, 2048, n_clusters=16, seed=1)
    pl = place_experts(co, 16)
    rnd = random_placement(64, 16, seed=0)
    b_gp = dispatch_bytes(idx, pl.expert_to_shard, 2048)
    b_rnd = dispatch_bytes(idx, rnd.expert_to_shard, 2048)
    assert b_gp < b_rnd * 0.9          # >=10% traffic saving
    jco, jidx = jplacement.synth_coactivation(64, 6, 2048, n_clusters=16, seed=1)
    assert np.array_equal(co, jco) and np.array_equal(idx, jidx)
    jpl = jplacement.place_experts(jco, 16)
    assert np.array_equal(pl.expert_to_shard, jpl.expert_to_shard)
    assert np.array_equal(pl.perm, jpl.perm) and pl.cut_weight == jpl.cut_weight
    assert np.array_equal(rnd.expert_to_shard,
                          jplacement.random_placement(64, 16, seed=0).expert_to_shard)


def test_placement_respects_slot_capacity():
    co, _ = synth_coactivation(40, 8, 512, n_clusters=4, seed=2)
    pl = place_experts(co, 16, slots_per_shard=3)
    counts = np.bincount(pl.expert_to_shard, minlength=16)
    assert counts.max() <= 3
    assert len(set(pl.perm.tolist())) == 40
    jpl = jplacement.place_experts(co, 16, slots_per_shard=3)
    assert np.array_equal(pl.expert_to_shard, jpl.expert_to_shard)


def test_placement_perm_consistent_with_shards():
    co, _ = synth_coactivation(32, 4, 512, seed=3)
    pl = place_experts(co, 8)
    slots = 32 // 8
    for e in range(32):
        assert pl.perm[e] // slots == pl.expert_to_shard[e]
    assert np.array_equal(pl.perm, jplacement.place_experts(co, 8).perm)


# -- CLI: --scheduler and --scenario --------------------------------------------------

SCHEDULERS = ("incremental-gp", "gp", "dmda", "eager", "heft", "random", "affinity-steal")


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_cli_scheduler_equals_reference_schedule_requests(scheduler, capsys):
    args = ["--scheduler", scheduler, "--requests", "6", "--decode-chunks", "4"]
    tserve.main(args)
    got = capsys.readouterr().out
    jserve.main(args)
    assert got == capsys.readouterr().out
    want = jserve.schedule_requests(6, 4, scheduler)
    assert tserve.schedule_requests(6, 4, scheduler) == want
    assert got.strip() == (
        f"[serve] scheduler={scheduler}: makespan={want['makespan_ms']:.1f}ms "
        f"transfers={want['transfers']} moved={want['bytes_moved_mb']:.0f}MiB "
        f"placement={want['per_class']}")


def test_cli_scheduler_runs_after_smoke_on_the_cpu(capsys):
    tserve.main(["--smoke", "--arch", "granite_3_2b", "--requests", "2", "--prompt-len",
                 "5", "--decode-len", "2", "--decode-chunks", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("[serve] granite-3-2b-smoke: 2 requests")
    assert lines[1].startswith("[serve] scheduler=incremental-gp: makespan="
                               f"{jserve.schedule_requests(2, 3, 'incremental-gp')['makespan_ms']:.1f}ms")


def _table(text: str) -> list[list[str]]:
    """The arena table's cells, wall-clock columns dropped."""
    rows = [line.split() for line in text.strip().splitlines()]
    return [[c for i, c in enumerate(r) if i not in WALL_COLUMNS] for r in rows]


@pytest.mark.parametrize("scenario", ["moe", "specdec", "colocate"])
def test_cli_scenario_rows_equal_reference(scenario, capsys):
    args = ["--arena", "--scenario", scenario, "--requests", "6", "--decode-chunks", "4",
            "--steps", "3"]
    tserve.main(args)
    got = _table(capsys.readouterr().out)
    jserve.main(args)
    assert got == _table(capsys.readouterr().out)
    policies = sorted(r[0] for r in got[2:])
    assert policies == sorted(tserve.DEFAULT_POLICIES + ("affinity-steal",))
    rows, _ = tserve.run_arena(6, 4, steps=3, seed=0, scenario=scenario,
                               policies=tserve.DEFAULT_POLICIES + ("affinity-steal",))
    for r in rows:
        line = next(c for c in got if c[0] == r.policy)
        assert line[3] == f"{r.total_makespan_ms:.1f}" and line[4] == str(r.transfers)


def test_cli_serve_scenario_keeps_the_default_policies(capsys):
    tserve.main(["--arena", "--requests", "12", "--decode-chunks", "6", "--steps", "5",
                 "--drop-step", "2"])
    rows = _table(capsys.readouterr().out)[2:]
    assert sorted(r[0] for r in rows) == sorted(tserve.DEFAULT_POLICIES)
    assert next(r for r in rows if r[0] == "incremental-gp")[3] == "3276.0"


def test_cli_execute_needs_the_serve_scenario(capsys):
    with pytest.raises(SystemExit, match="--execute only supports --scenario serve"):
        tserve.main(["--arena", "--execute", "--scenario", "moe", "--requests", "4",
                     "--steps", "2", "--device", "cpu"])


def test_import_guard_covers_the_new_modules():
    from test_torch_serving import _port_files

    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in ("router", "dot", "placement", "pipeline_partition"):
        assert f"src/repro_torch/core/{mod}.py" in files
