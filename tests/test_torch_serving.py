"""The port's serving stack (repro_torch.core.serving, repro_torch.launch.serve)
against the JAX reference, and the port's import guard.

* The simulated arena on the pinned CI stream gives exactly the reference's
  rows through the port's copies of the scheduler modules (incremental-gp
  totals 3276.00 ms).
* The executed arena at side 16 on the CPU: ``gp``'s per-step kernel,
  transfer and byte counters equal the reference's (they repeat exactly; the
  other policies' transfers follow measured kernel times), and every policy
  passes the counters tests/test_serving.py asserts.
* The port's bench artifact passes ``benchmarks.gate_serve.check``.
* ``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor ``repro``.
"""

import ast
import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks.gate_serve import check as gate_check

from repro.launch import serve as jserve
from repro_torch.core import serving as tserving
from repro_torch.core.arena import make_request_stream
from repro_torch.core.schedulers import make_policy
from repro_torch.core.simulate import WorkerDrop
from repro_torch.launch import serve as tserve

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
KV = 1 << 20
CI = dict(steps=5, drop_step=2, seed=0)  # with 12 requests, 6 decode chunks
ALL_EXECUTED = {"eager", "dmda", "heft", "gp", "incremental-gp"}
WALL_FIELDS = {"decision_ms", "offline_ms"}  # wall-clock columns


def _serving_executor(plat, **kw):
    kw.setdefault("side", 16)
    return tserving.ServingExecutor(
        tserving.groups_for_platform(plat, [CPU]), plat, **kw)


# -- simulated arena: the copied scheduler modules against the reference -------

@pytest.mark.parametrize("hier", [False, True])
def test_simulated_arena_rows_equal_reference(hier):
    rows_t, _ = tserve.run_arena(12, 6, hier=hier, **CI)
    rows_j, _ = jserve.run_arena(12, 6, hier=hier, **CI)
    assert [r.policy for r in rows_t] == [r.policy for r in rows_j]
    for rt, rj in zip(rows_t, rows_j):
        dt, dj = dataclasses.asdict(rt), dataclasses.asdict(rj)
        assert {k: v for k, v in dt.items() if k not in WALL_FIELDS} == {
            k: v for k, v in dj.items() if k not in WALL_FIELDS}
    if not hier:
        igp = next(r for r in rows_t if r.policy == "incremental-gp")
        assert f"{igp.total_makespan_ms:.2f}" == "3276.00"


@pytest.mark.parametrize("scenario", ["moe", "specdec"])
def test_simulated_zoo_scenarios_equal_reference(scenario):
    kw = dict(steps=3, seed=0, scenario=scenario)
    rows_t, _ = tserve.run_arena(6, 4, **kw)
    rows_j, _ = jserve.run_arena(6, 4, **kw)
    strip = lambda r: {k: v for k, v in dataclasses.asdict(r).items()
                       if k not in WALL_FIELDS}
    assert [strip(r) for r in rows_t] == [strip(r) for r in rows_j]


def test_colocate_scenario_rows_equal_reference():
    """The colocate scenario's fine-tune steps are costed from the port's
    own model configs, with the reference's formula."""
    kw = dict(steps=3, seed=0, scenario="colocate")
    rows_t, _ = tserve.run_arena(6, 4, **kw)
    rows_j, _ = jserve.run_arena(6, 4, **kw)
    strip = lambda r: {k: v for k, v in dataclasses.asdict(r).items()
                       if k not in WALL_FIELDS}
    assert rows_t and [strip(r) for r in rows_t] == [strip(r) for r in rows_j]


@pytest.mark.parametrize("arch", ["granite_3_2b", "rwkv6_3b", "minitron_4b"])
def test_colocate_train_step_costs_equal_reference(arch):
    from repro.core.arena import _train_step_costs as jcosts
    from repro_torch.core.arena import _train_step_costs as tcosts

    gflops = {"big": 900.0, "small": 150.0}
    assert tcosts(arch, 8, 128, gflops) == jcosts(arch, 8, 128, gflops)


# -- executed arena -----------------------------------------------------------

@pytest.fixture(scope="module")
def executed_ci():
    """The pinned CI stream executed at side 16: (port arena, reference arena)."""
    _, at = tserve.run_arena_executed(12, 6, side=16, device=CPU, **CI)
    _, aj = jserve.run_arena_executed(12, 6, side=16, **CI)
    return at, aj


def test_executed_gp_counters_equal_reference(executed_ci):
    at, aj = executed_ci
    st, sj = at.reports["gp"].steps, aj.reports["gp"].steps
    assert len(st) == len(sj) == CI["steps"]
    for a, b in zip(st, sj):
        assert (a.n_kernels, a.n_transfers, a.bytes_transferred) == (
            b.n_kernels, b.n_transfers, b.bytes_transferred)


def test_executed_ci_stream_counters_all_policies(executed_ci):
    at, _ = executed_ci
    stream = make_request_stream(CI["steps"], base_requests=12, decode_chunks=6,
                                 seed=CI["seed"])
    assert set(at.reports) == ALL_EXECUTED
    for name, rep in at.reports.items():
        assert len(rep.steps) == CI["steps"]
        d = rep.to_dict()
        assert d["kernels"] >= sum(s.graph.num_nodes() for s in stream)
        assert sum(d["kernels_by_op"].values()) == d["kernels"]
        assert set(d["kernels_by_op"]) == {"prefill", "decode"}
        for step, s in zip(stream, rep.steps):
            assert s.n_kernels >= step.graph.num_nodes()
            assert s.makespan_ms > 0.0
            assert s.kernel_ms_by_class
        row = rep.to_row()
        assert row.total_makespan_ms == pytest.approx(
            sum(s.makespan_ms for s in rep.steps))


def test_executed_stream_end_to_end_counters():
    stream = make_request_stream(3, base_requests=4, decode_chunks=3,
                                 kv_bytes=KV, seed=0)
    plat = tserve.heterogeneous_platform()
    sx = _serving_executor(plat)
    pol = make_policy("incremental-gp", scale_by_workers=True)
    rep = sx.run_stream(stream, pol)
    assert rep.policy == "incremental-gp"
    assert len(rep.steps) == len(stream)
    for step, s in zip(stream, rep.steps):
        assert s.n_kernels == step.graph.num_nodes()
        assert s.makespan_ms > 0.0
        assert s.kernel_ms_by_class
    d = rep.to_dict()
    assert d["kernels"] == sum(s.graph.num_nodes() for s in stream)
    assert d["transfers"] >= 0 and d["bytes_moved"] >= 0
    # the measurement loop closed: policy saw live per-class step times
    assert set(pol.live_step_ms) >= set(d["mean_kernel_ms"])
    assert all(v > 0 for v in pol.live_step_ms.values())
    assert any(k[0] in ("prefill", "decode") for k in sx.cost_model._cache)


def test_worker_drop_mid_stream_redispatches_in_flight():
    events_at = {
        0: (WorkerDrop(1e-6, "small0"), WorkerDrop(2e-6, "small1")),
        1: (WorkerDrop(0.0, "small0"), WorkerDrop(0.0, "small1")),
    }
    stream = make_request_stream(2, base_requests=6, decode_chunks=3,
                                 kv_bytes=KV, seed=3, events_at=events_at)
    sx = _serving_executor(tserve.heterogeneous_platform())
    rep = sx.run_stream(stream, make_policy("incremental-gp", scale_by_workers=True))
    s0, s1 = rep.steps
    assert s0.dropped == ["small0", "small1"]
    assert s0.redispatched > 0
    assert s0.n_kernels >= stream[0].graph.num_nodes()
    assert set(s1.kernel_ms_by_class) == {"big"}
    assert s1.n_kernels == stream[1].graph.num_nodes()


def test_late_arrivals_are_admitted_and_run():
    stream = make_request_stream(2, base_requests=4, decode_chunks=2,
                                 kv_bytes=KV, seed=1, churn=0.5,
                                 arrival_spread_ms=5.0)
    assert any(s.arrivals for s in stream)
    sx = _serving_executor(tserve.heterogeneous_platform())
    pol = make_policy("incremental-gp", scale_by_workers=True)
    rep = sx.run_stream(stream, pol)
    assert rep.to_dict()["admitted_late"] > 0
    assert pol.stats["admitted"] > 0
    for step, s in zip(stream, rep.steps):
        assert s.n_kernels == step.graph.num_nodes()


def test_merge_serve_reports_sums_counters():
    stream = make_request_stream(2, base_requests=3, decode_chunks=2,
                                 kv_bytes=KV, seed=0)
    reps = [_serving_executor(tserve.heterogeneous_platform()).run_stream(
        stream, make_policy("gp", scale_by_workers=True)) for _ in range(2)]
    merged = tserving.merge_serve_reports(reps)
    for i, s in enumerate(merged.steps):
        assert s.n_kernels == sum(r.steps[i].n_kernels for r in reps)
        assert s.kernels_by_op["decode"] == sum(
            r.steps[i].kernels_by_op["decode"] for r in reps)
        assert s.makespan_ms == max(r.steps[i].makespan_ms for r in reps)


# -- bench artifact + gate, CLI, devices ---------------------------------------

def test_bench_artifact_passes_gate(executed_ci, tmp_path):
    at, _ = executed_ci
    rows, _ = tserve.run_arena(12, 6, **CI)
    out = tmp_path / "BENCH_serve.json"
    doc = tserve.write_bench(str(out), meta={"test": True}, sim_rows=rows,
                             arena=at, device=CPU)
    assert json.loads(out.read_text()) == doc
    assert doc["meta"]["torch"] == torch.__version__
    assert doc["meta"]["device"] == "cpu"
    assert set(doc["executed"]) == ALL_EXECUTED
    assert gate_check(doc, doc, 0.20) == []
    worse = copy.deepcopy(doc)
    worse["simulated"]["incremental-gp"]["total_makespan_ms"] *= 2
    assert gate_check(worse, doc, 0.20)
    incomplete = copy.deepcopy(doc)
    incomplete["executed"]["gp"]["kernels"] -= 1
    assert gate_check(incomplete, doc, 0.20)


def test_cli_executes_on_the_cpu_when_asked(tmp_path, capsys):
    out = tmp_path / "b.json"
    tserve.main(["--arena", "--execute", "--requests", "3", "--decode-chunks", "2",
                 "--steps", "2", "--kernel-side", "8", "--device", "cpu",
                 "--bench-out", str(out)])
    assert "executed on cpu" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert set(doc["executed"]) == ALL_EXECUTED
    assert doc["meta"]["kernel_side"] == 8


def test_no_silent_cpu_fallback(monkeypatch):
    """Without CUDA the default device raises; the CPU is only ever asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plat = tserve.heterogeneous_platform()
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.groups_for_platform(plat)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.run_arena_executed(2, 1, steps=1, side=8)
    with pytest.raises(SystemExit):
        tserve.main(["--arena", "--execute", "--requests", "2", "--steps", "1"])


def test_groups_for_platform_maps_every_class():
    plat = tserve.hierarchical_platform()
    groups = tserving.groups_for_platform(plat, [CPU])
    assert set(groups) == set(plat.classes)
    assert all(d == CPU for d in groups.values())


# -- import guard ---------------------------------------------------------------

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro_ast():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert bad == []


def test_port_imports_neither_jax_nor_repro_at_runtime():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
