"""The port's fleet tier (repro_torch.core.router, ``run_router``, the
executed replicas behind it) against the JAX reference.

Every case of tests/test_router.py runs against the port, and each one that
produces a report also runs on the reference: simulated fleet reports are
equal field for field (the router, the stream and the simulator are the
same code under the port's imports).  Executed replicas run under one step
clock in both packages (every ``perf_counter`` reading of the executors
advances 0.1 ms), so their measured kernel times, and with them every
makespan, match too.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core import executor as jex
from repro.core import router as jrouter
from repro.core import serving as jserving
from repro.core.arena import make_request_stream as jstream
from repro.core.arena import requests_of as jrequests_of
from repro.core.arena import split_step as jsplit_step
from repro.core.schedulers import make_policy as jpolicy
from repro.launch import serve as jserve
from repro_torch.core import executor as tex
from repro_torch.core import router as trouter
from repro_torch.core.arena import make_request_stream, requests_of, split_step
from repro_torch.core.graph import TaskGraph
from repro_torch.core.router import MODES, ReplicaRouter, SimReplica
from repro_torch.core.schedulers import make_policy
from repro_torch.core.serving import (ExecutorReplica, ServeReport, ServingExecutor,
                                      groups_for_platform, merge_serve_reports)
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import heterogeneous_platform, run_router
from test_torch_superstep import StepClock

CPU = torch.device("cpu")
KV = 1 << 20


def _fleet(n=3, serve=tserve, router=trouter):
    return [router.SimReplica(f"r{i}", serve.heterogeneous_platform(), "incremental-gp",
                              policy_kwargs={"scale_by_workers": True})
            for i in range(n)]


def _jfleet(n=3):
    return _fleet(n, jserve, jrouter)


def _stream(steps=5, *, churn=0.3, base_requests=12, seed=0, make=make_request_stream):
    return make(steps, base_requests=base_requests, decode_chunks=4, churn=churn,
                kv_bytes=KV, seed=seed, arrival_spread_ms=40.0,
                arrival_mode="onoff", burst_factor=6.0)


def _run(mode, stream, n=3, **kw):
    return ReplicaRouter(_fleet(n), mode=mode).run(stream, **kw)


def _jrun(mode, n=3, stream_kw=None, **kw):
    stream = _stream(make=jstream, **(stream_kw or {}))
    return jrouter.ReplicaRouter(_jfleet(n), mode=mode).run(stream, **kw)


def _same_report(t, j):
    """Port and reference RouterReports equal field for field, every step
    too (floats to 1e-9 relative: the same sums in the same order)."""
    dt, dj = dataclasses.asdict(t), dataclasses.asdict(j)
    steps_t, steps_j = dt.pop("steps"), dj.pop("steps")
    assert dt == pytest.approx(dj, rel=1e-9)
    assert len(steps_t) == len(steps_j)
    for st, sj in zip(steps_t, steps_j):
        for key in ("per_replica_ms", "latency_ms"):
            assert st.pop(key) == pytest.approx(sj.pop(key), rel=1e-9), key
        assert st == pytest.approx(sj, rel=1e-9)
    assert t.to_dict() == pytest.approx(j.to_dict(), rel=1e-9)


# -- stream splitting ---------------------------------------------------------

def test_requests_of_groups_tasks_by_request_tag():
    stream = _stream(1, base_requests=4)
    groups = requests_of(stream[0].graph)
    assert set(groups) == {"r0", "r1", "r2", "r3"}
    for req, names in groups.items():
        assert names[0] == f"{req}.prefill"       # topo order: prefill first
        assert all(n.startswith(req + ".") for n in names)
    jgroups = jrequests_of(_stream(1, base_requests=4, make=jstream)[0].graph)
    assert groups == jgroups


def test_requests_of_untagged_tasks_are_singletons():
    g = TaskGraph()
    g.add("a", op="mm", costs={"big": 1.0})
    g.add("b", op="mm", costs={"big": 1.0})
    g.add_edge("a", "b", nbytes=KV)
    g.validate()
    assert requests_of(g) == {"a": ["a"], "b": ["b"]}


def test_split_step_partitions_requests_and_discounts_warm_entries():
    step = _stream(1, base_requests=4)[0]
    placement = {"r0": "A", "r1": "A", "r2": "B", "r3": "B"}
    subs = split_step(step, placement, warm={"A": {"r0"}}, resume_factor=0.1)
    assert set(subs) == {"A", "B"}
    merged = {}
    for sub in subs.values():
        for req, names in requests_of(sub.graph).items():
            assert req not in merged
            merged[req] = names
    assert merged == requests_of(step.graph)
    ga = subs["A"].graph
    cold = step.graph.nodes["r0.prefill"].costs
    assert ga.nodes["r0.prefill"].costs == {c: v * 0.1 for c, v in cold.items()}
    assert ga.nodes["r1.prefill"].costs == step.graph.nodes["r1.prefill"].costs
    assert ga.nodes["r0.dec0"].costs == step.graph.nodes["r0.dec0"].costs
    assert subs["A"].tag.endswith("@A") and subs["B"].tag.endswith("@B")
    assert subs["A"].events == ()
    # the same split on the reference: the same subgraphs, costs and tags
    jsubs = jsplit_step(_stream(1, base_requests=4, make=jstream)[0], placement,
                       warm={"A": {"r0"}}, resume_factor=0.1)
    for rep, sub in subs.items():
        jsub = jsubs[rep]
        assert sub.tag == jsub.tag and sub.arrivals == jsub.arrivals
        assert {n: k.costs for n, k in sub.graph.nodes.items()} == {
            n: k.costs for n, k in jsub.graph.nodes.items()}
        assert {(e.src, e.dst, e.nbytes) for e in sub.graph.edges} == {
            (e.src, e.dst, e.nbytes) for e in jsub.graph.edges}


def test_split_step_filters_arrivals_and_rejects_cross_request_edges():
    stream = _stream(2, base_requests=4)
    step = stream[1]                              # churned step has arrivals
    assert step.arrivals
    groups = requests_of(step.graph)
    placement = {req: ("A" if i % 2 == 0 else "B")
                 for i, req in enumerate(sorted(groups))}
    subs = split_step(step, placement)
    for rep, sub in subs.items():
        names = {n for req, r in placement.items() if r == rep for n in groups[req]}
        assert set(sub.arrivals or {}) == {n for n in step.arrivals if n in names}
    with pytest.raises(KeyError):
        split_step(step, {})                      # unassigned requests
    g = TaskGraph()
    g.add("x.a", op="mm", costs={"big": 1.0}, meta={"req": "x"})
    g.add("y.a", op="mm", costs={"big": 1.0}, meta={"req": "y"})
    g.add_edge("x.a", "y.a", nbytes=KV)
    g.validate()
    bad = type(stream[0])(graph=g, tag="bad")
    with pytest.raises(ValueError, match="crosses request groups"):
        split_step(bad, {"x": "A", "y": "B"})


# -- routing modes ------------------------------------------------------------

def test_affinity_beats_round_robin_on_warm_stream():
    stream = _stream(5, churn=0.3)
    aff = _run("affinity", stream)
    rr = _run("round-robin", stream)
    jsq = ReplicaRouter(_fleet(), mode="jsq").run(stream)
    assert aff.warm_hit_rate() > 0.9
    assert rr.warm_hit_rate() < aff.warm_hit_rate()
    assert aff.mean_latency_ms() < rr.mean_latency_ms()
    assert aff.mean_latency_ms() < jsq.mean_latency_ms()
    for s_aff, s_rr, step in zip(aff.steps, rr.steps, stream):
        reqs = set(requests_of(step.graph))
        assert set(s_aff.latency_ms) == reqs == set(s_rr.latency_ms)
    for mode, rep in (("affinity", aff), ("round-robin", rr), ("jsq", jsq)):
        _same_report(rep, _jrun(mode))


def test_affinity_degenerates_to_jsq_when_nothing_is_warm():
    stream = _stream(4, churn=1.0)
    aff = _run("affinity", stream)
    jsq = _run("jsq", stream)
    assert aff.warm_hit_rate() == 0.0
    for s_a, s_j in zip(aff.steps, jsq.steps):
        assert s_a.latency_ms == s_j.latency_ms
        assert s_a.per_replica_ms == s_j.per_replica_ms
    _same_report(aff, _jrun("affinity", stream_kw=dict(steps=4, churn=1.0)))


def test_router_rejects_bad_configs():
    with pytest.raises(ValueError, match="unknown router mode"):
        ReplicaRouter(_fleet(), mode="random")
    with pytest.raises(ValueError, match="at least one replica"):
        ReplicaRouter([])
    reps = _fleet(2)
    reps[1].name = reps[0].name
    with pytest.raises(ValueError, match="duplicate replica names"):
        ReplicaRouter(reps)
    assert set(MODES) == {"affinity", "round-robin", "jsq"} == set(jrouter.MODES)


# -- drain / drop / scale-out -------------------------------------------------

def test_drain_migrates_kv_before_replica_drops():
    stream = _stream(5, churn=0.2)
    router = ReplicaRouter(_fleet(), mode="affinity")
    rep = router.run(stream, drain_at={2: "r2"})
    assert rep.drained == ["r2"]
    assert rep.n_migrated > 0
    assert rep.kv_migrated_bytes > 0
    assert not any(h == "r2" for h in router.warm_home.values())
    for s in rep.steps[2:]:
        assert "r2" not in s.per_replica_ms
    assert sum(s.warm_hits for s in rep.steps[2:]) > 0
    _same_report(rep, _jrun("affinity", stream_kw=dict(churn=0.2), drain_at={2: "r2"}))


def test_drain_beats_abrupt_drop_on_warmth():
    drained = _run("affinity", _stream(5, churn=0.2), drain_at={2: "r2"})
    dropped = _run("affinity", _stream(5, churn=0.2), drop_at={2: "r2"})
    assert dropped.dropped == ["r2"] and dropped.kv_migrated_bytes == 0
    drained_hits = sum(s.warm_hits for s in drained.steps[2:])
    dropped_hits = sum(s.warm_hits for s in dropped.steps[2:])
    assert drained_hits > dropped_hits
    _same_report(dropped, _jrun("affinity", stream_kw=dict(churn=0.2), drop_at={2: "r2"}))


def test_drain_honors_explicit_target_and_membership_errors():
    stream = _stream(3, churn=0.2)
    router = ReplicaRouter(_fleet(), mode="affinity")
    router.run_step(stream[0])
    router.run_step(stream[1])
    victims = [r for r, h in router.warm_home.items() if h == "r0"]
    assert victims
    moved = router.drain("r0", target="r2")
    assert all(router.warm_home[r] == "r2" for r in victims)
    jstream_ = _stream(3, churn=0.2, make=jstream)
    jr = jrouter.ReplicaRouter(_jfleet(), mode="affinity")
    jr.run_step(jstream_[0])
    jr.run_step(jstream_[1])
    assert moved == jr.drain("r0", target="r2")
    assert router.warm_home == jr.warm_home and router.warm_bytes == jr.warm_bytes
    with pytest.raises(KeyError):
        router.drain("r0")                        # already dead
    with pytest.raises(KeyError):
        router.drop_replica("nope")
    router.drain("r1")
    router.drain("r2")
    with pytest.raises(RuntimeError, match="drained or dropped"):
        router.route_step(stream[2])              # empty fleet


def test_add_replica_scales_out_and_takes_spill():
    stream = _stream(4, churn=0.3)
    router = ReplicaRouter(_fleet(2), mode="affinity")
    fresh = SimReplica("r9", heterogeneous_platform(), "incremental-gp",
                       policy_kwargs={"scale_by_workers": True})
    rep = router.run(stream, add_at={2: [fresh]})
    assert rep.added == ["r9"]
    assert any("r9" in s.per_replica_ms for s in rep.steps[2:])
    with pytest.raises(ValueError, match="duplicate replica"):
        router.add_replica(fresh)
    jfresh = jrouter.SimReplica("r9", jserve.heterogeneous_platform(), "incremental-gp",
                                policy_kwargs={"scale_by_workers": True})
    _same_report(rep, _jrun("affinity", n=2, stream_kw=dict(steps=4, churn=0.3),
                            add_at={2: [jfresh]}))


# -- executed replicas + merged fleet reports ---------------------------------

def _executor_replica(name, side=8):
    plat = heterogeneous_platform()
    sx = ServingExecutor(groups_for_platform(plat, [CPU]), plat, side=side)
    return ExecutorReplica(name, sx, make_policy("incremental-gp", scale_by_workers=True))


def _jexecutor_replica(name, side=8):
    plat = jserve.heterogeneous_platform()
    sx = jserving.ServingExecutor(jserving.groups_for_platform(plat), plat, side=side)
    return jserving.ExecutorReplica(name, sx, jpolicy("incremental-gp", scale_by_workers=True))


def test_executor_replicas_behind_the_router(monkeypatch):
    monkeypatch.setattr(jex, "time", StepClock())
    monkeypatch.setattr(tex, "time", StepClock())
    kw = dict(base_requests=4, decode_chunks=2, kv_bytes=KV, churn=0.3, seed=0)
    router = ReplicaRouter([_executor_replica("a"), _executor_replica("b")], mode="affinity")
    rep = router.run(make_request_stream(3, **kw))
    assert len(rep.steps) == 3
    assert all(s.makespan_ms > 0 for s in rep.steps)
    assert router.warm_home and router.warm_bytes
    assert sum(s.warm_hits for s in rep.steps[1:]) > 0
    drained = router.replicas["a"].drain_kv()
    assert all(nb >= 0 for nb in drained.values())
    jr = jrouter.ReplicaRouter([_jexecutor_replica("a"), _jexecutor_replica("b")],
                               mode="affinity")
    _same_report(rep, jr.run(jstream(3, **kw)))
    assert router.warm_home == jr.warm_home
    assert drained == jr.replicas["a"].drain_kv()


def test_merge_serve_reports_fleet_view():
    stream = make_request_stream(2, base_requests=4, decode_chunks=2,
                                 kv_bytes=KV, churn=0.3, seed=0)
    reps = [_executor_replica("a"), _executor_replica("b")]
    per_replica = {r.name: ServeReport(policy="incremental-gp") for r in reps}
    for step in stream:
        groups = sorted(requests_of(step.graph))
        placement = {req: reps[i % 2].name for i, req in enumerate(groups)}
        subs = split_step(step, placement)
        for r in reps:
            per_replica[r.name].steps.append(r.run_step(subs[r.name]))
    merged = merge_serve_reports(list(per_replica.values()))
    assert merged.policy == "incremental-gp"
    assert len(merged.steps) == len(stream)
    for i, s in enumerate(merged.steps):
        group = [per_replica[n].steps[i] for n in per_replica]
        assert s.makespan_ms == max(g.makespan_ms for g in group)
        assert s.n_kernels == sum(g.n_kernels for g in group)
        assert s.n_transfers == sum(g.n_transfers for g in group)
        assert s.spills == sum(g.spills for g in group)
        assert s.n_preempted == sum(g.n_preempted for g in group)
        assert s.tag == stream[i].tag             # "@replica" suffix stripped
        for cls, ms in s.kernel_ms_by_class.items():
            per = [g.kernel_ms_by_class[cls] for g in group
                   if cls in g.kernel_ms_by_class]
            assert ms == pytest.approx(sum(per) / len(per))
    with pytest.raises(ValueError, match="nothing to merge"):
        merge_serve_reports([])


# -- launch-level fleet runner ------------------------------------------------

def test_run_router_smoke_and_drain():
    rep = run_router(8, 3, replicas=3, mode="affinity", steps=3, kv_mb=1.0, seed=0,
                     drain_step=2)
    assert rep.mode == "affinity"
    assert len(rep.steps) == 3
    assert rep.drained == ["r2"]
    assert rep.kv_migrated_bytes > 0
    d = rep.to_dict()
    assert d["warm_hit_rate"] == rep.warm_hit_rate()
    assert d["steps"] == 3


@pytest.mark.parametrize("hier", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_run_router_equals_reference(mode, hier):
    kw = dict(replicas=3, mode=mode, steps=4, seed=0, hier=hier, drain_step=2)
    _same_report(run_router(12, 3, **kw), jserve.run_router(12, 3, **kw))


def test_cli_router_rows_equal_run_router(capsys):
    args = ["--arena", "--requests", "24", "--steps", "4", "--replicas", "3",
            "--router", "all", "--drain-step", "2"]
    tserve.main(args)
    got = capsys.readouterr().out.strip().splitlines()
    jserve.main(args)
    want = capsys.readouterr().out.strip().splitlines()
    assert got == want and len(got) == len(MODES)
    for line, mode in zip(got, MODES):
        d = run_router(24, 8, replicas=3, mode=mode, steps=4, seed=0,
                       drain_step=2).to_dict()
        assert line.startswith(f"[router] mode={mode} replicas=3 steps=4: ")
        assert f"mean_lat={d['mean_latency_ms']:.1f}ms" in line
        assert f"migrated={d['kv_migrated_bytes'] / 2**20:.0f}MiB" in line
