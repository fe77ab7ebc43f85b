"""The port's async multi-group waves (``ExecSession(fused=True,
async_groups=True)``) against the JAX reference: the wave cases of
tests/test_waves.py, run through both packages.

Every group aliases one CPU device in both, and the reference's inputs are
carried into the port with ``inputs_from_numpy``.  Within the port the
serialized fused arm is the bit-identity reference (waves change WHEN
things run, never WHAT they compute); against the reference the wave
counts, donations, re-executions and virtual timelines are equal and the
outputs agree at the reference suite's 1e-5.  On the card each group's
chain replays on its own CUDA stream (``chip_smoke.py`` checks that); here
the chains run one after the other.

The executed arena measures kernel times, and its arrivals and drops land on
that measured clock, so both executors run it under one step clock (see
tests/test_torch_superstep.py): then every policy's fused counters must be
equal.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.core import executor as jex
from repro.core import graph as jgraph
from repro.core import serving as jserving
from repro.core import simulate as jsim
from repro.core.arena import make_request_stream as jstream
from repro.core.comm import CommEngine as JCommEngine
from repro.core.comm import Topology as JTopology
from repro.core.cost import PCIE3_X16 as JPCIE3_X16
from repro.core.schedulers import make_policy as jpolicy
from repro.launch import serve as jserve
from repro_torch.core import executor as tex
from repro_torch.core import graph as tgraph
from repro_torch.core import serving as tserving
from repro_torch.core import simulate as tsim
from repro_torch.core.arena import make_request_stream as tstream
from repro_torch.core.comm import CommEngine, Topology
from repro_torch.core.cost import PCIE3_X16
from repro_torch.core.schedulers import make_policy as tpolicy
from repro_torch.launch import serve as tserve

from test_torch_superstep import StepClock, step_clock  # noqa: F401  (fixture)

JDEV = jax.devices()[0]
CPU = torch.device("cpu")
KV = 1 << 16
SIDE = 8
TOL = dict(rtol=1e-5, atol=1e-5)
CI = dict(steps=5, drop_step=2, seed=0)  # with 12 requests, 6 decode chunks


def _pair(build):
    gj, gt = build(jgraph), build(tgraph)
    arrays = jex.attach_matrix_kernels(gj, SIDE)
    tex.attach_matrix_kernels(gt, SIDE)
    inputs = tex.inputs_from_numpy({k: np.asarray(v) for k, v in arrays.items()}, CPU)
    return gj, arrays, gt, inputs


def _sessions(pair, asg, groups, *, async_groups, comm=None, **kw):
    """(reference session, port session); ``comm`` is a zero-argument
    factory of (reference engine, port engine)."""
    gj, arrays, gt, inputs = pair
    cj, ct = comm() if comm else (None, None)
    sj = jex.JaxExecutor({g: JDEV for g in groups}).session(
        gj, asg, arrays, fused=True, async_groups=async_groups, comm=cj, **kw)
    st = tex.TorchExecutor({g: CPU for g in groups}).session(
        gt, asg, inputs, fused=True, async_groups=async_groups, comm=ct, **kw)
    return sj, st


def _run(pair, asg, groups, *, async_groups, **kw):
    sj, st = _sessions(pair, asg, groups, async_groups=async_groups, **kw)
    sj.run_all()
    st.run_all()
    return sj, sj.result(), st, st.result()


def _same(sj, rj, st, rt):
    assert [(r.group, r.members, r.cache_hit, r.donated) for r in st.superstep_runs] == [
        (r.group, r.members, r.cache_hit, r.donated) for r in sj.superstep_runs]
    for f in ("n_waves", "fused_steps", "cache_hits", "cache_misses", "n_transfers",
              "bytes_transferred", "reexecuted", "kernels_per_group"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert rt.model_makespan_ms == pytest.approx(rj.model_makespan_ms, abs=1e-9)
    assert rt.overlap_ms == pytest.approx(rj.overlap_ms, abs=1e-9)
    assert set(rt.outputs) == set(rj.outputs)
    for n, arr in rj.outputs.items():
        np.testing.assert_allclose(rt.outputs[n].numpy(), np.asarray(arr), **TOL)


def _bit_equal(ra, rb):
    assert set(ra.outputs) == set(rb.outputs)
    for n, t in ra.outputs.items():
        assert torch.equal(t, rb.outputs[n]), n


def _diamond(pkg):
    g = pkg.TaskGraph()
    g.add("a", op="matadd", costs={"ga": 1.0}, out_bytes=KV)
    g.add("b", op="matadd", costs={"gb": 1.0}, out_bytes=KV)
    g.add("c", op="matmul", costs={"gc": 1.0}, out_bytes=KV)
    g.add("d", op="matadd", costs={"gd": 1.0}, out_bytes=KV)
    for e in [("a", "b"), ("a", "c"), ("b", "d"), ("c", "d")]:
        g.add_edge(*e, nbytes=KV)
    g.validate()
    return g


DIAMOND_ASG = {"a": "ga", "b": "gb", "c": "gc", "d": "gd"}


def _pcie():
    return (JCommEngine(JTopology.dedicated(JPCIE3_X16)),
            CommEngine(Topology.dedicated(PCIE3_X16)))


# -- wave count == quotient-DAG topological levels ----------------------------

def test_wave_count_diamond_levels():
    pair = _pair(_diamond)
    groups = sorted(set(DIAMOND_ASG.values()))
    sja, rja, sta, rta = _run(pair, DIAMOND_ASG, groups, async_groups=False)
    sjb, rjb, stb, rtb = _run(pair, DIAMOND_ASG, groups, async_groups=True)
    assert (rta.n_waves, rtb.n_waves) == (4, 3)
    _same(sja, rja, sta, rta)
    _same(sjb, rjb, stb, rtb)
    _bit_equal(rta, rtb)


def test_wave_count_fanout_two_levels():
    def build(pkg):
        g = pkg.TaskGraph()
        g.add("a", op="matadd", costs={"g0": 1.0}, out_bytes=KV)
        for grp in ("g1", "g2", "g3"):
            g.add(f"k_{grp}", op="matadd", costs={grp: 1.0}, out_bytes=KV)
            g.add_edge("a", f"k_{grp}", nbytes=KV)
        g.validate()
        return g

    pair = _pair(build)
    asg = {"a": "g0", "k_g1": "g1", "k_g2": "g2", "k_g3": "g3"}
    groups = ["g0", "g1", "g2", "g3"]
    kw = dict(cost_clock=True, group_nodes={g: i for i, g in enumerate(groups)},
              prefetch_depth=0, comm=_pcie)
    sja, rja, sta, rta = _run(pair, asg, groups, async_groups=False, **kw)
    sjb, rjb, stb, rtb = _run(pair, asg, groups, async_groups=True, **kw)
    assert (rta.n_waves, rtb.n_waves) == (4, 2)
    assert rtb.overlap_ms > 0.0
    assert rtb.model_makespan_ms < rta.model_makespan_ms
    _same(sja, rja, sta, rta)
    _same(sjb, rjb, stb, rtb)
    _bit_equal(rta, rtb)


def test_executor_run_passes_async_groups_and_cost_clock_through(monkeypatch):
    """``TorchExecutor.run`` runs the session that ``session`` would, with
    ``async_groups`` and ``cost_clock`` as given."""
    pair = _pair(_diamond)
    _, _, gt, inputs = pair
    groups = sorted(set(DIAMOND_ASG.values()))
    ex = tex.TorchExecutor({g: CPU for g in groups})
    made = []
    session = ex.session

    def recording(*args, **kw):
        made.append(session(*args, **kw))
        return made[-1]

    monkeypatch.setattr(ex, "session", recording)
    for async_groups, waves in ((False, 4), (True, 3)):
        got = ex.run(gt, DIAMOND_ASG, inputs, fused=True, async_groups=async_groups,
                     cost_clock=True)
        s = made[-1]
        assert (s.fused, s.async_groups, s.cost_clock) == (True, async_groups, True)
        assert got.n_waves == waves
        want = session(gt, DIAMOND_ASG, inputs, fused=True, async_groups=async_groups)
        want.run_all()
        _bit_equal(got, want.result())


# -- bitwise parity on randomized multi-group graphs --------------------------

def _random_graph(pkg, seed, n_nodes=12, n_groups=3):
    rng = np.random.RandomState(seed)
    g = pkg.TaskGraph()
    asg = {}
    for i in range(n_nodes):
        name = f"n{i}"
        grp = f"g{rng.randint(n_groups)}"
        op = "matadd" if rng.rand() < 0.5 else "matmul"
        g.add(name, op=op, costs={f"g{j}": 1.0 for j in range(n_groups)}, out_bytes=KV)
        asg[name] = grp
        if i > 0:
            n_preds = min(i, 1 + rng.randint(2))
            for p in rng.choice(i, size=n_preds, replace=False):
                g.add_edge(f"n{p}", name, nbytes=KV)
    g.validate()
    return g, asg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_async_waves_bitwise_parity_randomized(seed):
    pair = _pair(lambda pkg: _random_graph(pkg, seed)[0])
    asg = _random_graph(tgraph, seed)[1]
    # unit-normal blocks through chains of matmuls: scale the seeds so the
    # reference's tolerance stays meaningful
    pair = (pair[0], {k: v * 0.25 for k, v in pair[1].items()}, pair[2],
            {k: v * 0.25 for k, v in pair[3].items()})
    groups = ["g0", "g1", "g2"]
    sja, rja, sta, rta = _run(pair, asg, groups, async_groups=False)
    sjb, rjb, stb, rtb = _run(pair, asg, groups, async_groups=True)
    _bit_equal(rta, rtb)
    assert rtb.n_waves <= rta.n_waves
    _same(sja, rja, sta, rta)
    _same(sjb, rjb, stb, rtb)


# -- donation across group boundaries (wave seal) -----------------------------

def test_donation_only_after_wave_seal():
    def build(pkg):
        g = pkg.TaskGraph()
        g.add("a", op="matadd", costs={"g0": 1.0}, out_bytes=KV)
        g.add("b", op="matadd", costs={"g1": 1.0}, out_bytes=KV)
        g.add("c", op="matadd", costs={"g1": 1.0}, out_bytes=KV)
        g.add_edge("a", "b", nbytes=KV)
        g.add_edge("b", "c", nbytes=KV)
        g.validate()
        return g

    pair = _pair(build)
    asg = {"a": "g0", "b": "g1", "c": "g1"}
    sja, rja, sta, rta = _run(pair, asg, ["g0", "g1"], async_groups=False, prefetch_depth=0)
    sjb, rjb, stb, rtb = _run(pair, asg, ["g0", "g1"], async_groups=True, prefetch_depth=0)
    ser = {tuple(r.members): r for r in sta.superstep_runs}
    wav = {tuple(r.members): r for r in stb.superstep_runs}
    assert ser[("b", "c")].donated == []
    assert wav[("b", "c")].donated == ["a"]
    assert "a" in sta.valid and "a" not in stb.valid
    _same(sja, rja, sta, rta)
    _same(sjb, rjb, stb, rtb)
    _bit_equal(rta, rtb)


# -- mid-wave eviction --------------------------------------------------------

def test_midwave_eviction_requeues_unmaterialized_chain_transitively():
    def build(pkg):
        g = pkg.TaskGraph()
        prev = None
        for i in range(3):
            g.add(f"k{i}", op="matadd", costs={"g0": 1.0}, out_bytes=KV)
            if prev is not None:
                g.add_edge(prev, f"k{i}", nbytes=KV)
            prev = f"k{i}"
        g.add("k3", op="matadd", costs={"g1": 1.0}, out_bytes=KV)
        g.add_edge("k2", "k3", nbytes=KV)
        g.validate()
        return g

    pair = _pair(build)
    asg = {"k0": "g0", "k1": "g0", "k2": "g0", "k3": "g1"}
    _, _, _, serial = _run(pair, asg, ["g0", "g1"], async_groups=False)
    sj, st = _sessions(pair, asg, ["g0", "g1"], async_groups=True)
    for s in (sj, st):
        for _ in range(3):  # drain wave 1 (the whole g0 chain)
            assert s.step().group == "g0"
        assert set(s.blocks) == {"k2"}
        assert s.evict_group("g0") == ["k2", "k1", "k0"]
        s.run_all()
    rj, rt = sj.result(), st.result()
    assert rt.reexecuted == ["k2", "k1", "k0"]
    _same(sj, rj, st, rt)
    _bit_equal(rt, serial)


def test_eviction_drops_stale_records_of_requeued_members():
    """Records of a dispatched chain not yet read by ``step`` are dropped
    when an eviction re-queues their kernels; the kernels ran, so
    ``kernels_by_op`` counts them beside the records that are read."""
    def build(pkg):
        g = pkg.TaskGraph()
        g.add("k0", op="matadd", costs={"g0": 1.0}, out_bytes=KV)
        g.add("k1", op="matadd", costs={"g0": 1.0}, out_bytes=KV)
        g.add("k2", op="matadd", costs={"g1": 1.0}, out_bytes=KV)
        g.add_edge("k0", "k1", nbytes=KV)
        g.add_edge("k1", "k2", nbytes=KV)
        g.validate()
        return g

    pair = _pair(build)
    asg = {"k0": "g0", "k1": "g0", "k2": "g1"}
    names = []
    for s in _sessions(pair, asg, ["g0", "g1"], async_groups=True):
        assert s.step().name == "k0"  # k1's record is still buffered
        assert s.evict_group("g0") == ["k1", "k0"]
        seen = ["k0"]
        while (run := s.step()) is not None:
            seen.append(run.name)
        names.append(seen)
        if isinstance(s, tex.ExecSession):
            assert s.kernels_by_op == {"matadd": 5}  # k0, k1 twice; k2 once
    assert names[0] == names[1] == ["k0", "k0", "k1", "k2"]


class _DiesOnRelease(tex.EagerChain):
    """A CPU entry that, like a released CUDA graph, cannot replay."""

    made: list = []

    def __init__(self, chain):
        super().__init__(chain)
        self.released = False
        _DiesOnRelease.made.append(self)

    def replay(self, ext_args):
        if self.released:
            raise RuntimeError("replay of a released CUDA graph")
        return super().replay(ext_args)

    def release(self):
        self.released = True


@pytest.mark.parametrize("async_groups", [False, True])
def test_full_cache_evicts_inside_a_wave_without_breaking_its_replays(
        monkeypatch, async_groups):
    """A full cache evicts its oldest entry, as the reference's does, also
    when a plan of the same wave has just looked that entry up and not yet
    replayed it: three groups' chains in one wave against a cache of two.
    The evicted entry is released only after the wave, the counters follow
    the reference's, and the outputs equal the serialized arm's."""
    from test_torch_superstep import _three_group_graph

    monkeypatch.setattr(tex, "EagerChain", _DiesOnRelease)
    monkeypatch.setattr(_DiesOnRelease, "made", [])
    asg = _three_group_graph(tgraph)[1]
    pair = _pair(lambda pkg: _three_group_graph(pkg)[0])
    groups = ["g0", "g1", "g2"]
    _, _, _, serial = _run(pair, asg, groups, async_groups=False)
    cj, ct = jex.SuperStepCache(max_entries=2), tex.SuperStepCache(max_entries=2)
    for _ in range(2):  # the second pass meets a full cache from the start
        sj, st = _sessions(pair, asg, groups, async_groups=async_groups, time_kernels=True)
        sj.cache, st.cache = cj, ct
        sj.run_all()
        st.run_all()
        rj, rt = sj.result(), st.result()
        _same(sj, rj, st, rt)
        _bit_equal(rt, serial)
    assert (ct.hits, ct.misses) == (cj.hits, cj.misses) == (0, 6)
    assert len(ct) == len(cj) == 2
    assert sum(e.released for e in _DiesOnRelease.made) == 4


# -- simulated / executed timeline agreement ----------------------------------

def test_wave_schedule_agrees_with_executor_both_arms():
    def build(pkg):
        g = pkg.TaskGraph()
        g.add("a", op="matadd", costs={"g1": 2.0}, out_bytes=KV)
        g.add("b", op="matadd", costs={"g2": 3.0}, out_bytes=KV)
        g.add("c", op="matmul", costs={"g3": 1.0}, out_bytes=KV)
        g.add("j", op="matadd", costs={"g1": 1.0}, out_bytes=KV)
        for e in [("a", "j"), ("b", "j"), ("c", "j")]:
            g.add_edge(*e, nbytes=KV)
        g.validate()
        return g

    pair = _pair(build)
    asg = {"a": "g1", "b": "g2", "c": "g3", "j": "g1"}
    input_bytes = {k: int(v.numel() * v.element_size()) for k, v in pair[3].items()}
    sizes = {"host": 1, "g1": 1, "g2": 1, "g3": 1}
    plat = tsim.make_group_platform(sizes, PCIE3_X16, topology=Topology.dedicated(PCIE3_X16))
    group_nodes = {cls: i for i, cls in enumerate(sizes)}
    for async_groups in (False, True):
        sj, rj, st, rt = _run(pair, asg, list(sizes), async_groups=async_groups,
                              host_group="host", comm=_pcie, group_nodes=group_nodes,
                              prefetch_depth=0, cost_clock=True)
        _same(sj, rj, st, rt)
        sim = tsim.wave_schedule(pair[2], asg, plat, host_group="host",
                                 async_groups=async_groups, input_bytes=input_bytes)
        assert sim.makespan_ms == pytest.approx(rt.model_makespan_ms, abs=1e-9)
        assert sim.n_transfers == rt.n_transfers
        assert sim.n_waves == rt.n_waves
    serial = tsim.wave_schedule(pair[2], asg, plat, host_group="host")
    waved = tsim.wave_schedule(pair[2], asg, plat, host_group="host", async_groups=True)
    assert waved.makespan_ms < serial.makespan_ms and waved.n_waves < serial.n_waves


@pytest.mark.parametrize("cap", [None, (1 << 19) + (1 << 20)])
def test_residency_sweep_equals_reference(cap):
    """Wave-concurrent residency: co-resident pulled copy and chain outputs,
    and FIFO spills under a capacity cap, as the reference's sweep gives."""
    mem, seed_bytes = 1 << 20, 1 << 19
    out = []
    for pkg, sim, link in ((jgraph, jsim, JPCIE3_X16), (tgraph, tsim, PCIE3_X16)):
        g = pkg.TaskGraph()
        g.add("k0", op="matadd", costs={"g1": 1.0}, out_bytes=KV, mem_bytes=mem)
        g.add("k1", op="matadd", costs={"g1": 1.0}, out_bytes=KV, mem_bytes=mem)
        g.add_edge("k0", "k1", nbytes=KV)
        g.validate()
        kw = {} if cap is None else dict(mem_capacity_bytes={"g1": cap})
        plat = sim.make_group_platform({"host": 1, "g1": 1}, link, **kw)
        r = sim.wave_schedule(g, {"k0": "g1", "k1": "g1"}, plat, host_group="host",
                              async_groups=True, input_bytes={"k0/in": seed_bytes})
        out.append((r.peak_mem_bytes, r.spill_events, r.spilled_bytes, r.makespan_ms))
    assert out[0] == out[1]
    if cap is None:
        assert out[1][0]["g1"] == pytest.approx(seed_bytes + 2 * mem)
    else:
        assert out[1][1] >= 1 and out[1][0]["g1"] <= cap + 1e-6


def test_async_pull_handle_eta_done_and_poll_callbacks():
    etas = []
    for eng in (JCommEngine(JTopology.dedicated(JPCIE3_X16)),
                CommEngine(Topology.dedicated(PCIE3_X16))):
        h = eng.fetch_async("blk", 0, 1, 1 << 20, now=0.0)
        assert eng.n_transfers == 1 and not h.done(0.0) and h.done(h.eta)
        fired = []
        h.on_complete(fired.append)
        assert eng.poll(h.eta / 2) == [] and fired == []
        assert eng.poll(h.eta) == [h] and fired == [h]
        assert eng.poll(h.eta) == []
        etas.append(h.eta)
    assert etas[0] == etas[1]


# -- serving integration (both packages under one step clock) -------------------

def test_serving_threads_wave_counters_and_matches_serialized(step_clock):
    reps = {}
    for asy in (False, True):
        jplat, tplat = jserve.heterogeneous_platform(), tserve.heterogeneous_platform()
        js = jstream(3, base_requests=4, decode_chunks=3, kv_bytes=KV, seed=0)
        ts = tstream(3, base_requests=4, decode_chunks=3, kv_bytes=KV, seed=0)
        rj = jserving.ServingExecutor(jserving.groups_for_platform(jplat), jplat, side=16,
                                      fused=True, async_groups=asy).run_stream(js, jpolicy("gp"))
        rt = tserving.ServingExecutor(tserving.groups_for_platform(tplat, [CPU]), tplat,
                                      side=16, fused=True, async_groups=asy
                                      ).run_stream(ts, tpolicy("gp"))
        dj, dt = rj.to_dict(), rt.to_dict()
        for k in ("waves", "fused_steps", "cache_hits", "cache_misses", "transfers",
                  "kernels"):
            assert dt[k] == dj[k], (asy, k)
        assert dt["overlap_ms"] == pytest.approx(dj["overlap_ms"])
        reps[asy] = rt
    d_ser, d_wav = reps[False].to_dict(), reps[True].to_dict()
    assert d_ser["waves"] > 0 and 0 < d_wav["waves"] <= d_ser["waves"]
    for s_ser, s_wav in zip(reps[False].steps, reps[True].steps):
        assert s_wav.n_kernels == s_ser.n_kernels and s_wav.n_waves <= s_ser.n_waves


@pytest.fixture(scope="module")
def executed_fused_ci():
    """The pinned CI stream at side 16, fused with async waves, through both
    packages under one step clock: (port arena, reference arena)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jex, "time", StepClock())
        mp.setattr(tex, "time", StepClock())
        _, at = tserve.run_arena_executed(12, 6, side=16, device=CPU, fused=True,
                                          async_groups=True, **CI)
        _, aj = jserve.run_arena_executed(12, 6, side=16, fused=True, async_groups=True, **CI)
    return at, aj


@pytest.mark.parametrize("policy", sorted(tserve.EXECUTED_POLICIES))
def test_executed_fused_async_arena_counters_equal_reference(executed_fused_ci, policy):
    at, aj = executed_fused_ci
    dt, dj = at.reports[policy].to_dict(), aj.reports[policy].to_dict()
    keys = ("fused_steps", "waves", "cache_hits", "cache_misses", "transfers",
            "bytes_moved", "kernels", "reexecuted", "redispatched", "admitted_late")
    assert {k: dt[k] for k in keys} == {k: dj[k] for k in keys}
    assert dt["total_makespan_ms"] == pytest.approx(dj["total_makespan_ms"])
    assert dt["overlap_ms"] == pytest.approx(dj["overlap_ms"])
    assert dt["cache_hits"] + dt["cache_misses"] == dt["fused_steps"]
    assert 0 < dt["waves"] <= dt["fused_steps"]
    assert sum(dt["kernels_by_op"].values()) >= dt["kernels"]
    assert dt["static_copies"] == 0  # CPU groups replay no CUDA graph


def test_cli_runs_fused_async_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "b.json"
    tserve.main(["--arena", "--execute", "--fused", "--async-groups", "--requests", "3",
                 "--decode-chunks", "2", "--steps", "2", "--kernel-side", "8",
                 "--device", "cpu", "--bench-out", str(out)])
    text = capsys.readouterr().out
    assert "fused super-steps, async waves" in text
    import json

    doc = json.loads(out.read_text())
    assert doc["meta"]["fused"] is True and doc["meta"]["async_groups"] is True
    assert all(d["fused_steps"] > 0 and d["waves"] > 0 for d in doc["executed"].values())
