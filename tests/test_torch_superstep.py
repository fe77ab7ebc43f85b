"""The port's fused super-steps (``ExecSession(fused=True)``) against the JAX
reference: the cases of tests/test_superstep.py, run through both packages.

Every group aliases one CPU device in both.  The reference's inputs
(``attach_matrix_kernels``) are carried into the port with
``inputs_from_numpy``.  On a CPU group the port calls the chain as it is
(CUDA graphs do not exist there), under the same cache key and with the same
hit/miss accounting as on the card.  Within the port the fused outputs equal
the unfused ones bit for bit; against the reference's fused outputs they
agree at the reference suite's 1e-5.  The plan, donation, materialization,
cache and eviction counters are equal.

Serving runs measure kernel times, and arrivals and drops land on that
measured clock, so their fused counters follow the host's speed (two runs of
the reference differ).  The serving cases therefore run both executors
under one step clock: every reading of ``time.perf_counter`` inside the
executor modules advances it by 0.1 ms, so each timed group-step measures
the same and the two packages must agree exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import executor as jex
from repro.core import graph as jgraph
from repro.core import online as jonline
from repro.core import serving as jserving
from repro.core.arena import make_request_stream as jstream
from repro.core.schedulers import make_policy as jpolicy
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro_torch.core import executor as tex
from repro_torch.core import graph as tgraph
from repro_torch.core import online as tonline
from repro_torch.core import serving as tserving
from repro_torch.core.arena import make_request_stream as tstream
from repro_torch.core.schedulers import make_policy as tpolicy
from repro_torch.kernels import graphs, ops
from repro_torch.launch import serve as tserve

JDEV = jax.devices()[0]
CPU = torch.device("cpu")
KV = 1 << 16
SIDE = 8
TOL = dict(rtol=1e-5, atol=1e-5)  # the reference suite's


class StepClock:
    """Stands in for the ``time`` module of both executors: every
    ``perf_counter`` reading advances by ``dt`` seconds."""

    def __init__(self, dt: float = 1e-4):
        self.t, self.dt = 0.0, dt

    def perf_counter(self) -> float:
        self.t += self.dt
        return self.t


@pytest.fixture
def step_clock(monkeypatch):
    monkeypatch.setattr(jex, "time", StepClock())
    monkeypatch.setattr(tex, "time", StepClock())


# -- graphs, built alike in both packages --------------------------------------

def _chain(pkg, n, group="g0", op="matadd"):
    g = pkg.TaskGraph()
    prev = None
    for i in range(n):
        name = f"k{i}"
        g.add(name, op=op, costs={group: 1.0}, out_bytes=SIDE * SIDE * 4)
        if prev is not None:
            g.add_edge(prev, name, nbytes=SIDE * SIDE * 4)
        prev = name
    g.validate()
    return g


def _diamond(pkg):
    """a(matmul) fans out to two group-split branches that re-join."""
    g = pkg.TaskGraph()
    g.add("a", op="matmul", costs={"g0": 1.0}, out_bytes=KV)
    g.add("b", op="matadd", costs={"g0": 1.0}, out_bytes=KV)
    g.add("c", op="matmul", costs={"g1": 1.0}, out_bytes=KV)
    g.add("d", op="matadd", costs={"g0": 1.0, "g1": 1.0}, out_bytes=KV)
    for e in [("a", "b"), ("a", "c"), ("b", "d"), ("c", "d")]:
        g.add_edge(*e, nbytes=KV)
    g.validate()
    return g


def _donation_graph(pkg):
    g = pkg.TaskGraph()
    g.add("a", op="matadd", costs={"g1": 1.0}, out_bytes=KV)
    g.add("x", op="matadd", costs={"g0": 1.0}, out_bytes=KV)
    g.add("b", op="matadd", costs={"g1": 1.0}, out_bytes=KV)
    g.add("c", op="matadd", costs={"g1": 1.0}, out_bytes=KV)
    g.add_edge("a", "b", nbytes=KV)
    g.add_edge("x", "b", nbytes=KV)
    g.add_edge("b", "c", nbytes=KV)
    g.validate()
    return g


def _three_group_graph(pkg):
    g = pkg.TaskGraph()
    chains = {"g0": ("a0", "a1"), "g1": ("b0", "b1"), "g2": ("c0", "c1")}
    for grp, (u, v) in chains.items():
        g.add(u, op="matadd", costs={grp: 1.0}, out_bytes=KV)
        g.add(v, op="matadd", costs={grp: 1.0}, out_bytes=KV)
        g.add_edge(u, v, nbytes=KV)
    g.validate()
    asg = {"a0": "g0", "a1": "g0", "b0": "g1", "b1": "g1", "c0": "g2", "c1": "g2"}
    return g, asg


def _pair(build):
    """(reference graph, its jax inputs, port graph, the same inputs as
    tensors), with the paper's MA/MM kernels attached to both."""
    gj, gt = build(jgraph), build(tgraph)
    arrays = jex.attach_matrix_kernels(gj, SIDE)
    tex.attach_matrix_kernels(gt, SIDE)
    inputs = tex.inputs_from_numpy({k: np.asarray(v) for k, v in arrays.items()}, CPU)
    return gj, arrays, gt, inputs


def _sessions(pair, asg, groups, **kw):
    gj, arrays, gt, inputs = pair
    sj = jex.JaxExecutor({g: JDEV for g in groups}).session(gj, asg, arrays, **kw)
    st = tex.TorchExecutor({g: CPU for g in groups}).session(gt, asg, inputs, **kw)
    return sj, st


def _run(pair, asg, groups, **kw):
    sj, st = _sessions(pair, asg, groups, time_kernels=True, **kw)
    sj.run_all()
    st.run_all()
    return sj, sj.result(), st, st.result()


def _same_fused(sj, rj, st, rt):
    """The port's fused bookkeeping equals the reference's."""
    assert [(r.group, r.members, r.cache_hit, r.donated, r.n_transfers, r.nbytes)
            for r in st.superstep_runs] == [
        (r.group, r.members, r.cache_hit, r.donated, r.n_transfers, r.nbytes)
        for r in sj.superstep_runs]
    for f in ("fused_steps", "cache_hits", "cache_misses", "n_waves", "n_transfers",
              "bytes_transferred", "kernels_per_group", "reexecuted"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert set(st.blocks) == set(sj.blocks)
    assert set(rt.outputs) == set(rj.outputs)


def _close_to_reference(rt, rj, **tol):
    for n, arr in rj.outputs.items():
        np.testing.assert_allclose(rt.outputs[n].numpy(), np.asarray(arr), **(tol or TOL))


def _bit_equal(rt_a, rt_b):
    assert set(rt_a.outputs) == set(rt_b.outputs)
    for n, t in rt_a.outputs.items():
        assert torch.equal(t, rt_b.outputs[n]), n


# -- output parity: fused == unfused, and == the reference ---------------------

def test_fused_parity_single_chain():
    pair = _pair(lambda pkg: _chain(pkg, 6))
    asg = {n: "g0" for n in pair[2].nodes}
    _, _, _, unfused = _run(pair, asg, ["g0"], fused=False)
    sj, rj, st, rt = _run(pair, asg, ["g0"], fused=True)
    _bit_equal(rt, unfused)
    _close_to_reference(rt, rj)
    _same_fused(sj, rj, st, rt)
    assert rt.fused_steps == 1 and (rt.cache_misses, rt.cache_hits) == (1, 0)
    assert [r.members for r in st.superstep_runs] == [[f"k{i}" for i in range(6)]]


def test_fused_parity_multigroup_diamond_matmul_matadd():
    pair = _pair(_diamond)
    asg = {"a": "g0", "b": "g0", "c": "g1", "d": "g0"}
    _, _, _, unfused = _run(pair, asg, ["g0", "g1"], fused=False)
    sj, rj, st, rt = _run(pair, asg, ["g0", "g1"], fused=True)
    _bit_equal(rt, unfused)
    _close_to_reference(rt, rj)
    _same_fused(sj, rj, st, rt)
    assert rt.fused_steps >= 2
    assert sum(len(r.members) for r in st.superstep_runs) == 4


def test_fused_parity_flash_attention_and_wkv6_with_reshapes():
    """K3 at head_dim 4 and K4 at N 4 inside one typed chain, with reshapes
    between them.  The port's ``ops.wkv6`` returns ``(o, state)`` where the
    reference's returns ``o``: the port's chain takes ``[0]``."""
    B, H, S, N = 1, 2, 8, 4

    def jfns():
        def attn(x):
            return jops.flash_attention(x[0], x[1], x[2], causal=True)

        def wkv(y):
            return jops.wkv6(jnp.tanh(y), y, y, jax.nn.sigmoid(y),
                             jnp.ones((H, N), y.dtype) * 0.5)

        return {"attn": attn, "wkv": wkv, "squash": lambda z: z.reshape(B * H * S, N)}

    def tfns():
        def attn(x):
            return ops.flash_attention(x[0], x[1], x[2], causal=True)

        def wkv(y):
            u = torch.full((H, N), 0.5, dtype=y.dtype, device=y.device)
            return ops.wkv6(torch.tanh(y), y, y, torch.sigmoid(y), u)[0]

        return {"attn": attn, "wkv": wkv, "squash": lambda z: z.reshape(B * H * S, N)}

    def build(pkg):
        g = pkg.TaskGraph()
        g.add("qkv", op="attn", costs={"g0": 1.0}, out_bytes=KV)
        g.add("mix", op="wkv", costs={"g0": 1.0}, out_bytes=KV)
        g.add("out", op="squash", costs={"g0": 1.0}, out_bytes=KV)
        g.add_edge("qkv", "mix", nbytes=KV)
        g.add_edge("mix", "out", nbytes=KV)
        g.validate()
        return g

    gj, gt = build(jgraph), build(tgraph)
    for g, fns in ((gj, jfns()), (gt, tfns())):
        for k in g.nodes.values():
            k.fn = fns[k.op]
    x = np.random.default_rng(7).standard_normal((3, B, H, S, N)).astype(np.float32)
    pair = (gj, {"qkv/in": jnp.asarray(x)}, gt, tex.inputs_from_numpy({"qkv/in": x}, CPU))
    asg = {n: "g0" for n in gt.nodes}
    _, _, _, unfused = _run(pair, asg, ["g0"], fused=False)
    sj, rj, st, rt = _run(pair, asg, ["g0"], fused=True)
    _bit_equal(rt, unfused)
    _close_to_reference(rt, rj, rtol=1e-4, atol=1e-5)  # the reference's own case
    _same_fused(sj, rj, st, rt)
    assert rt.fused_steps == 1


# -- donation and materialization ---------------------------------------------

def test_fused_donates_sole_copy_dead_inputs_only():
    """Gate x so a's step runs alone first: when the b/c chain dispatches, a
    is a prior-step output whose only copy lives on g1 with every consumer
    in-chain.  Torch has no donation: the port drops the copy after the
    chain read it and records it as donated, as the reference does."""
    pair = _pair(_donation_graph)
    asg = {"a": "g1", "x": "g0", "b": "g1", "c": "g1"}
    sessions = _sessions(pair, asg, ["g0", "g1"], time_kernels=True, fused=True, gated=["x"])
    for s in sessions:
        assert s.step().name == "a"
        s.admit(["x"])
        s.run_all()
    sj, st = sessions
    rj, rt = sj.result(), st.result()
    _same_fused(sj, rj, st, rt)
    _close_to_reference(rt, rj)
    by_members = {tuple(r.members): r for r in st.superstep_runs}
    assert by_members[("b", "c")].donated == ["a"]
    assert "a" not in st.valid and "x" in st.valid
    assert set(st.valid) == set(sj.valid)


def test_fused_materializes_only_live_outputs():
    pair = _pair(lambda pkg: _chain(pkg, 4))
    asg = {n: "g0" for n in pair[2].nodes}
    _, _, st_unfused, _ = _run(pair, asg, ["g0"], fused=False)
    sj, rj, st, rt = _run(pair, asg, ["g0"], fused=True)
    assert set(st_unfused.blocks) == {"k0", "k1", "k2", "k3"}
    assert set(st.blocks) == set(sj.blocks) == {"k3"}
    assert list(rt.outputs) == ["k3"]
    assert all(n in st.kernel_ms for n in pair[2].nodes)


def test_eviction_requeues_unmaterialized_chain_transitively():
    def build(pkg):
        g = _chain(pkg, 3)
        g.add("k3", op="matadd", costs={"g1": 1.0}, out_bytes=SIDE * SIDE * 4)
        g.add_edge("k2", "k3", nbytes=SIDE * SIDE * 4)
        g.validate()
        return g

    pair = _pair(build)
    asg = {"k0": "g0", "k1": "g0", "k2": "g0", "k3": "g1"}
    sessions = _sessions(pair, asg, ["g0", "g1"], time_kernels=True, fused=True)
    for s in sessions:
        for _ in range(3):  # drain the g0 super-step's replayed records
            assert s.step().group == "g0"
        assert set(s.blocks) == {"k2"}
        assert s.evict_group("g0") == ["k2", "k1", "k0"]
        s.run_all()
    sj, st = sessions
    rj, rt = sj.result(), st.result()
    assert rt.reexecuted == ["k2", "k1", "k0"]
    _same_fused(sj, rj, st, rt)
    _, _, _, unfused = _run(pair, asg, ["g0", "g1"], fused=False)
    _bit_equal(rt, unfused)
    _close_to_reference(rt, rj)


def test_fused_wall_time_apportioned_by_cost_weights():
    def build(pkg):
        g = pkg.TaskGraph()
        g.add("a", op="matadd", costs={"g0": 3.0}, out_bytes=KV)
        g.add("b", op="matadd", costs={"g0": 1.0}, out_bytes=KV)
        g.add_edge("a", "b", nbytes=KV)
        g.validate()
        return g

    pair = _pair(build)
    _, _, st, rt = _run(pair, {"a": "g0", "b": "g0"}, ["g0"], fused=True)
    (run,) = st.superstep_runs
    assert run.ms > 0.0
    assert rt.kernel_ms["a"] == pytest.approx(0.75 * run.ms)
    assert rt.kernel_ms["b"] == pytest.approx(0.25 * run.ms)
    assert sum(rt.kernel_ms.values()) == pytest.approx(run.ms)


# -- the cache of captured group-steps ------------------------------------------

def _cache_runs(pair, asg, groups, moves):
    """Run (assignment, revision) after (assignment, revision) through one
    cache per package; -> [(reference result, port result, port session)]."""
    cj, ct = jex.SuperStepCache(), tex.SuperStepCache()
    out = []
    for a, rev in moves:
        sj, st = _sessions(pair, a, groups, time_kernels=True, fused=True, revision=rev)
        sj.cache, st.cache = cj, ct
        sj.run_all()
        st.run_all()
        out.append((sj.result(), st.result(), st))
    assert len(ct) == len(cj)
    return out


def test_cache_hits_on_unchanged_revision():
    g_asg = _three_group_graph(tgraph)[1]
    pair = _pair(lambda pkg: _three_group_graph(pkg)[0])
    runs = _cache_runs(pair, g_asg, ["g0", "g1", "g2"], [(g_asg, 0), (g_asg, 0)])
    (rj1, rt1, _), (rj2, rt2, _) = runs
    assert (rt1.cache_misses, rt1.cache_hits) == (rj1.cache_misses, rj1.cache_hits) == (3, 0)
    assert (rt2.cache_misses, rt2.cache_hits) == (rj2.cache_misses, rj2.cache_hits) == (0, 3)
    _bit_equal(rt1, rt2)


def test_boundary_move_recaptures_only_affected_groups():
    asg = _three_group_graph(tgraph)[1]
    moved = dict(asg, a1="g1")
    pair = _pair(lambda pkg: _three_group_graph(pkg)[0])
    runs = _cache_runs(pair, asg, ["g0", "g1", "g2"], [(asg, 0), (moved, 0), (moved, 0)])
    (_, _, _), (rj, rt, st), (rj3, rt3, _) = runs
    assert (rt.cache_hits, rt.cache_misses) == (rj.cache_hits, rj.cache_misses) == (2, 2)
    fresh = sorted(tuple(r.members) for r in st.superstep_runs if not r.cache_hit)
    assert fresh == [("a0",), ("a1",)]
    assert rt3.cache_misses == rj3.cache_misses == 0


def test_revision_bump_invalidates_every_group():
    asg = _three_group_graph(tgraph)[1]
    pair = _pair(lambda pkg: _three_group_graph(pkg)[0])
    (_, _, _), (rj, rt, _) = _cache_runs(pair, asg, ["g0", "g1", "g2"], [(asg, 0), (asg, 1)])
    assert (rt.cache_hits, rt.cache_misses) == (rj.cache_hits, rj.cache_misses) == (0, 3)


class _Entry:
    def __init__(self):
        self.released = 0

    def release(self):
        self.released += 1


def test_cache_is_bounded_and_releases_what_it_drops():
    """An evicted entry has its CUDA graph and memory pool released once the
    running group-step or wave has replayed (``release_dropped``), and every
    entry on ``clear``; the counters follow the reference's cache."""
    ct, cj = tex.SuperStepCache(max_entries=2), jex.SuperStepCache(max_entries=2)
    entries = [_Entry() for _ in range(4)]
    for i in range(4):
        ct.get_or_build(("sig", i), lambda i=i: entries[i])
        cj.get_or_build(("sig", i), lambda: object())
    assert len(ct) == len(cj) == 2
    assert (ct.misses, ct.hits) == (cj.misses, cj.hits) == (4, 0)
    assert [e.released for e in entries] == [0, 0, 0, 0]  # a wave may still hold them
    ct.release_dropped()
    assert [e.released for e in entries] == [1, 1, 0, 0]
    assert ct.get_or_build(("sig", 3), lambda: None) == (entries[3], True)
    ct.clear()
    assert len(ct) == 0 and [e.released for e in entries] == [1, 1, 1, 1]


def test_online_revision_bumps_only_on_full_repartition():
    third = 1.0 / 3.0
    targets = {"g0": third, "g1": third, "g2": third}
    states = []
    for pkg, online in ((jgraph, jonline), (tgraph, tonline)):
        g, _ = _three_group_graph(pkg)
        p = online.OnlinePartitioner(targets, seed=1)
        p.ingest(g)
        assert p.revision == p.n_full
        r = p.revision
        p.ingest(g.copy())  # warm ingest of an identical revision: no escalation
        assert p.n_full == r and p.revision == r
        p._full_repartition("test escalation")
        assert p.revision == r + 1
        states.append((r, dict(p.assignment)))
    assert states[0] == states[1]


# -- the pieces a fused group-step is built from ---------------------------------

def _plan(st):
    """The port's chain plan in the shape of the reference's
    ``_plan_superstep``: (group, members), ``(None, [])`` when idle."""
    pl = st._plan_chain()
    return (None, []) if pl is None else (pl["grp"], pl["members"])


def test_plan_superstep_and_donatable_match_reference():
    pair = _pair(_donation_graph)
    asg = {"a": "g1", "x": "g0", "b": "g1", "c": "g1"}
    sj, st = _sessions(pair, asg, ["g0", "g1"], fused=True, gated=["x"])
    assert _plan(st) == sj._plan_superstep() == ("g1", ["a"])
    for s in (sj, st):
        s.step()
        s.admit(["x"])
    assert _plan(st) == sj._plan_superstep()
    for key in ("a", "x", "a/in", "x/in", "b"):
        for members in ({"b", "c"}, {"b"}):
            assert st._donatable(key, "g1", members) == sj._donatable(key, "g1", members)


def test_build_chain_drops_dead_intermediates_and_keeps_results():
    """A step output that is not kept is released after its last reader, so
    a captured graph's pool holds the chain's live set; results are the
    reference's composition."""
    alive = []

    def f(*xs):
        out = sum(xs) + 1
        alive.append(out)
        return out

    steps = [(f, [("ext", 0)]), (f, [("mem", 0)]), (f, [("mem", 1), ("ext", 1)]),
             (f, [("mem", 2), ("mem", 0)])]
    x, y = torch.ones(3), torch.full((3,), 2.0)
    got = ops.build_chain(steps, keep=[3])(x, y)
    want = jops.build_chain(steps, keep=[3])(x, y)
    assert len(got) == 1 and torch.equal(got[0], want[0])
    all_kept = ops.build_chain(steps)(x, y)
    assert [t.tolist() for t in all_kept] == [t.tolist() for t in
                                             jops.build_chain(steps)(x, y)]


def test_capture_needs_a_cuda_device_and_eager_chains_run_as_they_are():
    """No fallback: a CUDA graph is only ever captured on the card; a CPU
    group's chain runs as it is."""
    chain = ops.build_chain([(lambda a: a + 1, [("ext", 0)])])
    with pytest.raises(ValueError, match="CUDA"):
        graphs.CapturedChain(chain, [torch.zeros(2)], CPU)
    e = graphs.EagerChain(chain)
    assert torch.equal(e.replay([torch.zeros(2)])[0], torch.ones(2))
    e.release()


def test_replayed_launch_counts_add_back_by_path():
    """A replay adds its capture's counts, kernel by kernel and path by path;
    ``sign=-1`` takes a capture's counts back off."""
    before = ops.launch_counts()
    delta = {"matmul": {"wgmma": 2}, "matadd": {"copy": 1}, "flash_attention": {"pad": 1},
             "wkv6": {"ring": 3}}
    totals = {n: k.launches for n, k in ops.KERNELS.items()}
    ops.add_launches(delta)
    after = ops.launch_counts()
    for name, by in delta.items():
        for path, n in by.items():
            assert after[name][path] == before[name][path] + n
        assert ops.KERNELS[name].launches == totals[name] + sum(by.values())
    ops.add_launches(delta, sign=-1)
    assert ops.launch_counts() == before
    assert {n: k.launches for n, k in ops.KERNELS.items()} == totals


# -- serving integration (both packages under one step clock) -------------------

def _serving_pair(policy, **kw):
    js, ts = (jstream(3, base_requests=4, decode_chunks=3, kv_bytes=KV, seed=0),
              tstream(3, base_requests=4, decode_chunks=3, kv_bytes=KV, seed=0))
    jplat, tplat = jserve.heterogeneous_platform(), tserve.heterogeneous_platform()
    jx = jserving.ServingExecutor(jserving.groups_for_platform(jplat), jplat, side=16, **kw)
    tx = tserving.ServingExecutor(tserving.groups_for_platform(tplat, [CPU]), tplat,
                                  side=16, **kw)
    jp, tp = jpolicy(*policy), tpolicy(*policy)
    return jx.run_stream(js, jp), tx.run_stream(ts, tp), tp, tx, ts


FUSED_KEYS = ("fused_steps", "cache_hits", "cache_misses", "waves", "transfers",
              "bytes_moved", "kernels", "reexecuted", "redispatched", "admitted_late")


def _same_serving(rj, rt):
    dj, dt = rj.to_dict(), rt.to_dict()
    assert {k: dt[k] for k in FUSED_KEYS} == {k: dj[k] for k in FUSED_KEYS}
    assert dt["total_makespan_ms"] == pytest.approx(dj["total_makespan_ms"])
    for a, b in zip(rt.steps, rj.steps):
        assert (a.n_kernels, a.fused_steps, a.cache_hits, a.cache_misses, a.n_waves) == (
            b.n_kernels, b.fused_steps, b.cache_hits, b.cache_misses, b.n_waves)
    return dt


def test_fused_serving_stream_counters_and_feedback(step_clock):
    rj, rt, pol, _, stream = _serving_pair(("incremental-gp",), fused=True)
    d = _same_serving(rj, rt)
    assert d["fused_steps"] > 0 and d["cache_misses"] > 0
    assert d["cache_hits"] + d["cache_misses"] == d["fused_steps"]
    assert sum(d["kernels_by_op"].values()) == d["kernels"]
    for step, s in zip(stream, rt.steps):
        assert s.n_kernels == step.graph.num_nodes()
        assert s.kernel_ms_by_class
    assert pol.live_step_ms and all(v > 0 for v in pol.live_step_ms.values())


def test_fused_serving_cache_persists_across_intervals(step_clock):
    rj, rt, _, tx, _ = _serving_pair(("gp",), fused=True)
    d = _same_serving(rj, rt)
    assert d["cache_misses"] > 0 and d["cache_hits"] > 0
    assert tx.superstep_cache.hits == d["cache_hits"]
    n = len(tx.superstep_cache)
    assert n == d["cache_misses"]
    tx.close()  # the serving executor's end releases every captured graph
    assert len(tx.superstep_cache) == 0


def test_fused_ci_stream_bit_identical_simulated_total():
    """The fused path leaves the simulated CI stream where it was."""
    rows, _ = tserve.run_arena(12, 6, steps=5, drop_step=2, seed=0,
                               policies=("incremental-gp",))
    (row,) = rows
    assert round(row.total_makespan_ms, 2) == 3276.00
    assert row.transfers == 0
