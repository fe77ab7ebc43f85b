"""The port's executor (repro_torch.core.executor) against the JAX reference.

Both packages run the same paper DAG under the same ``gp`` assignment on the
same inputs: the reference's ``attach_matrix_kernels`` arrays, carried into
the port with ``inputs_from_numpy``.  Every group aliases one CPU device in
both.  Outputs match exactly for matadd and at the reference suite's f32
tolerance for matmul; the transfer / placement / re-execution counters are
equal.  The session cases mirror tests/test_serving.py's.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.core import cost as jcost
from repro.core.comm import CommEngine as JCommEngine
from repro.core.comm import Topology as JTopology
from repro.core.cost import PCIE3_X16 as JPCIE3_X16
from repro.core import executor as jex
from repro.core import graph as jgraph
from repro.core import schedulers as jsched
from repro.core import simulate as jsim
from repro_torch.core import cost as tcost
from repro_torch.core import executor as tex
from repro_torch.core import graph as tgraph
from repro_torch.core import schedulers as tsched
from repro_torch.core import simulate as tsim
from repro_torch.core.comm import CommEngine, Topology
from repro_torch.core.cost import PCIE3_X16

JDEV = jax.devices()[0]
CPU = torch.device("cpu")
KV = 1 << 20


def _paper_case(op: str, side: int):
    """(reference graph, port graph, gp assignment) for the paper DAG."""
    gj = jcost.paper_calibrated_model().weight_graph(
        jgraph.generate_paper_dag(op), {op: side})
    gt = tcost.paper_calibrated_model().weight_graph(
        tgraph.generate_paper_dag(op), {op: side})
    pj = jsched.make_policy("gp")
    jsim.simulate(gj, pj, jsim.make_cpu_gpu_platform())
    pt = tsched.make_policy("gp")
    tsim.simulate(gt, pt, tsim.make_cpu_gpu_platform())
    assert pt.assignment == pj.assignment  # the copied partitioner agrees
    return gj, gt, pj.assignment


def _run_both(op: str, side: int, assignment=None):
    gj, gt, gp = _paper_case(op, side)
    assignment = gp if assignment is None else assignment
    # entries of std 1/sqrt(side) keep a matmul chain's scale fixed (the
    # reference's unit-normal blocks overflow f32 along the DAG's depth)
    scale = 1.0 / np.sqrt(side) if op == "matmul" else 1.0
    host = {
        k: np.asarray(v) * np.float32(scale)
        for k, v in jex.attach_matrix_kernels(gj, side).items()
    }
    arrays = {k: jax.numpy.asarray(v) for k, v in host.items()}
    tex.attach_matrix_kernels(gt, side)
    inputs = tex.inputs_from_numpy(host, CPU)
    rj = jex.JaxExecutor({"cpu": JDEV, "gpu": JDEV}).run(gj, assignment, arrays)
    rt = tex.TorchExecutor({"cpu": CPU, "gpu": CPU}).run(gt, assignment, inputs)
    return rj, rt


def _same_counters(rj, rt):
    assert rt.n_transfers == rj.n_transfers
    assert rt.bytes_transferred == rj.bytes_transferred
    assert rt.kernels_per_group == rj.kernels_per_group
    assert rt.reexecuted == rj.reexecuted
    assert set(rt.outputs) == set(rj.outputs)


def test_paper_dag_matadd_bit_exact_with_reference():
    rj, rt = _run_both("matadd", 64)
    _same_counters(rj, rt)
    assert rt.n_transfers > 0  # gp cuts the DAG: the pulls are exercised
    for n, arr in rj.outputs.items():
        np.testing.assert_array_equal(rt.outputs[n].numpy(), np.asarray(arr))


def test_paper_dag_matmul_allclose_with_reference():
    rj, rt = _run_both("matmul", 32)
    _same_counters(rj, rt)
    for n, arr in rj.outputs.items():
        want = np.asarray(arr)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(rt.outputs[n].numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("placement", ["gpu", "cpu"])
def test_paper_dag_single_group_zero_transfers(placement):
    gj, gt, _ = _paper_case("matmul", 16)
    one = {n: placement for n in gj.nodes}
    rj, rt = _run_both("matmul", 16, one)
    _same_counters(rj, rt)
    # inputs are seeded on the lexicographically-first group ("cpu")
    assert rt.n_transfers == (0 if placement == "cpu" else rj.n_transfers)


def _chain(pkg):
    """a (prefill) -> b -> c (decode chain), as in tests/test_serving.py."""
    g = pkg.TaskGraph()
    g.add("a", op="prefill", costs={"big": 2.0, "small": 6.0}, out_bytes=KV)
    g.add("b", op="decode", costs={"big": 1.0, "small": 3.0}, out_bytes=KV)
    g.add("c", op="decode", costs={"big": 1.0, "small": 3.0}, out_bytes=KV)
    g.add_edge("a", "b", nbytes=KV)
    g.add_edge("b", "c", nbytes=KV)
    g.validate()
    return g


def _chain_pair(side=8):
    gj, gt = _chain(jgraph), _chain(tgraph)
    arrays = jex.attach_request_kernels(gj, side)
    tex.attach_request_kernels(gt, side)
    inputs = tex.inputs_from_numpy({k: np.asarray(v) for k, v in arrays.items()}, CPU)
    return gj, gt, arrays, inputs


def test_host_group_default_is_deterministic_and_explicit_works():
    gj, gt, arrays, inputs = _chain_pair()
    ex = tex.TorchExecutor({"zeta": CPU, "alpha": CPU})
    assert ex.resolve_host_group() == "alpha"
    assert ex.resolve_host_group("zeta") == "zeta"
    with pytest.raises(KeyError):
        ex.resolve_host_group("nope")
    jx = jex.JaxExecutor({"zeta": JDEV, "alpha": JDEV})
    place = {n: "zeta" for n in gt.nodes}
    for host in ("zeta", None):
        rt = ex.run(gt, place, inputs, host_group=host)
        rj = jx.run(gj, place, arrays, host_group=host)
        _same_counters(rj, rt)
        assert sum(rt.kernels_per_group.values()) == 3
        assert rt.n_transfers == (0 if host == "zeta" else 1)
        np.testing.assert_allclose(rt.outputs["c"].numpy(), np.asarray(rj.outputs["c"]),
                                   rtol=2e-4, atol=2e-4)


def test_session_times_kernels_and_evicts_with_recompute():
    gj, gt, arrays, inputs = _chain_pair()
    place = {"a": "g0", "b": "g1", "c": "g0"}
    results = []
    for ex, g, ins in ((jex.JaxExecutor({"g0": JDEV, "g1": JDEV}), gj, arrays),
                       (tex.TorchExecutor({"g0": CPU, "g1": CPU}), gt, inputs)):
        s = ex.session(g, place, ins, time_kernels=True)
        assert s.step().name == "a"
        assert s.step().name == "b"
        # g1 dies holding the only copy of b's output, which pending c needs
        assert s.evict_group("g1") == ["b"]
        s.reassign({"b": "g0", "c": "g0"})
        s.run_all()
        assert s.done()
        results.append(s.result())
    rj, rt = results
    _same_counters(rj, rt)
    assert rt.reexecuted == ["b"]
    assert sum(rt.kernels_per_group.values()) == 4
    assert set(rt.kernel_ms) == {"a", "b", "c"}
    assert all(ms >= 0.0 for ms in rt.kernel_ms.values())
    np.testing.assert_allclose(rt.outputs["c"].numpy(), np.asarray(rj.outputs["c"]),
                               rtol=2e-4, atol=2e-4)


def test_session_arrival_gate():
    _, gt, _, inputs = _chain_pair()
    s = tex.TorchExecutor({"g0": CPU}).session(
        gt, {n: "g0" for n in gt.nodes}, inputs, gated={"a"})
    assert s.next_ready() is None  # whole chain blocked on the gate
    s.admit(["a"], at=5.0)
    assert s.earliest["a"] == 5.0
    s.run_all()
    assert s.done()


def test_comm_session_matches_reference_lane_model():
    """With a comm engine attached (prefetch on), transfers, bytes and the
    virtual timeline under zero-width kernels agree with the reference."""
    gj, gt, gp = _paper_case("matadd", 32)
    arrays = jex.attach_matrix_kernels(gj, 32)
    tex.attach_matrix_kernels(gt, 32)
    inputs = tex.inputs_from_numpy({k: np.asarray(v) for k, v in arrays.items()}, CPU)
    nodes = {"cpu": 0, "gpu": 1}
    sj = jex.JaxExecutor({"cpu": JDEV, "gpu": JDEV}).session(
        gj, gp, arrays, group_nodes=nodes,
        comm=JCommEngine(JTopology.dedicated(JPCIE3_X16, lanes=2)))
    st = tex.TorchExecutor({"cpu": CPU, "gpu": CPU}).session(
        gt, gp, inputs, group_nodes=nodes,
        comm=CommEngine(Topology.dedicated(PCIE3_X16, lanes=2)))
    sj.run_all()
    st.run_all()
    rj, rt = sj.result(), st.result()
    _same_counters(rj, rt)
    assert rt.n_prefetched == rj.n_prefetched > 0
    assert rt.lane_busy_ms == pytest.approx(rj.lane_busy_ms)
    assert rt.model_makespan_ms == pytest.approx(rj.model_makespan_ms)


def test_stream_put_reassembles_bit_identically():
    gt = _chain(tgraph)
    inputs = tex.attach_request_kernels(gt, 8)
    s = tex.TorchExecutor({"g0": CPU}).session(gt, {n: "g0" for n in gt.nodes}, inputs)
    x = torch.arange(70, dtype=torch.float32).reshape(10, 7)
    for n_chunks in (1, 3, 4, 10, 32):
        assert torch.equal(s._stream_put(x, CPU, n_chunks), x)


def test_attach_draws_seeded_host_inputs():
    g1, g2 = _chain(tgraph), _chain(tgraph)
    a = tex.attach_request_kernels(g1, 8)
    b = tex.attach_request_kernels(g2, 8)
    assert set(a) == {"a/in"}
    assert a["a/in"].device.type == "cpu" and a["a/in"].dtype == torch.float32
    assert torch.equal(a["a/in"], b["a/in"])
    c = tex.attach_matrix_kernels(_chain_mm(), 8, dtype="bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in c.values())


def _chain_mm():
    g = tgraph.TaskGraph()
    g.add("x", op="matmul", costs={"gpu": 1.0}, out_bytes=KV)
    g.add("y", op="matadd", costs={"gpu": 1.0}, out_bytes=KV)
    g.add_edge("x", "y", nbytes=KV)
    g.validate()
    return g


def test_measured_cost_model_times_torch_callables():
    m = tcost.MeasuredCostModel(
        impls={"cpu": lambda op, n: (lambda: torch.ones(n, n) @ torch.ones(n, n))},
        repeats=3)
    assert m.kernel_ms("matmul", 16, "cpu") >= 0.0
    assert m.observe("decode", 16, "big", 10.0) == pytest.approx(10.0)
    assert m.observe("decode", 16, "big", 20.0) == pytest.approx(13.0)
