"""The port's analyzers (``launch/flops.py`` and ``launch/hlo.py``), twins of
``tests/test_analyzers.py`` with its assertions: the FLOP count of a traced
step (a matmul exactly, its gradient, a loop, remat's recompute), the peak
of live bytes, the fusion-optimistic memory model (dots counted,
elementwise ops not, K3's region at its inputs and outputs), the unfused
memory walk and the collective log.

A torch step has no scan: the twins of the reference's scans are Python
loops, each of whose runs the trace sees.  The collective count is held
twice: against a hand count from the rules for a 2-layer granite train
step in Megatron TP on a (data 1, model 2) mesh, and as the log of that
step under the ``fake`` process group (one process, ``meta`` tensors: the
dry run's way) against the log of the same step over 2 real gloo
processes on the CPU: kind, bytes and count equal.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import multiprocessing
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

from repro_torch.kernels import ops
from repro_torch.launch import flops as F
from repro_torch.launch import hlo as H

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 120


def S64():
    return torch.empty(64, 64, device="meta")


def _flops(fn, *args) -> float:
    return F.trace_step(fn, *args)[1].flops


def test_dot_general_flops_exact():
    assert _flops(lambda a, b: a @ b, S64(), S64()) == 2 * 64 ** 3


def _grad(fn):
    def g(*xs):
        xs = [x.requires_grad_() for x in xs]
        return torch.autograd.grad(fn(*xs), xs)
    return g


def test_grad_counts_backward():
    n = _flops(_grad(lambda a, b: (a @ b).sum()), S64(), S64())
    assert n == pytest.approx(3 * 2 * 64 ** 3, rel=0.05)


def _loop(a, x, body, n=10):
    for _ in range(n):
        x = body(x, a)
    return x.sum()


def test_scan_multiplies_body():
    n = _flops(lambda a, x: _loop(a, x, lambda c, a: torch.tanh(c @ a)),
                           S64(), S64())
    assert n == pytest.approx(10 * 2 * 64 ** 3, rel=0.05)


def test_remat_scan_counts_recompute():
    from torch.utils.checkpoint import checkpoint

    def body(c, a):
        return checkpoint(lambda c, a: torch.tanh(c @ a), c, a, use_reentrant=False)

    n = _flops(_grad(lambda a, x: _loop(a, x, body)), S64(), S64())
    # fwd (1x) + recompute (1x) + bwd (2x) = 4 matmuls per layer
    assert n == pytest.approx(4 * 10 * 2 * 64 ** 3, rel=0.1)


def test_peak_live_bytes_orders_sanely():
    peak = F.trace_step(lambda a, b: (a @ b).sum(), S64(), S64())[1].peak
    assert 2 * 64 * 64 * 4 <= peak <= 16 * 64 * 64 * 4


def test_peak_live_bytes_keeps_what_the_backward_saves():
    """Activations saved for the backward stay live until it frees them:
    ten tanh outputs of a loop, 10 x 16 KiB above the inputs, and no more
    than the gradients once it is done."""
    seen = {}

    def f(a, x):
        a, x = a.requires_grad_(), x.requires_grad_()
        loss = _loop(a, x, lambda c, a: torch.tanh(c @ a))
        seen["before"] = trace_live()
        return torch.autograd.grad(loss, (a, x))

    with F.StepTrace().hold(a := S64(), x := S64()) as trace:
        def trace_live():
            return trace.live
        grads = f(a, x)
    assert seen["before"] >= 2 * 64 * 64 * 4 + 10 * 64 * 64 * 4
    assert trace.peak >= seen["before"]
    assert trace.live <= 4 * 64 * 64 * 4 + 64
    del grads


def test_memory_model_counts_dots_not_elementwise():
    def f(a, b):
        c = a @ b                 # counted: 3 x 16 KiB
        return torch.tanh(c) + 1.0   # fused: free
    assert F.trace_step(f, S64(), S64())[1].mem_bytes == 3 * 64 * 64 * 4


def test_memory_model_fusedkernel_region_is_io_only():
    """K3 with its LSE (the training forward) as one region: its memory
    traffic its inputs and outputs, its FLOPs the scores and P V over every
    block of the square."""
    B, Sq, K, G, hd = 1, 256, 2, 2, 32
    q = torch.empty(B, K * G, Sq, hd, device="meta", requires_grad=True)
    kv = torch.empty(B, K, Sq, hd, device="meta", requires_grad=True)

    def f(q, k, v):
        return ops.flash_attention(q, k, v, causal=True)

    _, trace = F.trace_step(f, q, kv, kv)
    io = (B * Sq * K * G * hd * 2 + 2 * B * Sq * K * hd) * 4 + B * K * G * Sq * 4
    assert trace.mem_bytes <= io * 1.05
    assert trace.op_counts["repro_torch.flash_attention_fwd"] == 1
    # flops still counted fully (scores + pv per block)
    assert trace.flops >= 2 * 2 * B * K * G * Sq * Sq * hd * 0.9


# -- the collective and memory walk ----------------------------------------------

def test_collective_wire_model():
    """The reference's wire model on one traced collective of each kind over
    a fake 8-rank mesh (a subprocess): an all-reduce moves twice its
    payload, an all-gather, a reduce-scatter and an all-to-all their output
    once, each over the axis its process group names."""
    out = _fake_subprocess("""
        x = torch.empty(8, 4096, 2048, dtype=torch.bfloat16, device="meta")
        with F.StepTrace() as trace:
            mesh.psum(x, "model")
            mesh.all_gather(x, "data", 0)
            mesh.psum_scatter(x, "model", 1)
            mesh.all_to_all(x[:4], "model")
        print(json.dumps(H.analyze(trace, mesh)["collectives"]))
    """)
    n = 8 * 4096 * 2048 * 2
    assert out["all-reduce"] == 2 * n
    assert out["all-gather"] == 2 * n
    assert out["reduce-scatter"] == n // 4
    assert out["all-to-all"] == n // 2
    assert out["total"] == 2 * n + 2 * n + n // 4 + n // 2
    assert out["per_kind_count"] == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1,
                                     "all-to-all": 1}
    assert out["per_axis"] == {"model": 2 * n + n // 4 + n // 2, "data": 2 * n}


def test_hlo_walker_multiplies_while_loops():
    def f(x):
        for _ in range(7):
            x = torch.tanh(x @ x)
        return x.sum()
    _, trace = F.trace_step(f, S64())
    stats = H.analyze(trace)
    # memory bytes must reflect ~7 x the dot traffic
    assert stats["mem_bytes"] >= 7 * 2 * 64 * 64 * 4
    assert stats["collectives"]["total"] == 0


def test_hlo_collectives_on_forced_multidevice():
    """A (data 2, model 4) mesh of a fake 8-rank group: a loop of 5 whose
    body contracts a "model"-sharded dimension and sums the partial
    products: each run's all-reduce is counted."""
    out = _fake_subprocess("""
        w = torch.empty(16, 64, device="meta")        # rank's rows of a (64, 64)
        x = torch.empty(4, 64, device="meta")         # rank's data block
        def f(w, x):
            for _ in range(5):
                y = torch.tanh(x[:, :16] @ w)
                x = mesh.psum(torch.cat([y] * 4, 1)[:, :64], "model")
            return x.sum()
        _, trace = F.trace_step(f, w, x)
        print(json.dumps(H.analyze(trace, mesh)["collectives"]))
    """)
    assert out["total"] > 0, out
    # in-loop collectives are counted each time the loop runs them (5)
    assert out["count"] >= 5, out


def _fake_subprocess(body: str) -> dict:
    """Run ``body`` as rank 0 of a fake 8-rank process group with ``mesh``
    a (data 2, model 4) mesh; it prints one JSON line."""
    import json

    code = textwrap.dedent("""
        import json, torch
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch import flops as F, hlo as H
        from repro_torch.launch.mesh import make_mesh
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
        mesh = make_mesh((2, 4), ("data", "model"))
    """) + textwrap.dedent(body)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# -- the collectives of a real step ---------------------------------------------

B, SEQ, LAYERS = 2, 16, 2


def _granite():
    from repro_torch.configs import registry as treg

    return dataclasses.replace(treg.get_config("granite_3_2b").smoke(), n_layers=LAYERS,
                               activation_dtype="float32", optstate_dtype="float32")


def _traced_step(device: str) -> dict:
    """The collective log of one TP train step of the 2-layer granite on a
    (data 1, model 2) mesh of the current process group, rank 0's blocks
    (``meta`` tensors or real CPU ones)."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import eval_specs, init_params
    from repro_torch.parallel.sharding import block, shard_tree, tree_shardings

    mesh = make_mesh((1, 2), ("data", "model"))
    step, p_specs, o_specs, ctx = tsteps.make_train_step(_granite(), mesh)
    if device == "meta":
        params, opt = eval_specs(p_specs), eval_specs(o_specs)
    else:
        params = init_params(p_specs, torch.Generator().manual_seed(0))
        opt = init_params(o_specs, torch.Generator().manual_seed(1))
    params = shard_tree(params, tree_shardings(p_specs, mesh, ctx.rules))
    opt = shard_tree(opt, tree_shardings(o_specs, mesh, ctx.rules))
    tokens = torch.zeros(B, SEQ, dtype=torch.int32, device=device)
    batch = {"tokens": tokens, "labels": tokens.clone()}
    b_sh = tsteps.shardings_for_batch(batch, mesh, ctx.rules)
    batch = {k: block(v, b_sh[k].spec, mesh) for k, v in batch.items()}
    _, trace = F.trace_step(step, params, opt, batch)
    return H.analyze(trace, mesh)["collectives"]


def _gloo_rank(rank: int, store: str, out_dir: str) -> None:
    torch.distributed.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                         world_size=2)
    try:
        torch.set_num_threads(1)
        log = _traced_step("cpu")
        if rank == 0:
            torch.save(log, os.path.join(out_dir, "gloo.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _hand_count() -> dict:
    """The all-reduces of the step from the rules (Megatron TP over "model"
    of 2, nothing else split): per (B, S, d) activation the embedding's sum
    over "model" and its backward, and per layer the attention's and the
    MLP's row-parallel sums, each run in the forward and in the backward,
    and the attention's again in the unit's recompute (5 a layer: the
    recompute stops at the last op whose output the backward saves, the
    MLP's output projection, before its sum); per CE chunk (one of 16
    positions) the vocab-parallel max, sum of exponentials and label logit
    (B, chunk) in the forward and the recompute, and the backward of the two
    sums (8); one flat sum of the replicated leaves' gradients (the final
    norm's and each layer's two norm scales: (1 + 2 L) d floats) and one of
    the sharded leaves' squared norms for the global clip (a scalar).  Wire
    bytes: twice the f32 payload."""
    d = _granite().d_model
    act, chunk = B * SEQ * d * 4, B * SEQ * 4
    payloads = [act] * (2 + 5 * LAYERS) + [chunk] * 8 + [(1 + 2 * LAYERS) * d * 4, 4]
    return {"all-reduce": 2 * sum(payloads), "count": len(payloads)}


def test_collectives_of_a_tp_train_step_fake_equal_real_and_the_rules(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    fake = _fake_subprocess("""
        dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
        import sys; sys.path.insert(0, "tests")
        from test_torch_analyzers import _traced_step
        print(json.dumps(_traced_step("meta")))
    """)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert not hung and [p.exitcode for p in procs] == [0, 0]
    real = torch.load(tmp_path / "gloo.pt", weights_only=True)
    want = _hand_count()
    for log in (fake, real):
        assert log["per_kind_count"] == {"all-reduce": want["count"]}, log
        assert log["all-reduce"] == want["all-reduce"] == log["total"]
        assert log["per_axis"] == {"model": want["all-reduce"]}
    assert fake["top_ops"] == real["top_ops"]
