"""Serving driver: the request-DAG scheduling arena, simulated and executed.

A batch of requests forms a task graph (prefill -> N decode chunks per
request); every policy places the request chains on heterogeneous device
groups (a big pod + a small pod) over a churning stream of scheduling
intervals.  ``--arena`` replays the stream through the discrete-event
simulator; ``--execute`` also runs it for real through
:class:`~repro_torch.core.serving.ServingExecutor`, where every ``prefill``
is the CUDA matmul kernel and every ``decode`` the CUDA matadd kernel, and
writes the metrics to ``--bench-out`` (the schema
``benchmarks/gate_serve.py`` reads).

  # policy-vs-policy table on a churning serving stream (simulated)
  PYTHONPATH=src python -m repro_torch.launch.serve --arena --requests 16 --steps 6

  # the same stream executed on the card at 2048 x 2048 f32 blocks
  PYTHONPATH=src python -m repro_torch.launch.serve --arena --execute \\
      --requests 12 --decode-chunks 6 --steps 5 --drop-step 2 --kernel-side 2048

  # ... or on the CPU, where the kernels' plain PyTorch versions run
  PYTHONPATH=src python -m repro_torch.launch.serve --arena --execute --device cpu

  # the zoo's other streams (MoE routing, speculative decoding, train/serve
  # colocation), simulated, with affinity-steal beside the default policies
  PYTHONPATH=src python -m repro_torch.launch.serve --arena --scenario moe

  # the fleet tier: 3 replicas behind the partition-affine router, every
  # routing mode, the last replica drained before step 2 (simulated)
  PYTHONPATH=src python -m repro_torch.launch.serve --arena --requests 24 --steps 4 \
      --replicas 3 --router all --drain-step 2

``--smoke`` serves a model: a batch of prompts prefilled, then greedy
decode, for every architecture of the repo (granite-3-2b, rwkv6-3b,
granite-moe-3b-a800m, minicpm3-4b, whisper-large-v3, llava-next-mistral-7b,
deepseek-moe-16b, jamba-1.5-large-398b, command-r-35b, ...), each at its
reduced width.  Prefill attention is the CUDA flash-attention kernel (K3),
the RWKV-6 recurrence the CUDA WKV6 kernel (K4), and Jamba's Mamba
recurrence plain tensor code, as in the reference, which has no kernel for
it; on the card each decode step is one replay of a captured CUDA graph
(:class:`DecodeGraph`).  At full width on one 80 GB card jamba is served
cut to the first five layers of its unit (``chip_smoke.py``).
Without ``--arena`` the request DAG is then simulated under ``--scheduler``
(``incremental-gp`` by default), or only that when ``--smoke`` is not given:

  # the reduced model, f32 activations, on the CPU (the kernels' plain versions)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b --smoke \
      --requests 2 --decode-len 4 --device cpu

  # one policy on the request DAG, simulated
  PYTHONPATH=src python -m repro_torch.launch.serve --scheduler gp
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from ..configs.registry import canon, get_config, make_batch
from ..core.arena import (
    DEFAULT_POLICIES,
    SCENARIOS,
    SchedulerArena,
    format_table,
    make_request_stream,
)
from ..core.comm import HierTopology, Topology
from ..core.cost import LEAF_NIC, POD_UPLINK, RACK_UPLINK, Link
from ..core.graph import TaskGraph
from ..core.router import MODES, ReplicaRouter, RouterReport, SimReplica
from ..core.schedulers import as_executed, make_policy
from ..core.serving import ServingExecutor, groups_for_platform
from ..core.simulate import Platform, Processor, WorkerDrop, simulate
from ..kernels import ops
from ..kernels.graphs import CapturedChain
from ..models import transformer as T
from ..models.layers import Ctx
from ..models.params import cast_params, init_params

# every policy runs in executed mode: gp/incremental-gp produce class
# assignments natively; eager/dmda/heft go through the worker-pull dispatch
# shim (repro_torch.core.schedulers.as_executed)
EXECUTED_POLICIES = ("eager", "dmda", "heft", "gp", "incremental-gp")


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def default_device(device=None) -> torch.device:
    """``device``, or ``cuda:0`` when none is given; raises when CUDA is
    missing: running on the CPU is asked for, never fallen back to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# 1) real decode loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """Times of one :func:`serve_smoke` run (host clock, each span ended by
    a device synchronise) and whether every logit it produced was finite.
    ``decode_ms_per_token`` covers the decode steps only: on the card the
    replays of the captured step, whose capture (warm-up included) is
    ``capture_ms`` (0 on the CPU, where the step runs eagerly)."""

    prefill_ms: float
    decode_ms_per_token: float
    tokens_per_s: float  # decoded tokens (all requests) per decode second
    logits_finite: bool
    capture_ms: float


class DecodeGraph:
    """``T.decode_step`` captured once into one CUDA graph and replayed once
    per token: the port's counterpart of the reference's ``jax.jit`` of the
    step.

    The graph's static buffers are the token buffer ``(B,)``, a one-element
    position buffer that the graph itself advances after each step, the
    cache tensors (``decode_step`` writes them in place; an encoder-decoder's
    nested cross-attention K/V it only reads), and ``params``.
    The warm-up before the capture executes the step, which would advance
    every RWKV and Mamba state by one token, so the tensors the step writes
    (all but the cross-attention K/V) are restored from a snapshot after the
    capture.  A capture or a replay that fails raises: there is no eager
    fallback."""

    def __init__(self, params, cache, tokens, pos: int, cfg, ctx: Ctx):
        device = tokens.device
        pos_t = torch.full((1,), pos, dtype=torch.long, device=device)

        def step(tok, p):
            logits, _ = T.decode_step(params, cache, tok, p, cfg, ctx)
            p.add_(1)
            return (logits,)

        written = _written_leaves(cache)
        saved = [t.clone() for t in written]
        self.chain = CapturedChain(step, (tokens, pos_t), device, warmup=1)
        for dst, src in zip(written, saved):
            dst.copy_(src)
        for dst, src in zip(self.chain.static_in, (tokens, pos_t)):
            dst.copy_(src)

    def __call__(self, tokens) -> torch.Tensor:
        """Decode one step from ``tokens``: the graph's logits buffer, which
        the next call overwrites."""
        self.chain.static_in[0].copy_(tokens)
        return self.chain.replay(clone=False)[0]

    def release(self) -> None:
        self.chain.release()


def _written_leaves(cache) -> list:
    """The cache tensors ``T.decode_step`` writes: every leaf but those of
    the ``cross`` subtrees (the encoder's K/V, which decode only reads)."""
    if isinstance(cache, dict):
        return [leaf for k in sorted(cache) if k != "cross"
                for leaf in _written_leaves(cache[k])]
    return [cache]


def serve_smoke(cfg, *, n_requests: int, prompt_len: int, decode_len: int,
                seed: int = 0, device=None, params=None, batch=None):
    """Prefill a batch of prompts, decode greedily.

    ``params`` (the f32 tree of :func:`T.model_param_specs`) default to
    ``init_params`` from ``seed`` on ``device``, each leaf cast to the
    activation dtype as it is drawn, and ``batch`` to ``make_batch`` from
    ``seed``; given ``params`` are cast once, here.  ``device`` defaults to
    ``cuda:0``.  On a CUDA device the decode step is captured once into one
    CUDA graph (:class:`DecodeGraph`) and replayed per token; on the CPU it
    runs eagerly.  Returns the greedy tokens ``(n_requests, decode_len + 1)`` on
    the host (the prefill's, then one per decode step) and a
    :class:`ServeStats`.

    Decode starts where the prefill's sequence ended (the patches and the
    text tokens of the batch), and the cache holds that many positions plus
    ``decode_len``.  The reference's ``serve_smoke`` starts the VLM
    ``n_patches`` later and sizes its cache ``n_patches`` longer, which
    leaves that many zero slots inside the window decode attends to
    (ROADMAP section 3, fault 6)."""
    device = default_device(device)
    ctx = Ctx(dtype=DTYPES[cfg.activation_dtype])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *a: None)
    graph = None
    with torch.inference_mode():
        if params is None:
            gen = torch.Generator(device).manual_seed(seed)
            params = init_params(T.model_param_specs(cfg), gen, ctx.dtype)
        else:
            params = cast_params(params, ctx.dtype)
        if batch is None:
            gen = torch.Generator(device).manual_seed(seed)
            batch = make_batch(cfg, prompt_len, n_requests, train=False, generator=gen)
        batch = {k: v.to(device) for k, v in batch.items()}

        pos0 = batch["tokens"].shape[1] + (batch["patch_embeds"].shape[1] if cfg.vlm else 0)
        cache_len = pos0 + decode_len
        sync(device)
        t0 = time.perf_counter()
        cache, logits = T.prefill(params, batch, cfg, ctx, cache_len=cache_len)
        tok = logits.argmax(-1)
        finite = torch.isfinite(logits).all()
        sync(device)
        t1 = time.perf_counter()
        t2 = t1
        try:
            if device.type == "cuda" and decode_len:
                graph = DecodeGraph(params, cache, tok, pos0, cfg, ctx)
                sync(device)
                t2 = time.perf_counter()

                def step(tok, i):
                    return graph(tok)
            else:
                def step(tok, i):
                    return T.decode_step(params, cache, tok, pos0 + i, cfg, ctx)[0]
            out_tokens = [tok]
            for i in range(decode_len):
                logits = step(tok, i)
                finite &= torch.isfinite(logits).all()
                tok = logits.argmax(-1)
                out_tokens.append(tok)
            sync(device)
            t3 = time.perf_counter()
        finally:
            if graph is not None:
                graph.release()
    tokens = torch.stack(out_tokens, 1).cpu()
    stats = ServeStats(
        prefill_ms=(t1 - t0) * 1e3,
        decode_ms_per_token=(t3 - t2) * 1e3 / max(decode_len, 1),
        tokens_per_s=n_requests * decode_len / (t3 - t2) if decode_len else 0.0,
        logits_finite=bool(finite),
        capture_ms=(t2 - t1) * 1e3,
    )
    return tokens, stats


# ---------------------------------------------------------------------------
# 2) request-DAG scheduling across heterogeneous groups
# ---------------------------------------------------------------------------


def request_dag(
    n_requests: int,
    decode_chunks: int,
    *,
    prefill_ms_big: float,
    prefill_ms_small: float,
    decode_ms_big: float,
    decode_ms_small: float,
    kv_bytes: int,
) -> TaskGraph:
    """One prefill kernel + a chain of decode-chunk kernels per request.
    Edge bytes = the KV cache handed from chunk to chunk (moving a request
    between groups pays a cache migration over the slow link — the paper's
    data-transfer cost in serving form)."""
    g = TaskGraph()
    for r in range(n_requests):
        g.add(
            f"r{r}.prefill",
            op="prefill",
            costs={"big": prefill_ms_big, "small": prefill_ms_small},
            out_bytes=kv_bytes,
        )
        prev = f"r{r}.prefill"
        for c in range(decode_chunks):
            name = f"r{r}.dec{c}"
            g.add(
                name,
                op="decode",
                costs={"big": decode_ms_big, "small": decode_ms_small},
                out_bytes=kv_bytes,
            )
            g.add_edge(prev, name, nbytes=kv_bytes)
            prev = name
    g.validate()
    return g


def heterogeneous_platform(
    link_gbps: float = 6.25,
    mem_capacity_bytes: dict | None = None,
    lanes: int = 2,
) -> Platform:
    """A big pod (fast class) + a small pod (slow class) over DCN.
    ``mem_capacity_bytes`` optionally budgets each pod's KV capacity
    (class -> bytes), turning memory pressure on in the simulator.
    The cross-pod DCN link carries ``lanes`` concurrent copy engines
    (per-link transfer lanes; KV migrations overlap with compute)."""
    procs = [
        Processor("big0", "big", 0),
        Processor("small0", "small", 1),
        Processor("small1", "small", 1),
    ]
    dcn = Link("dcn", bw=link_gbps * 1e9, latency_ms=0.05)
    return Platform(
        procs,
        link=dcn,
        host_node=0,
        mem_capacity_bytes=dict(mem_capacity_bytes or {}),
        topology=Topology.dedicated(dcn, lanes=lanes),
    )


def hierarchical_platform(
    n_pods: int = 2,
    *,
    pod_lanes: int = 1,
    rack_lanes: int = 1,
    leaf_lanes: int = 2,
    leaf: Link = LEAF_NIC,
    rack: Link = RACK_UPLINK,
    pod: Link = POD_UPLINK,
    mem_capacity_bytes: dict | None = None,
) -> Platform:
    """The rack/pod preset: each pod holds a big-class rack (1 worker) and a
    small-class rack (2 workers); classes are named ``pod<i>.big`` /
    ``pod<i>.small``.  Cross-rack traffic books both rack uplinks, cross-pod
    traffic additionally the two *shared* pod uplinks (``pod_lanes`` copy
    engines each) — the contention regime the hierarchy bench sweeps."""
    procs: list[Processor] = []
    node_rack: dict[int, str] = {}
    rack_pod: dict[str, str] = {}
    node = 0
    for p in range(n_pods):
        for cls_kind, n_workers in (("big", 1), ("small", 2)):
            cls = f"pod{p}.{cls_kind}"
            for j in range(n_workers):
                procs.append(Processor(f"{cls}.w{j}", cls, node))
            rack_name = f"r{node}"
            node_rack[node] = rack_name
            rack_pod[rack_name] = f"p{p}"
            node += 1
    topo = HierTopology(
        leaf=leaf,
        rack=rack,
        pod=pod,
        node_rack=node_rack,
        rack_pod=rack_pod,
        leaf_lanes=leaf_lanes,
        rack_lanes=rack_lanes,
        pod_lanes=pod_lanes,
    )
    return Platform(
        procs,
        link=pod,
        host_node=0,
        mem_capacity_bytes=dict(mem_capacity_bytes or {}),
        topology=topo,
    )


def hier_request_costs(
    platform: Platform,
    *,
    prefill_big: float = 20.0,
    prefill_small: float = 60.0,
    decode_big: float = 8.0,
    decode_small: float = 24.0,
) -> tuple[dict, dict]:
    """Per-class cost tables for request streams on a rack/pod platform
    (every pod's big class prices like ``big``, small like ``small``)."""
    prefill = {
        c: prefill_big if c.endswith("big") else prefill_small
        for c in platform.classes
    }
    decode = {
        c: decode_big if c.endswith("big") else decode_small for c in platform.classes
    }
    return prefill, decode


def _arena_setup(
    hier: bool, drop_proc: str
) -> tuple[Platform, str, dict | None, dict | None]:
    """Shared arena plumbing for the simulated and executed runners:
    (platform, drop_proc, costs_prefill, costs_decode).  On the rack/pod
    platform the default flat drop target remaps to its small-rack
    equivalent and the cost tables grow per-pod classes."""
    if not hier:
        return heterogeneous_platform(), drop_proc, None, None
    plat = hierarchical_platform()
    if drop_proc == "small1":
        drop_proc = "pod0.small.w1"
    costs_prefill, costs_decode = hier_request_costs(plat)
    return plat, drop_proc, costs_prefill, costs_decode


def _policy_kwargs(scheduler: str) -> dict:
    """Both GP flavours scale Formula (1)/(2) by per-class worker counts here
    (1 big worker vs 2 small ones — without it the big pod serializes)."""
    if scheduler in ("gp", "incremental-gp"):
        return {"scale_by_workers": True}
    return {}


def schedule_requests(
    n_requests: int, decode_chunks: int, scheduler: str, *, kv_mb: float = 64.0
) -> dict:
    """The ``n_requests`` x ``decode_chunks`` request DAG simulated under
    ``scheduler`` on the flat big/small platform: makespan, transfers, MiB
    moved and kernels per class (``--scheduler``)."""
    g = request_dag(
        n_requests,
        decode_chunks,
        prefill_ms_big=20.0,
        prefill_ms_small=60.0,
        decode_ms_big=8.0,
        decode_ms_small=24.0,
        kv_bytes=int(kv_mb * 2**20),
    )
    plat = heterogeneous_platform()
    pol = make_policy(scheduler, **_policy_kwargs(scheduler))
    res = simulate(g, pol, plat)
    return {
        "scheduler": scheduler,
        "makespan_ms": res.makespan_ms,
        "transfers": res.n_transfers,
        "bytes_moved_mb": res.bytes_transferred / 2**20,
        "per_class": res.kernels_per_class,
    }


def run_arena(
    n_requests: int,
    decode_chunks: int,
    *,
    steps: int = 6,
    kv_mb: float = 16.0,
    churn: float = 0.3,
    seed: int = 0,
    drop_step: int | None = None,
    drop_proc: str = "small1",
    policies=DEFAULT_POLICIES,
    hier: bool = False,
    scenario: str = "serve",
) -> tuple[list, SchedulerArena]:
    """Replay a churning request stream through every policy (the online
    serving experiment).  ``drop_step`` optionally kills ``drop_proc``
    mid-run at that step — the elastic path.  ``hier=True`` swaps in the
    rack/pod platform (shared-uplink contention + prefetch throttling).
    ``scenario`` selects a zoo generator (:data:`repro_torch.core.arena.SCENARIOS`)
    instead of the default prefill/decode stream; the non-serve scenarios
    cost their kernels for the flat big/small platform only."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}")
    if hier and scenario != "serve":
        raise ValueError("--hier only supports the 'serve' scenario")
    plat, drop_proc, costs_prefill, costs_decode = _arena_setup(hier, drop_proc)
    events_at = {}
    if drop_step is not None:
        # each step simulates on a fresh platform copy, so the death must be
        # re-injected: mid-run at the drop step, then at t=0 ever after
        events_at[drop_step] = (WorkerDrop(30.0, drop_proc),)
        for later in range(drop_step + 1, steps):
            events_at[later] = (WorkerDrop(0.0, drop_proc),)
    kw: dict = dict(
        base_requests=n_requests,
        churn=churn,
        kv_bytes=int(kv_mb * 2**20),
        seed=seed,
        arrival_spread_ms=10.0,
        events_at=events_at,
    )
    if scenario in ("serve", "colocate"):
        kw.update(
            decode_chunks=decode_chunks,
            costs_prefill=costs_prefill,
            costs_decode=costs_decode,
        )
    stream = SCENARIOS[scenario](steps, **kw)
    arena = SchedulerArena(
        plat, policies, policy_kwargs={p: _policy_kwargs(p) for p in policies}
    )
    rows = arena.run(stream)
    return rows, arena


def run_arena_executed(
    n_requests: int,
    decode_chunks: int,
    *,
    steps: int = 6,
    kv_mb: float = 16.0,
    churn: float = 0.3,
    seed: int = 0,
    drop_step: int | None = None,
    drop_proc: str = "small1",
    policies=EXECUTED_POLICIES,
    side: int = 48,
    drop_t_ms: float = 1.0,
    hier: bool = False,
    device: torch.device | None = None,
    fused: bool = False,
    async_groups: bool = False,
) -> tuple[list, SchedulerArena]:
    """The arena stream EXECUTED on real device groups.

    Same stream construction as :func:`run_arena`, but each interval is
    dispatched through :class:`~repro_torch.core.serving.ServingExecutor`:
    kernels run for real, per-kernel wall times feed the measured-cost /
    heartbeat loop, and drop events fire on the virtual stream clock
    (``drop_t_ms`` — virtual milliseconds, so a mid-interval drop actually
    lands mid-interval regardless of host speed).  ``hier=True`` executes on
    the rack/pod platform: every pull books the tiered lanes (shared-uplink
    contention + prefetch throttling), matching the simulated
    ``run_arena(hier=True)`` stream.  ``fused=True`` dispatches each
    group's runnable kernel chain as one captured super-step (a CUDA graph
    replay on the card, with a persistent cache of captured graphs) instead
    of kernel-at-a-time; ``async_groups=True`` additionally dispatches every
    group whose cross-group inputs are satisfied in the same dependency
    wave — one barrier per wave instead of per group (requires ``fused``).
    Every class runs on ``device`` (default ``cuda:0``; raises when CUDA is
    missing).  The captured graphs are released before this returns."""
    plat, drop_proc, costs_prefill, costs_decode = _arena_setup(hier, drop_proc)
    events_at = {}
    if drop_step is not None:
        events_at[drop_step] = (WorkerDrop(drop_t_ms, drop_proc),)
        for later in range(drop_step + 1, steps):
            events_at[later] = (WorkerDrop(0.0, drop_proc),)
    stream = make_request_stream(
        steps,
        base_requests=n_requests,
        decode_chunks=decode_chunks,
        churn=churn,
        kv_bytes=int(kv_mb * 2**20),
        seed=seed,
        costs_prefill=costs_prefill,
        costs_decode=costs_decode,
        arrival_spread_ms=0.5,
        events_at=events_at,
    )
    devices = None if device is None else [device]
    executor = ServingExecutor(groups_for_platform(plat, devices), plat, side=side,
                               fused=fused, async_groups=async_groups)
    factories = {
        p: (lambda n=p: as_executed(make_policy(n, **_policy_kwargs(n))))
        for p in policies
    }
    arena = SchedulerArena(plat, factories)
    try:
        rows = arena.run_executed(stream, executor)
    finally:
        executor.close()
    return rows, arena


def run_router(
    n_requests: int,
    decode_chunks: int,
    *,
    replicas: int = 3,
    mode: str = "affinity",
    steps: int = 6,
    kv_mb: float = 16.0,
    churn: float = 0.3,
    seed: int = 0,
    hier: bool = False,
    arrival_spread_ms: float = 40.0,
    burst_factor: float = 6.0,
    drain_step: int | None = None,
    drain_replica: str | None = None,
) -> RouterReport:
    """Fleet mode: ``replicas`` platform replicas behind a
    :class:`~repro_torch.core.router.ReplicaRouter`, fed one shared bursty
    (Markov ON/OFF) request stream.  Every replica runs a persistent
    ``incremental-gp`` policy, so the router's affinity score reads real
    partitioner residency.  ``drain_step`` gracefully drains a replica
    (default: the last one) before that step — proactive KV migration."""
    plat0 = hierarchical_platform() if hier else heterogeneous_platform()
    costs_prefill, costs_decode = (
        hier_request_costs(plat0) if hier else (None, None)
    )
    stream = make_request_stream(
        steps,
        base_requests=n_requests,
        decode_chunks=decode_chunks,
        churn=churn,
        kv_bytes=int(kv_mb * 2**20),
        seed=seed,
        costs_prefill=costs_prefill,
        costs_decode=costs_decode,
        arrival_spread_ms=arrival_spread_ms,
        arrival_mode="onoff",
        burst_factor=burst_factor,
    )
    reps = [
        SimReplica(
            f"r{i}",
            hierarchical_platform() if hier else heterogeneous_platform(),
            "incremental-gp",
            policy_kwargs=_policy_kwargs("incremental-gp"),
        )
        for i in range(replicas)
    ]
    router = ReplicaRouter(reps, mode=mode)
    drain_at = None
    if drain_step is not None:
        drain_at = {drain_step: drain_replica or f"r{replicas - 1}"}
    return router.run(stream, drain_at=drain_at)


def device_name(device) -> str:
    """What a result was measured on: the card's name, or ``cpu``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def write_bench(
    path: str, *, meta: dict, sim_rows=(), arena=None, device="cpu"
) -> dict:
    """Dump the serving benchmark to JSON (the ``benchmarks/gate_serve.py``
    schema).  ``simulated`` rows are fully deterministic (the regression gate
    compares them against a baseline); ``executed`` rows carry measured wall
    quantities (the gate only sanity-checks their counters).  ``meta``
    records the torch version and the name of the ``device`` that ran."""
    doc = {
        "meta": dict(
            meta,
            torch=torch.__version__,
            device=device_name(device),
            python=sys.version.split()[0],
        ),
        "simulated": {r.policy: dataclasses.asdict(r) for r in sim_rows},
        "executed": {
            name: rep.to_dict()
            for name, rep in (arena.reports if arena else {}).items()
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="granite_3_2b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the arch's reduced config (f32 activations): "
                    "prefill --requests prompts, then greedy decode")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-len", type=int, default=16)
    ap.add_argument(
        "--scheduler",
        type=str,
        default="incremental-gp",
        choices=[
            "incremental-gp",
            "gp",
            "dmda",
            "eager",
            "heft",
            "random",
            "affinity-steal",
        ],
        help="without --arena: simulate the --requests x --decode-chunks "
        "request DAG under this policy (after --smoke, when given)",
    )
    ap.add_argument("--decode-chunks", type=int, default=8)
    ap.add_argument(
        "--arena",
        action="store_true",
        help="replay a churning request stream through every "
        "policy and print the comparison table",
    )
    ap.add_argument(
        "--scenario",
        type=str,
        default="serve",
        choices=list(SCENARIOS),
        help="with --arena: zoo stream generator — the default "
        "prefill/decode serving stream, MoE conditional routing, "
        "speculative-decoding verify-or-discard, or train/serve "
        "colocation (simulated comparison incl. affinity-steal)",
    )
    ap.add_argument(
        "--hier",
        action="store_true",
        help="with --arena (and --execute): run the stream on "
        "the rack/pod platform — shared-uplink contention "
        "+ prefetch throttling, simulated and executed",
    )
    ap.add_argument(
        "--steps",
        type=int,
        default=6,
        help="stream length (scheduling intervals) for --arena",
    )
    ap.add_argument(
        "--replicas",
        type=int,
        default=1,
        help="with --arena: >1 runs the fleet tier — N platform "
        "replicas behind the partition-affine router on a "
        "bursty ON/OFF stream",
    )
    ap.add_argument(
        "--router",
        type=str,
        default="affinity",
        choices=list(MODES) + ["all"],
        help="fleet routing mode for --replicas > 1 "
        "('all' compares every mode on the same stream)",
    )
    ap.add_argument(
        "--drain-step",
        type=int,
        default=None,
        help="with --replicas: gracefully drain the last replica "
        "before this step (proactive KV migration)",
    )
    ap.add_argument(
        "--drop-step",
        type=int,
        default=None,
        help="kill a small-pod worker at this arena step",
    )
    ap.add_argument(
        "--execute",
        action="store_true",
        help="with --arena: also run the stream on real device "
        "groups under every policy through the serving "
        "executor and dump metrics to --bench-out",
    )
    ap.add_argument(
        "--fused",
        action=argparse.BooleanOptionalAction,
        default=False,
        help="with --execute: dispatch each partition group's kernel "
        "chain as ONE captured CUDA graph (one barrier per group-step + "
        "persistent cache of captured graphs; the chain is called as it is "
        "on the CPU) instead of the kernel-at-a-time loop",
    )
    ap.add_argument(
        "--async-groups",
        action=argparse.BooleanOptionalAction,
        default=False,
        help="with --execute --fused: dispatch every group whose "
        "cross-group inputs are satisfied in the same dependency wave "
        "(one CUDA stream per group, one barrier per wave, non-blocking "
        "comm pulls) instead of serializing group-steps",
    )
    ap.add_argument(
        "--bench-out",
        type=str,
        default="BENCH_serve.json",
        help="JSON metrics path for --execute",
    )
    ap.add_argument(
        "--kernel-side",
        type=int,
        default=48,
        help="square matrix side for executed kernels",
    )
    ap.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="with --execute or --smoke: run on cuda:0 (the CUDA kernels) "
        "or on the CPU (their plain PyTorch versions)",
    )
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.arena and args.replicas > 1:
        _main_router(args)
        return
    if args.arena:
        _main_arena(args)
        return
    if args.smoke:
        cfg = dataclasses.replace(get_config(canon(args.arch)).smoke(),
                                  activation_dtype="float32")
        device = _cli_device(args.device)
        ops.warm_up(device)
        _, stats = serve_smoke(cfg, n_requests=args.requests, prompt_len=args.prompt_len,
                               decode_len=args.decode_len, seed=args.seed, device=device)
        print(f"[serve] {cfg.name}: {args.requests} requests x {args.decode_len} tokens "
              f"-> {stats.tokens_per_s:.1f} tok/s ({device_name(device)}; prefill "
              f"{stats.prefill_ms:.1f} ms, decode {stats.decode_ms_per_token:.2f} ms/token"
              + (f", one CUDA graph per step, captured in {stats.capture_ms:.1f} ms"
                 if device.type == "cuda" else "") + ")")
    r = schedule_requests(args.requests, args.decode_chunks, args.scheduler)
    print(
        f"[serve] scheduler={args.scheduler}: makespan={r['makespan_ms']:.1f}ms "
        f"transfers={r['transfers']} moved={r['bytes_moved_mb']:.0f}MiB "
        f"placement={r['per_class']}"
    )


def _main_router(args) -> None:
    modes = list(MODES) if args.router == "all" else [args.router]
    for mode in modes:
        rep = run_router(
            args.requests,
            args.decode_chunks,
            replicas=args.replicas,
            mode=mode,
            steps=args.steps,
            seed=args.seed,
            hier=args.hier,
            drain_step=args.drain_step,
        )
        d = rep.to_dict()
        print(
            f"[router] mode={mode} replicas={args.replicas} "
            f"steps={d['steps']}: mean_lat={d['mean_latency_ms']:.1f}ms "
            f"p95={d['p95_latency_ms']:.1f}ms "
            f"fleet_mk={d['total_makespan_ms']:.1f}ms "
            f"warm_hit={d['warm_hit_rate']:.0%} "
            f"migrated={d['kv_migrated_bytes'] / 2**20:.0f}MiB"
        )


def _cli_device(name: str) -> torch.device:
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass --device cpu)")
    return torch.device("cuda", 0)


def _main_arena(args) -> None:
    policies = DEFAULT_POLICIES
    if args.scenario != "serve":
        # zoo scenarios exist to compare the partitioners against the
        # strongest queue baseline; the serve default stays pinned to the
        # CI baseline's exact policy set
        policies = DEFAULT_POLICIES + ("affinity-steal",)
    rows, _ = run_arena(
        args.requests,
        args.decode_chunks,
        steps=args.steps,
        drop_step=args.drop_step,
        seed=args.seed,
        hier=args.hier,
        scenario=args.scenario,
        policies=policies,
    )
    print(format_table(rows))
    if not args.execute:
        return
    if args.scenario != "serve":
        raise SystemExit("--execute only supports --scenario serve")
    device = _cli_device(args.device)
    # the kernel build and first launches must not land in a timed kernel
    ops.warm_up(device)
    xrows, xarena = run_arena_executed(
        args.requests,
        args.decode_chunks,
        steps=args.steps,
        drop_step=args.drop_step,
        seed=args.seed,
        side=args.kernel_side,
        hier=args.hier,
        device=device,
        fused=args.fused,
        async_groups=args.async_groups,
    )
    print(
        f"\n[serve] executed on {device_name(device)} "
        f"({', '.join(r.policy for r in xrows)}"
        f"{', fused super-steps' if args.fused else ''}"
        f"{', async waves' if args.async_groups else ''}):"
    )
    print(format_table(xrows))
    meta = {
        "requests": args.requests,
        "decode_chunks": args.decode_chunks,
        "steps": args.steps,
        "drop_step": args.drop_step,
        "seed": args.seed,
        "kernel_side": args.kernel_side,
        "hier": args.hier,
        "fused": args.fused,
        "async_groups": args.async_groups,
    }
    write_bench(
        args.bench_out, meta=meta, sim_rows=rows, arena=xarena, device=device
    )
    print(f"[serve] wrote {args.bench_out}")


if __name__ == "__main__":
    main()
