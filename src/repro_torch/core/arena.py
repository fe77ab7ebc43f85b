"""SchedulerArena: replay a stream of task graphs through competing policies.

The paper compares policies on one static graph (Figs 5/6).  A serving system
sees a *stream*: every scheduling interval the request DAG has churned (new
requests admitted, finished ones retired) and the device pool may have changed.
The arena replays one such stream through every policy on a shared
:class:`~repro_torch.core.simulate.Platform` (each run gets its own mutable copy)
and aggregates makespan / transfer / decision-overhead into one table — the
experiment that shows *why* incremental GP exists: ``gp`` re-partitions from
scratch every interval, ``incremental-gp`` amortizes, both beat the
data-oblivious baselines on makespan.

Policy instances persist across the stream, so stateful policies
(:class:`~repro_torch.core.online.IncrementalGpPolicy`) see the deltas.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

from .graph import TaskGraph, _make_lcg
from .schedulers import Policy, make_policy
from .simulate import Platform, SimResult, simulate

DEFAULT_POLICIES = ("eager", "dmda", "heft", "gp", "incremental-gp")


@dataclasses.dataclass
class ArenaStep:
    """One scheduling interval: a graph revision plus its dynamic events.

    ``prunes`` (``{trigger: [tasks...]}``) marks conditional subgraphs: when
    ``trigger`` finishes, the listed tasks and their transitive successors
    are cancelled mid-flight (speculative-decoding verify-or-discard — see
    :func:`make_specdec_stream`).  Simulated runs forward it to
    :func:`~repro_torch.core.simulate.simulate`; executed mode
    (:meth:`SchedulerArena.run_executed`) runs speculation to completion —
    pruning is a simulator-level model of discarded work."""

    graph: TaskGraph
    arrivals: Mapping[str, float] | None = None
    events: Sequence = ()
    tag: str = ""
    prunes: Mapping[str, Sequence[str]] | None = None


@dataclasses.dataclass
class ArenaRow:
    policy: str
    steps: int
    total_makespan_ms: float
    mean_makespan_ms: float
    transfers: int
    bytes_moved: int
    decision_ms: float       # online (per-ready + platform-event) overhead
    offline_ms: float        # prepare() time, summed over the stream
    aborted: int
    spills: int = 0          # forced KV evictions (memory-capacity overflow)
    spilled_bytes: int = 0


class SchedulerArena:
    """Run every policy over the same stream; collect comparable totals.

    ``policies`` maps display name -> zero-arg factory; a plain sequence of
    names uses :func:`~repro_torch.core.schedulers.make_policy` with
    ``policy_kwargs[name]`` (if given).
    """

    def __init__(self, platform: Platform,
                 policies: Sequence[str] | Mapping[str, Callable[[], Policy]]
                 = DEFAULT_POLICIES, *,
                 policy_kwargs: Mapping[str, dict] | None = None):
        self.platform = platform
        if isinstance(policies, Mapping):
            self.factories = dict(policies)
        else:
            kw = policy_kwargs or {}
            self.factories = {name: (lambda n=name: make_policy(n, **kw.get(n, {})))
                              for name in policies}
        self.results: dict[str, list[SimResult]] = {}
        self.reports: dict = {}   # policy -> ServeReport (run_executed)

    def run(self, stream: Sequence[ArenaStep], *,
            overlap: bool = True) -> list[ArenaRow]:
        """``overlap=False`` replays the stream with transfers serialized at
        task start (the paper's single-copy-engine semantics) — the ablation
        axis ``benchmarks/comm_overlap_bench.py`` sweeps."""
        rows = []
        for name, factory in self.factories.items():
            pol = factory()  # one instance for the whole stream (stateful)
            results = [simulate(s.graph, pol, self.platform,
                                arrivals=s.arrivals, events=s.events,
                                overlap=overlap, prunes=s.prunes)
                       for s in stream]
            self.results[name] = results
            total_mk = sum(r.makespan_ms for r in results)
            rows.append(ArenaRow(
                policy=name,
                steps=len(results),
                total_makespan_ms=total_mk,
                mean_makespan_ms=total_mk / max(len(results), 1),
                transfers=sum(r.n_transfers for r in results),
                bytes_moved=sum(r.bytes_transferred for r in results),
                decision_ms=sum(r.decision_overhead_ms for r in results),
                offline_ms=sum(r.offline_decision_ms for r in results),
                aborted=sum(len(r.aborted) for r in results),
                spills=sum(r.spill_events for r in results),
                spilled_bytes=sum(r.spilled_bytes for r in results),
            ))
        rows.sort(key=lambda r: r.total_makespan_ms)
        return rows

    def run_executed(self, stream: Sequence[ArenaStep], executor) -> list[ArenaRow]:
        """The ``--execute`` mode: replay the same stream on REAL devices.

        ``executor`` is a :class:`repro_torch.core.serving.ServingExecutor`
        (passed in, not imported — serving imports this module).  Every
        policy gets one persistent instance, exactly like :meth:`run`, but
        each interval is dispatched through the torch executor with measured
        per-kernel times feeding back into the policy.  Full
        :class:`~repro_torch.core.serving.ServeReport` objects land in
        ``self.reports``; the returned rows use the same schema as the
        simulated table (``aborted`` counts re-dispatched + re-executed
        kernels)."""
        self.reports = {}
        rows = []
        for name, factory in self.factories.items():
            pol = factory()
            rep = executor.run_stream(stream, pol, policy_name=name)
            self.reports[name] = rep
            rows.append(rep.to_row())
        rows.sort(key=lambda r: r.total_makespan_ms)
        return rows


def format_table(rows: Sequence[ArenaRow]) -> str:
    """Aligned text table, one row per policy, best makespan first."""
    cols = ("policy", "steps", "mean_mk_ms", "total_mk_ms", "transfers",
            "moved_mb", "decision_ms", "offline_ms", "aborted", "spills")
    data = [cols] + [
        (r.policy, str(r.steps), f"{r.mean_makespan_ms:.1f}",
         f"{r.total_makespan_ms:.1f}", str(r.transfers),
         f"{r.bytes_moved / 2**20:.0f}", f"{r.decision_ms:.2f}",
         f"{r.offline_ms:.2f}", str(r.aborted), str(r.spills))
        for r in rows]
    widths = [max(len(row[i]) for row in data) for i in range(len(cols))]
    lines = ["  ".join(c.rjust(w) for c, w in zip(row, widths))
             for row in data]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Stream splitting (fleet tier: one shared stream, N replicas)
# ---------------------------------------------------------------------------

def requests_of(g: TaskGraph) -> dict[str, list[str]]:
    """Request id -> task names in topo order.  Tasks without a
    ``meta["req"]`` tag form singleton groups under their own name, so a
    router can place *any* graph request-by-request; virtual source nodes
    belong to no group (they ride along with their consumers)."""
    out: dict[str, list[str]] = {}
    for n in g.topo_order():
        k = g.nodes[n]
        if k.op == "source":
            continue
        out.setdefault(k.meta.get("req", n), []).append(n)
    return out


def split_step(step: ArenaStep, assignment: Mapping[str, str], *,
               warm: Mapping[str, set] | None = None,
               resume_factor: float = 0.1) -> dict[str, ArenaStep]:
    """Split one :class:`ArenaStep` across replicas by request assignment.

    ``assignment`` maps request id -> replica name (every request of the
    step's graph must be assigned).  Each replica gets the induced subgraph
    of its requests plus any virtual source feeding them, the arrivals of
    its own tasks, and a tag suffixed with its name.

    ``warm[replica]`` is the set of requests whose KV already resides on
    that replica: their *entry* kernels (the prefill) have costs scaled by
    ``resume_factor`` — resuming a resident KV cache instead of recomputing
    the full prefill.  That is the whole point of affinity routing: a warm
    request re-admitted to its home replica skips the prefill work, one
    re-routed elsewhere pays it in full.

    Per-worker dynamic events are NOT forwarded (a ``WorkerDrop`` names a
    proc of one replica's platform; fleet-level churn goes through the
    router's drain / scale-out instead)."""
    groups = requests_of(step.graph)
    unknown = set(groups) - set(assignment)
    if unknown:
        raise KeyError(f"unassigned requests: {sorted(unknown)[:3]}")
    by_rep: dict[str, list[str]] = {}
    for req in groups:
        by_rep.setdefault(assignment[req], []).append(req)
    out: dict[str, ArenaStep] = {}
    for rep, reqs in by_rep.items():
        g = TaskGraph()
        warm_here = (warm or {}).get(rep, set())
        names: set[str] = set()
        for req in reqs:
            for n in groups[req]:
                k = step.graph.nodes[n]
                costs = dict(k.costs)
                entry = all(step.graph.nodes[p].op == "source"
                            for p in step.graph.predecessors(n))
                if entry and req in warm_here:
                    costs = {c: v * resume_factor for c, v in costs.items()}
                g.add(n, op=k.op, costs=costs, out_bytes=k.out_bytes,
                      mem_bytes=k.mem_bytes, meta=dict(k.meta), fn=k.fn)
                names.add(n)
        for e in step.graph.edges:
            if e.dst not in names:
                continue
            if e.src not in names:
                if step.graph.nodes[e.src].op != "source":
                    raise ValueError(
                        f"edge {e.src}->{e.dst} crosses request groups")
                if e.src not in g.nodes:
                    src = step.graph.nodes[e.src]
                    g.add(e.src, op=src.op, costs=dict(src.costs),
                          out_bytes=src.out_bytes, mem_bytes=src.mem_bytes,
                          meta=dict(src.meta), fn=src.fn)
            g.add_edge(e.src, e.dst, nbytes=e.nbytes, blocks=e.blocks)
        g.validate()
        arrivals = None
        if step.arrivals:
            arrivals = {n: t for n, t in step.arrivals.items() if n in names}
        out[rep] = ArenaStep(graph=g, arrivals=arrivals, events=(),
                             tag=f"{step.tag}@{rep}" if step.tag else rep)
    return out


# ---------------------------------------------------------------------------
# Scenario zoo: stream generators (request chains / MoE routing /
# speculative decoding / train-serve colocation), all sharing churn +
# arrival plumbing
# ---------------------------------------------------------------------------

def _check_arrival_mode(arrival_mode: str) -> None:
    """Shared eager validation for every stream generator — reject an unknown
    ``arrival_mode`` before any argument defaulting or RNG work happens."""
    if arrival_mode not in ("uniform", "onoff"):
        raise ValueError(f"unknown arrival_mode {arrival_mode!r}")


def _churn_plan(n_steps: int, base_requests: int, churn: float):
    """Yield ``(step, active, fresh)`` per interval: retire ~``churn`` of the
    oldest active requests, admit the same number of new ids — the shared
    churn bookkeeping of every scenario generator."""
    active: list[int] = list(range(base_requests))
    next_rid = base_requests
    for step in range(n_steps):
        if step > 0:
            n_churn = max(1, int(len(active) * churn))
            fresh = list(range(next_rid, next_rid + n_churn))
            next_rid += n_churn
            active = active[n_churn:] + fresh  # retire oldest, admit new
        else:
            fresh = []
        yield step, list(active), fresh


class _ArrivalStagger:
    """Arrival-offset generator shared by the scenario zoo.

    ``"uniform"`` draws i.i.d. offsets in ``[0, spread_ms)``; ``"onoff"`` is
    a Markov-modulated ON/OFF process (bursty serving traffic) whose state
    persists across stream steps.  Both are deterministic in the caller's
    LCG.  Call :meth:`offsets` with the *entry task names* of the step's
    fresh requests, in admission order."""

    # transition probabilities per arrival: ON sticks (bursts have length),
    # OFF exits faster (silences are shorter than bursts)
    P_EXIT_ON, P_EXIT_OFF = 0.30, 0.45

    def __init__(self, rnd, spread_ms: float, mode: str, burst_factor: float):
        _check_arrival_mode(mode)
        self.rnd = rnd
        self.spread_ms = spread_ms
        self.mode = mode
        self.burst_factor = burst_factor
        self.on = True  # ON/OFF chain state, persists across stream steps

    def offsets(self, entries: Sequence[str]) -> dict[str, float] | None:
        if self.spread_ms <= 0 or not entries:
            return None
        if self.mode == "uniform":
            return {name: self.spread_ms * self.rnd(1000) / 1000.0
                    for name in entries}
        # rate-matched to the uniform mode: normalize the base gap by the
        # chain's stationary mean modulation factor, so ON compresses and
        # OFF stretches (classic MMPP burstiness) around the same mean
        # inter-arrival time the uniform mode would use
        pi_on = self.P_EXIT_OFF / (self.P_EXIT_ON + self.P_EXIT_OFF)
        rate_norm = pi_on / self.burst_factor + (1.0 - pi_on) * self.burst_factor
        base = self.spread_ms / max(len(entries), 1) / rate_norm
        t = 0.0
        out: dict[str, float] = {}
        for name in entries:
            jitter = 0.5 + self.rnd(1000) / 1000.0
            gap = (base / self.burst_factor if self.on
                   else base * self.burst_factor) * jitter
            t += gap
            out[name] = t
            if self.on:
                if self.rnd(1000) < int(self.P_EXIT_ON * 1000):
                    self.on = False
            elif self.rnd(1000) < int(self.P_EXIT_OFF * 1000):
                self.on = True
        return out


def _request_chain(g: TaskGraph, rid: int, decode_chunks: int, *,
                   costs_prefill: Mapping[str, float],
                   costs_decode: Mapping[str, float], kv_bytes: int):
    """One request: prefill -> decode chain.  Every kernel pins ``kv_bytes``
    of resident KV cache (``mem_bytes``) and carries its request id in
    ``meta["req"]`` so residency grows over the chain and frees when the
    whole request retires (simulator + online partitioner semantics)."""
    meta = {"req": f"r{rid}"}
    g.add(f"r{rid}.prefill", op="prefill", costs=dict(costs_prefill),
          out_bytes=kv_bytes, mem_bytes=kv_bytes, meta=dict(meta))
    prev = f"r{rid}.prefill"
    for c in range(decode_chunks):
        name = f"r{rid}.dec{c}"
        g.add(name, op="decode", costs=dict(costs_decode),
              out_bytes=kv_bytes, mem_bytes=kv_bytes, meta=dict(meta))
        g.add_edge(prev, name, nbytes=kv_bytes)
        prev = name


def make_request_stream(
    n_steps: int = 6, *, base_requests: int = 8, decode_chunks: int = 6,
    churn: float = 0.3, kv_bytes: int = 16 << 20, seed: int = 0,
    costs_prefill: Mapping[str, float] | None = None,
    costs_decode: Mapping[str, float] | None = None,
    arrival_spread_ms: float = 0.0,
    arrival_mode: str = "uniform",
    burst_factor: float = 6.0,
    events_at: Mapping[int, Sequence] | None = None,
) -> list[ArenaStep]:
    """A deterministic stream of evolving request-DAG revisions.

    Each step retires ~``churn`` of the oldest active requests and admits the
    same number of new ones, so consecutive graphs overlap — the regime where
    incremental re-partitioning amortizes.  ``arrival_spread_ms`` staggers new
    requests' prefill arrival inside the step; ``events_at[step]`` injects
    :class:`WorkerDrop` / ``WorkerAdd`` events into that step's run.

    ``arrival_mode`` shapes the stagger:

    * ``"uniform"`` — i.i.d. arrival offsets in ``[0, arrival_spread_ms)``;
    * ``"onoff"`` — a Markov-modulated ON/OFF process (bursty serving
      traffic): the chain alternates between an ON state emitting arrivals
      ``burst_factor``x denser than the uniform mean gap and an OFF state
      ``burst_factor``x sparser, with state persisting *across steps*.
      Deterministic in ``seed`` like everything else.
    """
    _check_arrival_mode(arrival_mode)
    costs_prefill = costs_prefill or {"big": 20.0, "small": 60.0}
    costs_decode = costs_decode or {"big": 8.0, "small": 24.0}
    rnd = _make_lcg(seed + 101)
    stagger = _ArrivalStagger(rnd, arrival_spread_ms, arrival_mode, burst_factor)
    steps: list[ArenaStep] = []
    for step, active, fresh in _churn_plan(n_steps, base_requests, churn):
        g = TaskGraph()
        for rid in active:
            _request_chain(g, rid, decode_chunks,
                           costs_prefill=costs_prefill,
                           costs_decode=costs_decode, kv_bytes=kv_bytes)
        g.validate()
        arrivals = stagger.offsets([f"r{rid}.prefill" for rid in fresh])
        steps.append(ArenaStep(
            graph=g, arrivals=arrivals,
            events=tuple((events_at or {}).get(step, ())),
            tag=f"step{step}:{len(active)}req"))
    return steps


def make_moe_stream(
    n_steps: int = 6, *, base_requests: int = 8, n_experts: int = 8,
    top_k: int = 2, churn: float = 0.3, kv_bytes: int = 16 << 20,
    expert_bytes: int = 48 << 20, resample: float = 0.25, seed: int = 0,
    costs_route: Mapping[str, float] | None = None,
    costs_expert: Mapping[str, float] | None = None,
    costs_merge: Mapping[str, float] | None = None,
    arrival_spread_ms: float = 0.0,
    arrival_mode: str = "uniform",
    burst_factor: float = 6.0,
    events_at: Mapping[int, Sequence] | None = None,
) -> list[ArenaStep]:
    """MoE-style conditional routing: per request and step, a router kernel
    fans out to ``top_k`` expert kernels (of ``n_experts``) and a merge
    kernel joins them.

    Each expert's weights are a shared per-step ``xw{e}`` producer node of
    ``expert_bytes`` — every request routed to expert ``e`` consumes that
    block, so colocating an expert's users amortizes one weight pull
    (the affinity signal locality-aware stealing chases).  A persisting
    request re-rolls one of its experts with probability ``resample`` each
    step (token-dependent routing drift), so the graph *shape* churns even
    for surviving requests — the regime that breaks an incremental
    partitioner's "small delta" assumption."""
    _check_arrival_mode(arrival_mode)
    if not 0 < top_k <= n_experts:
        raise ValueError(f"top_k {top_k} not in 1..{n_experts}")
    costs_route = costs_route or {"big": 1.0, "small": 2.0}
    costs_expert = costs_expert or {"big": 10.0, "small": 30.0}
    costs_merge = costs_merge or {"big": 2.0, "small": 6.0}
    rnd = _make_lcg(seed + 211)
    stagger = _ArrivalStagger(rnd, arrival_spread_ms, arrival_mode, burst_factor)

    def _sample_experts() -> list[int]:
        picks: list[int] = []
        while len(picks) < top_k:
            e = rnd(n_experts)
            if e not in picks:
                picks.append(e)
        return picks

    experts_of: dict[int, list[int]] = {}
    steps: list[ArenaStep] = []
    for step, active, fresh in _churn_plan(n_steps, base_requests, churn):
        for rid in active:
            if rid not in experts_of:
                experts_of[rid] = _sample_experts()
            elif rnd(1000) < int(resample * 1000):
                # routing drift: re-roll one slot, keep the rest resident
                slot = rnd(top_k)
                e = rnd(n_experts)
                while e in experts_of[rid]:
                    e = rnd(n_experts)
                experts_of[rid][slot] = e
        experts_of = {rid: experts_of[rid] for rid in active}
        g = TaskGraph()
        used = sorted({e for rid in active for e in experts_of[rid]})
        for e in used:
            g.add(f"xw{e}", op="weights", costs={"big": 0.0, "small": 0.0},
                  out_bytes=expert_bytes)
        for rid in active:
            meta = {"req": f"r{rid}"}
            g.add(f"r{rid}.route", op="route", costs=dict(costs_route),
                  out_bytes=kv_bytes // 4, mem_bytes=kv_bytes // 4,
                  meta=dict(meta))
            g.add(f"r{rid}.merge", op="merge", costs=dict(costs_merge),
                  out_bytes=kv_bytes, mem_bytes=kv_bytes, meta=dict(meta))
            for e in experts_of[rid]:
                name = f"r{rid}.x{e}"
                g.add(name, op="expert", costs=dict(costs_expert),
                      out_bytes=kv_bytes, mem_bytes=kv_bytes,
                      meta={**meta, "expert": e})
                g.add_edge(f"r{rid}.route", name, nbytes=kv_bytes // 4)
                g.add_edge(f"xw{e}", name, nbytes=expert_bytes)
                g.add_edge(name, f"r{rid}.merge", nbytes=kv_bytes)
        g.validate()
        arrivals = stagger.offsets([f"r{rid}.route" for rid in fresh])
        steps.append(ArenaStep(
            graph=g, arrivals=arrivals,
            events=tuple((events_at or {}).get(step, ())),
            tag=f"moe{step}:{len(active)}req/{len(used)}exp"))
    return steps


def make_specdec_stream(
    n_steps: int = 6, *, base_requests: int = 8, draft_len: int = 6,
    churn: float = 0.3, kv_bytes: int = 16 << 20, seed: int = 0,
    costs_draft: Mapping[str, float] | None = None,
    costs_verify: Mapping[str, float] | None = None,
    costs_commit: Mapping[str, float] | None = None,
    arrival_spread_ms: float = 0.0,
    arrival_mode: str = "uniform",
    burst_factor: float = 6.0,
    events_at: Mapping[int, Sequence] | None = None,
) -> list[ArenaStep]:
    """Speculative decoding verify-or-discard: per request, a chain of
    ``draft_len`` cheap draft kernels races ahead while a target-model
    verify kernel checks the prefix.

    Verification accepts a (seed-deterministic) prefix of ``a`` drafts:
    ``verify`` depends on draft ``a-1`` and *prunes* draft ``a`` — the
    unaccepted tail is discarded mid-flight through
    :class:`ArenaStep`'s ``prunes`` (a tail draft already running when
    verify lands completes as wasted speculation).  A ``commit`` kernel
    (the target model's correction token) closes the request.  Schedulers
    cannot see the prune coming, so over-committing a fast group to
    speculative tails is pure loss — the workload Taskflow-style
    conditional graphs stress."""
    _check_arrival_mode(arrival_mode)
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    costs_draft = costs_draft or {"big": 2.0, "small": 4.0}
    costs_verify = costs_verify or {"big": 12.0, "small": 40.0}
    costs_commit = costs_commit or {"big": 3.0, "small": 9.0}
    rnd = _make_lcg(seed + 307)
    stagger = _ArrivalStagger(rnd, arrival_spread_ms, arrival_mode, burst_factor)
    steps: list[ArenaStep] = []
    for step, active, fresh in _churn_plan(n_steps, base_requests, churn):
        g = TaskGraph()
        prunes: dict[str, list[str]] = {}
        for rid in active:
            meta = {"req": f"r{rid}"}
            prev = None
            for d in range(draft_len):
                name = f"r{rid}.d{d}"
                g.add(name, op="draft", costs=dict(costs_draft),
                      out_bytes=kv_bytes // 4, mem_bytes=kv_bytes // 4,
                      meta=dict(meta))
                if prev is not None:
                    g.add_edge(prev, name, nbytes=kv_bytes // 4)
                prev = name
            # accepted prefix length in [1, draft_len]: verify always
            # examines at least the first draft and emits one token itself
            accept = 1 + rnd(draft_len)
            g.add(f"r{rid}.verify", op="verify", costs=dict(costs_verify),
                  out_bytes=kv_bytes, mem_bytes=kv_bytes, meta=dict(meta))
            g.add_edge(f"r{rid}.d{accept - 1}", f"r{rid}.verify",
                       nbytes=kv_bytes // 4)
            if accept < draft_len:
                prunes[f"r{rid}.verify"] = [f"r{rid}.d{accept}"]
            g.add(f"r{rid}.commit", op="commit", costs=dict(costs_commit),
                  out_bytes=kv_bytes, mem_bytes=kv_bytes, meta=dict(meta))
            g.add_edge(f"r{rid}.verify", f"r{rid}.commit", nbytes=kv_bytes)
        g.validate()
        arrivals = stagger.offsets([f"r{rid}.d0" for rid in fresh])
        steps.append(ArenaStep(
            graph=g, arrivals=arrivals,
            events=tuple((events_at or {}).get(step, ())),
            tag=f"specdec{step}:{len(active)}req",
            prunes=prunes or None))
    return steps


def _train_step_costs(arch: str, batch: int, seq: int,
                      class_gflops: Mapping[str, float]) -> dict[str, float]:
    """Per-class ms for one fine-tune step of ``arch``, from the model
    configs (``repro_torch.configs``): 6ND flops (fwd + bwd) over an
    analytic dense param count, divided by per-class GFLOP/s throughput."""
    import importlib

    cfg = importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
    per_layer = 4 * cfg.d_model * cfg.d_model + 3 * cfg.d_model * cfg.d_ff
    n_params = cfg.n_layers * per_layer + cfg.vocab * cfg.d_model
    flops = 6.0 * n_params * batch * seq
    return {cls: flops / (gf * 1e6) for cls, gf in class_gflops.items()}


def make_colocate_stream(
    n_steps: int = 6, *, base_requests: int = 8, decode_chunks: int = 6,
    churn: float = 0.3, kv_bytes: int = 16 << 20, seed: int = 0,
    costs_prefill: Mapping[str, float] | None = None,
    costs_decode: Mapping[str, float] | None = None,
    arch: str = "granite_3_2b", train_every: int = 2, train_chunks: int = 4,
    train_batch: int = 8, train_seq: int = 128,
    class_gflops: Mapping[str, float] | None = None,
    train_mem_bytes: int = 64 << 20, train_io_bytes: int = 32 << 20,
    arrival_spread_ms: float = 0.0,
    arrival_mode: str = "uniform",
    burst_factor: float = 6.0,
    events_at: Mapping[int, Sequence] | None = None,
) -> list[ArenaStep]:
    """Train/serve colocation: the serving stream of
    :func:`make_request_stream` plus, every ``train_every`` steps, a
    fine-tune job sharing the fleet — a chain of ``train_chunks``
    sequential train-step kernels whose per-class cost comes from
    ``launch/train.py``'s model configs (:func:`_train_step_costs`).

    Train chunks are an order of magnitude fatter than serving kernels and
    pin ``train_mem_bytes`` of optimizer state per chunk, so a balance-only
    partitioner happily parks them on the fast group and queues
    latency-sensitive prefills behind them — the colocation tension this
    scenario probes."""
    _check_arrival_mode(arrival_mode)
    if train_every < 1:
        raise ValueError(f"train_every must be >= 1, got {train_every}")
    costs_prefill = costs_prefill or {"big": 20.0, "small": 60.0}
    costs_decode = costs_decode or {"big": 8.0, "small": 24.0}
    class_gflops = class_gflops or {"big": 200_000.0, "small": 50_000.0}
    costs_train = _train_step_costs(arch, train_batch, train_seq, class_gflops)
    rnd = _make_lcg(seed + 401)
    stagger = _ArrivalStagger(rnd, arrival_spread_ms, arrival_mode, burst_factor)
    next_jid = 0
    steps: list[ArenaStep] = []
    for step, active, fresh in _churn_plan(n_steps, base_requests, churn):
        g = TaskGraph()
        for rid in active:
            _request_chain(g, rid, decode_chunks,
                           costs_prefill=costs_prefill,
                           costs_decode=costs_decode, kv_bytes=kv_bytes)
        n_jobs = 0
        if step % train_every == 0:
            jid, next_jid = next_jid, next_jid + 1
            n_jobs = 1
            meta = {"req": f"j{jid}"}
            prev = None
            for c in range(train_chunks):
                name = f"j{jid}.t{c}"
                g.add(name, op="train", costs=dict(costs_train),
                      out_bytes=train_io_bytes, mem_bytes=train_mem_bytes,
                      meta=dict(meta))
                if prev is not None:
                    g.add_edge(prev, name, nbytes=train_io_bytes)
                prev = name
        g.validate()
        arrivals = stagger.offsets([f"r{rid}.prefill" for rid in fresh])
        steps.append(ArenaStep(
            graph=g, arrivals=arrivals,
            events=tuple((events_at or {}).get(step, ())),
            tag=f"colo{step}:{len(active)}req+{n_jobs}job"))
    return steps


# scenario name -> stream generator; the zoo `launch/serve.py --scenario`
# and `benchmarks/scenario_bench.py` select from
SCENARIOS: dict[str, Callable[..., list[ArenaStep]]] = {
    "serve": make_request_stream,
    "moe": make_moe_stream,
    "specdec": make_specdec_stream,
    "colocate": make_colocate_stream,
}
