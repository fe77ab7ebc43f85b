"""Online serving executor: the incremental-GP scheduling loop on real devices.

This is the north-star path the ROADMAP calls "wire ``IncrementalGpPolicy``
into the real executor": the same churning request streams the
:class:`~repro_torch.core.arena.SchedulerArena` replays through the *simulator* are
dispatched here through :class:`~repro_torch.core.executor.TorchExecutor` onto real
device groups, while the scheduling policy keeps co-evolving with the
measured hardware:

* every arriving graph revision is (re-)prepared by the policy — for
  :class:`~repro_torch.core.online.IncrementalGpPolicy` that is a warm ingest which
  carries persisting placements over;
* staggered request chains (``ArenaStep.arrivals``) are *admitted* as the
  stream clock passes their arrival: the executor's arrival gate opens and the
  policy places just the delta (``admit_task`` — partial-graph admission);
* :class:`~repro_torch.core.simulate.WorkerDrop` / ``WorkerAdd`` events fire on the
  stream clock: the platform copy mutates, the policy's elastic hooks retarget
  Formula (1)/(2) over the survivors, a fully-dead class has its device-group
  memory evicted (lost blocks transparently recomputed) and its pending
  kernels re-dispatched onto live groups;
* the **measurement loop closes**: each kernel's observed wall time updates a
  :class:`~repro_torch.core.cost.MeasuredCostModel` history and per-class
  :class:`~repro_torch.ft.elastic.HeartbeatMonitor` EWMAs, which feed
  ``IncrementalGpPolicy._targets_for`` — partition targets track *observed*
  throughput instead of static cost tables (straggler-aware targets).

The stream clock is *virtual*: measured kernel milliseconds overlapped with
modeled transfer milliseconds on the shared :class:`~repro_torch.core.comm.CommEngine`
lanes (the same two-resource timeline the simulator runs), so event/arrival
semantics are stable across hosts of very different speeds while the
quantities fed back to the policy stay real.  Transfers are charged to the
actual src-node -> dst-node link of the platform topology and the inputs of
upcoming kernels are prefetched under the running kernel's compute, instead
of serializing measured kernel time plus modeled transfer time on one clock.
On a hierarchical platform (:class:`~repro_torch.core.comm.HierTopology`) each
real pull books every tier its path crosses — cross-pod pulls
contend on the shared uplinks — and prefetches are contention-throttled
(``StepReport.n_throttled``, per-tier wire time in ``tier_busy_ms``).

``fused=True`` swaps the per-kernel dispatch loop for per-group
**super-steps** (one captured CUDA graph per partition group-step with a
single ready-barrier each; see :mod:`repro_torch.core.executor`).  The
stream clock then follows the *apportioned* per-kernel times on the same
virtual timeline, the measured-cost loop keeps closing per kernel, and the
persistent :class:`~repro_torch.core.executor.SuperStepCache` hit/miss
counters surface in every :class:`StepReport` — the policy's ``revision``
tag keys the cache, so only a full-repartition escalation re-captures
everything.  :meth:`ServingExecutor.close` releases the captured graphs.

Every processor class of a platform maps to a torch device group; by
default all of them alias ``cuda:0`` (one card), and a caller that wants
the CPU passes ``devices=[torch.device("cpu")]`` explicitly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Sequence

import torch

from .arena import ArenaRow, ArenaStep
from .comm import CommEngine
from .cost import Link, MeasuredCostModel
from .executor import SuperStepCache, TorchExecutor, attach_request_kernels
from .graph import TaskGraph
from .simulate import Platform, WorkerAdd, WorkerDrop
from ..ft.elastic import Heartbeat, HeartbeatMonitor, feed_policy


@dataclasses.dataclass
class StepReport:
    """One executed scheduling interval."""

    tag: str
    n_kernels: int                  # kernel executions (incl. re-executions)
    makespan_ms: float              # virtual stream clock at drain
    wall_ms: float                  # real wall time for the interval
    n_transfers: int
    bytes_transferred: int
    offline_ms: float               # policy.prepare wall time
    decision_ms: float              # admissions + elastic hooks wall time
    admitted_late: int              # tasks admitted after t=0 (arrival gate)
    redispatched: int               # pending kernels moved off a dead group
    reexecuted: int                 # finished kernels re-run after eviction
    kernel_ms_by_class: dict        # class -> mean observed kernel ms
    dropped: list
    added: list
    events_missed: list             # events past the interval's drain clock
    spills: int = 0                 # completions past a group's KV budget
    peak_mem_bytes: dict = dataclasses.field(default_factory=dict)
    #                               # group -> peak resident bytes (KV)
    transfer_busy_ms: float = 0.0   # modeled wire time on the comm lanes
    lane_busy_ms: dict = dataclasses.field(default_factory=dict)
    n_prefetched: int = 0           # transfers staged ahead of their consumer
    tier_busy_ms: dict = dataclasses.field(default_factory=dict)
    #                               # wire time per topology tier (leaf/rack/
    #                               # pod on a hierarchy, link name on flat)
    n_throttled: int = 0            # prefetches deferred by the contention
    #                               # throttle (hierarchical topologies)
    n_preempted: int = 0            # in-flight copies cancelled when their
    #                               # destination group died mid-transfer
    fused_steps: int = 0            # compiled group-steps dispatched (fused)
    cache_hits: int = 0             # super-step compilation-cache hits
    cache_misses: int = 0           # super-step compilations this interval
    n_streamed: int = 0             # demand pulls executed as chunked channels
    n_stalled_chunks: int = 0       # chunks delayed by channel backpressure
    stream_busy_ms: float = 0.0     # lane time booked by channel chunks
    n_waves: int = 0                # fused dispatch barriers (async_groups:
    #                               # one per wave, else one per group-step)
    overlap_ms: float = 0.0         # compute co-scheduled inside waves
    kernels_by_op: dict = dataclasses.field(default_factory=dict)
    #                               # op -> kernel executions (incl. re-runs,
    #                               # and fused members whose step record a
    #                               # group eviction dropped before it was read)
    static_copies: int = 0          # inputs copied into CUDA graphs' buffers
    static_copy_bytes: int = 0      # their bytes


def _sum_field(steps, field: str) -> dict[str, int]:
    out: dict[str, int] = {}
    for s in steps:
        for op, n in getattr(s, field).items():
            out[op] = out.get(op, 0) + n
    return out


@dataclasses.dataclass
class ServeReport:
    """A whole stream, executed for real under one policy."""

    policy: str
    steps: list[StepReport] = dataclasses.field(default_factory=list)

    def total(self, field: str) -> float:
        return sum(getattr(s, field) for s in self.steps)

    def to_row(self) -> ArenaRow:
        n = max(len(self.steps), 1)
        total_mk = self.total("makespan_ms")
        return ArenaRow(
            policy=self.policy,
            steps=len(self.steps),
            total_makespan_ms=total_mk,
            mean_makespan_ms=total_mk / n,
            transfers=int(self.total("n_transfers")),
            bytes_moved=int(self.total("bytes_transferred")),
            decision_ms=self.total("decision_ms"),
            offline_ms=self.total("offline_ms"),
            aborted=int(self.total("redispatched") + self.total("reexecuted")),
            spills=int(self.total("spills")),
        )

    def peak_mem_bytes(self) -> dict[str, float]:
        peaks: dict[str, float] = {}
        for s in self.steps:
            for grp, b in s.peak_mem_bytes.items():
                peaks[grp] = max(peaks.get(grp, 0.0), b)
        return peaks

    def to_dict(self) -> dict:
        classes: dict[str, list[float]] = {}
        for s in self.steps:
            for cls, ms in s.kernel_ms_by_class.items():
                classes.setdefault(cls, []).append(ms)
        return {
            "policy": self.policy,
            "steps": len(self.steps),
            "total_makespan_ms": self.total("makespan_ms"),
            "wall_ms": self.total("wall_ms"),
            "kernels": int(self.total("n_kernels")),
            "transfers": int(self.total("n_transfers")),
            "bytes_moved": int(self.total("bytes_transferred")),
            "offline_ms": self.total("offline_ms"),
            "decision_ms": self.total("decision_ms"),
            "admitted_late": int(self.total("admitted_late")),
            "redispatched": int(self.total("redispatched")),
            "reexecuted": int(self.total("reexecuted")),
            "mean_kernel_ms": {c: sum(v) / len(v) for c, v in classes.items()},
            "spills": int(self.total("spills")),
            "peak_mem_bytes": self.peak_mem_bytes(),
            "transfer_busy_ms": self.total("transfer_busy_ms"),
            "prefetched": int(self.total("n_prefetched")),
            "throttled": int(self.total("n_throttled")),
            "preempted": int(self.total("n_preempted")),
            "fused_steps": int(self.total("fused_steps")),
            "cache_hits": int(self.total("cache_hits")),
            "cache_misses": int(self.total("cache_misses")),
            "streamed": int(self.total("n_streamed")),
            "stalled_chunks": int(self.total("n_stalled_chunks")),
            "stream_busy_ms": self.total("stream_busy_ms"),
            "waves": int(self.total("n_waves")),
            "overlap_ms": self.total("overlap_ms"),
            "kernels_by_op": _sum_field(self.steps, "kernels_by_op"),
            "static_copies": int(self.total("static_copies")),
            "static_copy_bytes": int(self.total("static_copy_bytes")),
        }


@dataclasses.dataclass
class _LiveState:
    """Duck-typed subset of :class:`repro_torch.core.simulate.Sim` that the elastic
    policy hooks (``on_worker_drop`` / ``on_worker_add``) consume, plus the
    executor's live KV-residency ledger (group -> resident bytes)."""

    g: TaskGraph
    platform: Platform
    finished: set
    resident: dict = dataclasses.field(default_factory=dict)
    task_group: dict = dataclasses.field(default_factory=dict)


def groups_for_platform(platform: Platform,
                        devices: Sequence[torch.device] | None = None
                        ) -> dict[str, torch.device]:
    """One device group per processor class, round-robined over ``devices``
    (default: every class aliases ``cuda:0``, the one card).  Raises when
    CUDA is missing and no devices were given: running on the CPU is asked
    for explicitly, never fallen back to."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=[torch.device('cpu')] "
                "to run the executor on the CPU")
        devices = [torch.device("cuda", 0)]
    devices = [torch.device(d) for d in devices]
    return {cls: devices[i % len(devices)]
            for i, cls in enumerate(platform.classes)}


def subgraph_of(g: TaskGraph, names) -> TaskGraph:
    """Copy of the induced subgraph on ``names`` (admitted-task prefix)."""
    keep = set(names)
    sub = TaskGraph()
    for n in g.topo_order():
        if n in keep:
            k = g.nodes[n]
            sub.add_kernel(dataclasses.replace(k, costs=dict(k.costs),
                                               meta=dict(k.meta)))
    for e in g.edges:
        if e.src in keep and e.dst in keep:
            sub.add_edge(e.src, e.dst, e.nbytes, e.blocks)
    return sub


def _downstream_of(g: TaskGraph, roots) -> set[str]:
    out = set(roots)
    for n in g.topo_order():
        if n not in out and any(p in out for p in g.predecessors(n)):
            out.add(n)
    return out


class ServingExecutor:
    """Run request streams on real device groups under an online policy.

    ``groups`` maps processor class -> device; ``platform`` carries the worker
    metadata (classes must be a subset of the groups).  ``side`` is the square
    matrix size real kernels run at; ``attach`` turns a revision's kernels
    into real callables + host inputs (defaults to the request-chain ops).
    """

    def __init__(self, groups: Mapping[str, torch.device], platform: Platform,
                 *, side: int = 64, host_group: str | None = None,
                 attach: Callable[[TaskGraph, int], dict] | None = None,
                 monitor: HeartbeatMonitor | None = None,
                 cost_model: MeasuredCostModel | None = None,
                 link: Link | None = None, fused: bool = False,
                 superstep_cache: SuperStepCache | None = None,
                 streaming: bool = False, chunk_bytes: int | None = None,
                 stream_depth: int = 2, async_groups: bool = False):
        missing = [c for c in platform.classes if c not in groups]
        if missing:
            raise KeyError(f"platform classes without a device group: {missing}")
        self.executor = TorchExecutor(groups)
        self.platform = platform
        self.side = side
        self.host_group = self.executor.resolve_host_group(host_group)
        self.attach = attach or attach_request_kernels
        self.link = link or platform.link
        self.monitor = monitor or HeartbeatMonitor(
            list(platform.classes), straggle_factor=1.5)
        self.cost_model = cost_model or MeasuredCostModel(impls={},
                                                          link=self.link)
        # fused super-step mode: each group's runnable chain dispatches as
        # one captured graph; the cache persists across intervals AND streams
        # (captured group-steps are pure — a warm entry is reusable by any
        # policy whose revision tag and chain signature match)
        self.fused = fused
        self.superstep_cache = (superstep_cache if superstep_cache is not None
                                else (SuperStepCache() if fused else None))
        # streaming pulls: cross-group demand transfers open chunked
        # channels (comm.StreamChannel) instead of bulk fetches — opt-in,
        # streaming=False keeps the bulk path bit-identical
        self.streaming = streaming
        # None -> per-route topology default (flat topologies resolve to the
        # fixed DEFAULT_CHUNK_BYTES, so the resolved value is bit-identical)
        self.chunk_bytes = chunk_bytes
        self.stream_depth = stream_depth
        # async multi-group waves: fused group-steps whose cross-group inputs
        # are satisfied dispatch in the same wave, one barrier per wave
        self.async_groups = async_groups and fused

    def close(self) -> None:
        """Release the captured CUDA graphs and their memory pools (the
        super-step cache is emptied; a later stream re-captures)."""
        if self.superstep_cache is not None:
            self.superstep_cache.clear()

    def reset_measurements(self) -> None:
        """Fresh measurement state (monitor EWMAs + cost history).  Called at
        the top of every :meth:`run_stream` so back-to-back runs — e.g. the
        arena executing several policies through one executor — never leak
        one policy's observed step times into another's live targets."""
        m = self.monitor
        self.monitor = HeartbeatMonitor(list(m.groups), timeout_s=m.timeout_s,
                                        straggle_factor=m.straggle_factor,
                                        ewma=m.ewma)
        c = self.cost_model
        self.cost_model = MeasuredCostModel(impls=c.impls, link=c.link,
                                            repeats=c.repeats)

    # -- elastic events --------------------------------------------------------

    def _fallback_class(self, g: TaskGraph, name: str,
                        platform: Platform) -> str:
        costs = g.nodes[name].costs
        live = [c for c in platform.classes if c in costs]
        if not live:
            raise RuntimeError(
                f"task {name!r} has no live capable class after drops")
        return min(live, key=lambda c: (costs[c], c))

    def _apply_drop(self, pname: str, state: _LiveState, session,
                    policy) -> tuple[float, int]:
        procs = state.platform.procs
        proc = next((p for p in procs if p.name == pname), None)
        if proc is None:
            return 0.0, 0
        procs.remove(proc)
        hook = getattr(policy, "on_worker_drop", None)
        overhead = (hook(proc, state) or 0.0) if hook else 0.0
        redispatched = 0
        if not any(p.cls == proc.cls for p in procs):
            # the whole class died: its group memory is gone — evict (lost
            # blocks recompute lazily; the session tracks re-executions) and
            # pull pending kernels off it
            in_flight = [n for n in session.pending()
                         if session.assignment.get(n) == proc.cls]
            session.evict_group(proc.cls)
            # the group's KV residency is gone with its memory
            state.resident[proc.cls] = 0.0
            state.task_group = {n: grp for n, grp in state.task_group.items()
                                if grp != proc.cls}
            assignment = getattr(policy, "assignment", {})
            session.reassign({n: assignment[n] for n in session.pending()
                              if n in assignment})
            for n in session.pending():
                if session.assignment.get(n) == proc.cls:
                    session.assignment[n] = self._fallback_class(
                        state.g, n, state.platform)
            redispatched = sum(1 for n in in_flight
                               if session.assignment.get(n) != proc.cls)
        else:
            # capacity shrank but the group survives: adopt any retargeted
            # placements the policy produced
            assignment = getattr(policy, "assignment", {})
            session.reassign({n: assignment[n] for n in session.pending()
                              if n in assignment})
        return overhead, redispatched

    def _apply_add(self, proc, state: _LiveState, session, policy) -> float:
        if proc.cls not in self.executor.groups:
            raise KeyError(f"no device group for joining class {proc.cls!r}")
        state.platform.procs.append(proc)
        hook = getattr(policy, "on_worker_add", None)
        overhead = (hook(proc, state) or 0.0) if hook else 0.0
        assignment = getattr(policy, "assignment", {})
        session.reassign({n: assignment[n] for n in session.pending()
                          if n in assignment})
        return overhead

    # -- one interval ----------------------------------------------------------

    def run_step(self, step: ArenaStep, policy, step_idx: int = 0
                 ) -> StepReport:
        wall0 = time.perf_counter()
        g = step.graph.copy()
        inputs = self.attach(g, self.side)

        # split the revision: tasks whose arrival has passed vs gated chains
        arrivals = dict(step.arrivals or {})
        late_entries = {n: t for n, t in arrivals.items() if t > 0}
        topo_idx = {n: i for i, n in enumerate(g.topo_order())}
        arrival_of: dict[str, float] = {}
        for root, t in late_entries.items():
            for n in _downstream_of(g, [root]):
                arrival_of[n] = max(arrival_of.get(n, 0.0), t)
        gated = set(arrival_of)

        # platform copy for this interval (events mutate it).  Unlike the
        # simulator — which prepares on the full platform and THEN applies
        # t<=0 events to demo the offline-restriction regime — a t<=0 event
        # here edits the platform *before* prepare: in a live system a worker
        # that left a previous interval is simply absent from this one.
        platform = self.platform.copy()
        events = sorted(step.events or (), key=lambda e: e.t_ms)
        pre = [e for e in events if e.t_ms <= 0]
        timed = [e for e in events if e.t_ms > 0]

        state = _LiveState(g=g, platform=platform, finished=set())
        for ev in pre:
            if isinstance(ev, WorkerDrop):
                platform.procs[:] = [p for p in platform.procs
                                     if p.name != ev.proc]
            elif isinstance(ev, WorkerAdd):
                platform.procs.append(ev.proc)

        # an online policy prepares on the *admitted* prefix and places the
        # rest via admit_task as arrivals pass; a purely offline policy (no
        # admit_task) would otherwise never place the late tasks, so it
        # prepares on the full revision — the arrival gate still holds
        # execution back, only the placement decision is made up front
        admit_fn = getattr(policy, "admit_task", None)
        if admit_fn is None:
            prep_g = g
        else:
            admitted = [n for n in g.nodes if n not in gated]
            prep_g = subgraph_of(g, admitted)
        offline_ms = policy.prepare(prep_g, platform)
        assignment = dict(getattr(policy, "assignment", {}))
        for n in g.nodes:
            if g.nodes[n].op != "source" and n not in assignment:
                assignment[n] = self._fallback_class(g, n, platform)

        # the shared communication model: transfers charged to the actual
        # src-node -> dst-node lanes, overlapped with compute on the session's
        # two-resource virtual timeline (same engine the simulator runs)
        comm = CommEngine(platform.topo)
        group_nodes = {cls: platform.node_of_class(cls)
                       for cls in platform.classes}
        for cls in self.executor.groups:
            group_nodes.setdefault(cls, platform.host_node)
        session = self.executor.session(
            g, assignment, inputs, host_group=self.host_group,
            time_kernels=True, gated=gated, comm=comm,
            group_nodes=group_nodes, fused=self.fused,
            cache=self.superstep_cache,
            revision=int(getattr(policy, "revision", 0)),
            streaming=self.streaming, chunk_bytes=self.chunk_bytes,
            stream_depth=self.stream_depth, async_groups=self.async_groups)

        clock = 0.0
        decision_ms = 0.0
        admitted_late = redispatched = 0
        spills = 0
        dropped: list[str] = []
        added: list[str] = []
        cls_ms: dict[str, list[float]] = {}
        peak_mem: dict[str, float] = {}
        # request-granular KV lifetime: a chain's footprint frees when its
        # whole request has executed (meta["req"], as in the simulator)
        req_tasks: dict[str, list[str]] = {}
        for n, k in g.nodes.items():
            r = k.meta.get("req")
            if r is not None:
                req_tasks.setdefault(r, []).append(n)
        req_left = {r: len(v) for r, v in req_tasks.items()}
        pending_events = list(timed)
        pending_admits = sorted(arrival_of.items(), key=lambda kv: (kv[1], kv[0]))

        def fire_due():
            nonlocal decision_ms, redispatched, admitted_late
            nonlocal pending_events, pending_admits
            while pending_events and pending_events[0].t_ms <= clock + 1e-12:
                ev = pending_events.pop(0)
                if isinstance(ev, WorkerDrop):
                    oh, rd = self._apply_drop(ev.proc, state, session,
                                              policy)
                    decision_ms += oh
                    redispatched += rd
                    dropped.append(ev.proc)
                elif isinstance(ev, WorkerAdd):
                    decision_ms += self._apply_add(ev.proc, state, session,
                                                   policy)
                    added.append(ev.proc.name)
            due = [n for n, t in pending_admits if t <= clock + 1e-12]
            if due:
                done = set(due)
                pending_admits = [(n, t) for n, t in pending_admits
                                  if n not in done]
                admitted_late += len(due)
                admit_fn = getattr(policy, "admit_task", None)
                if admit_fn is not None:
                    for n in sorted(due, key=topo_idx.__getitem__):
                        k = g.nodes[n]
                        deps = [(p, g.edge(p, n).nbytes)
                                for p in g.predecessors(n)
                                if g.nodes[p].op != "source"]
                        decision_ms += admit_fn(
                            dataclasses.replace(k, costs=dict(k.costs),
                                                meta=dict(k.meta)), deps)
                    session.reassign(dict(policy.assignment))
                session.admit(due, at=clock)

        fire_due()
        while True:
            run = session.step()
            if run is None:
                if session.done():
                    break
                future = [t for _, t in pending_admits]
                future += [e.t_ms for e in pending_events]
                if not future:
                    raise RuntimeError(
                        f"serving deadlock: pending {session.pending()!r}")
                clock = max(clock, min(future))
                fire_due()
                continue
            # close the measurement loop: observed wall time -> cost history;
            # the stream clock follows the session's two-resource timeline
            # (compute overlapped with lane transfers), not a serialized sum
            clock = max(clock, run.t_finish)
            first = run.name not in state.finished
            state.finished.add(run.name)
            kern = g.nodes[run.name]
            r = kern.meta.get("req")
            req_live = r is None or req_left.get(r, 0) > 0
            # residency: add once per live block — a kernel re-executed after
            # a group eviction re-homes its KV (its old entry was cleared
            # with the dead group), but a block already accounted or whose
            # request has retired must not inflate the ledger
            if kern.mem_bytes and run.name not in state.task_group and req_live:
                state.resident[run.group] = (state.resident.get(run.group, 0.0)
                                             + kern.mem_bytes)
                state.task_group[run.name] = run.group
                peak_mem[run.group] = max(peak_mem.get(run.group, 0.0),
                                          state.resident[run.group])
                if (state.resident[run.group]
                        > platform.mem_cap_of(run.group) + 1e-6):
                    spills += 1
            if first and r is not None and r in req_left:
                req_left[r] -= 1
                if req_left[r] == 0:  # request retired: free its KV
                    for n in req_tasks[r]:
                        grp = state.task_group.pop(n, None)
                        if grp is not None:
                            state.resident[grp] -= g.nodes[n].mem_bytes
            self.cost_model.observe(kern.op, self.side, run.group, run.ms)
            cls_ms.setdefault(run.group, []).append(run.ms)
            fire_due()

        # heartbeat per class for this interval; EWMAs feed the policy's
        # live-cost view so the *next* prepare is straggler-aware
        t_wall = time.time()
        for cls, samples in cls_ms.items():
            self.monitor.report(Heartbeat(group=cls, step=step_idx,
                                          step_time_ms=sum(samples)
                                          / len(samples), t_wall=t_wall))
        if hasattr(policy, "observe_step_ms"):
            feed_policy(policy, self.monitor)

        return StepReport(
            tag=step.tag,
            n_kernels=sum(session.per_group.values()),
            makespan_ms=max(clock, session.vmax),
            wall_ms=(time.perf_counter() - wall0) * 1e3,
            n_transfers=session.n_transfers,
            bytes_transferred=session.nbytes,
            offline_ms=offline_ms,
            decision_ms=decision_ms,
            admitted_late=admitted_late,
            redispatched=redispatched,
            reexecuted=len(session.reexecuted),
            kernel_ms_by_class={c: sum(v) / len(v) for c, v in cls_ms.items()},
            dropped=dropped,
            added=added,
            events_missed=list(pending_events),
            spills=spills,
            peak_mem_bytes=peak_mem,
            transfer_busy_ms=comm.busy_ms,
            lane_busy_ms=comm.lane_busy_ms(),
            n_prefetched=comm.n_prefetched,
            tier_busy_ms=comm.tier_busy_ms(),
            n_throttled=comm.n_throttled,
            n_preempted=comm.n_preempted,
            fused_steps=session.fused_steps,
            cache_hits=session.cache_hits,
            cache_misses=session.cache_misses,
            n_streamed=comm.n_streamed,
            n_stalled_chunks=comm.n_stalled_chunks,
            stream_busy_ms=comm.stream_busy_ms,
            n_waves=session.n_waves,
            overlap_ms=session.overlap_ms,
            kernels_by_op=dict(session.kernels_by_op),
            static_copies=session.static_copies,
            static_copy_bytes=session.static_copy_bytes,
        )

    # -- whole stream ----------------------------------------------------------

    def run_stream(self, stream: Sequence[ArenaStep], policy,
                   policy_name: str | None = None) -> ServeReport:
        name = policy_name or getattr(policy, "name", type(policy).__name__)
        self.reset_measurements()
        report = ServeReport(policy=name)
        for i, step in enumerate(stream):
            report.steps.append(self.run_step(step, policy, step_idx=i))
        return report


# ---------------------------------------------------------------------------
# Fleet tier: replica wrapper + merged reports
# ---------------------------------------------------------------------------

class ExecutorReplica:
    """One real-device :class:`ServingExecutor` behind the fleet router.

    Duck-type match for :class:`~repro_torch.core.router.SimReplica`: the router
    hands it per-step sub-streams (``run_step``), reads its partitioner's
    residency export for the affinity score (``residency``), and snapshots
    per-request KV bytes at drain time (``drain_kv`` — the drain hook that
    makes proactive migration use the *executor's* view of residency, not
    the router's running estimate)."""

    def __init__(self, name: str, executor: ServingExecutor, policy):
        self.name = name
        self.executor = executor
        self.policy = policy
        self._step = 0

    def run_step(self, step: ArenaStep) -> StepReport:
        rep = self.executor.run_step(step, self.policy, step_idx=self._step)
        self._step += 1
        return rep

    def residency(self) -> dict:
        hook = getattr(self.policy, "residency", None)
        return hook() if hook is not None else {}

    def drain_kv(self) -> dict[str, float]:
        """Per-request resident KV bytes to migrate before removal."""
        per_req = self.residency().get("requests", {})
        return {req: float(sum(by_cls.values()))
                for req, by_cls in per_req.items()}


def merge_serve_reports(reports: Sequence[ServeReport],
                        name: str | None = None) -> ServeReport:
    """Merge per-replica :class:`ServeReport` streams into one fleet view.

    Replicas run their share of every interval concurrently, so step ``i``'s
    merged makespan is the SLOWEST replica's; counters (kernels, transfers,
    spills, preemptions, wall/decision time) sum; per-group peaks take the
    max and per-class kernel means average across the replicas that ran the
    class.  Tags keep the shared stream prefix (``step3:...@r0`` -> the
    part before ``@``)."""
    if not reports:
        raise ValueError("nothing to merge")
    merged = ServeReport(policy=name or reports[0].policy)
    for i in range(max(len(r.steps) for r in reports)):
        group = [r.steps[i] for r in reports if i < len(r.steps)]
        classes: dict[str, list[float]] = {}
        peaks: dict[str, float] = {}
        lanes: dict[str, float] = {}
        tiers: dict[str, float] = {}
        for s in group:
            for cls, ms in s.kernel_ms_by_class.items():
                classes.setdefault(cls, []).append(ms)
            for grp, b in s.peak_mem_bytes.items():
                peaks[grp] = max(peaks.get(grp, 0.0), b)
            for lane, ms in s.lane_busy_ms.items():
                lanes[lane] = lanes.get(lane, 0.0) + ms
            for tier, ms in s.tier_busy_ms.items():
                tiers[tier] = tiers.get(tier, 0.0) + ms

        def tot(field: str):
            return sum(getattr(s, field) for s in group)

        merged.steps.append(StepReport(
            tag=group[0].tag.split("@", 1)[0],
            n_kernels=int(tot("n_kernels")),
            makespan_ms=max(s.makespan_ms for s in group),
            wall_ms=tot("wall_ms"),
            n_transfers=int(tot("n_transfers")),
            bytes_transferred=int(tot("bytes_transferred")),
            offline_ms=tot("offline_ms"),
            decision_ms=tot("decision_ms"),
            admitted_late=int(tot("admitted_late")),
            redispatched=int(tot("redispatched")),
            reexecuted=int(tot("reexecuted")),
            kernel_ms_by_class={c: sum(v) / len(v) for c, v in classes.items()},
            dropped=[d for s in group for d in s.dropped],
            added=[a for s in group for a in s.added],
            events_missed=[e for s in group for e in s.events_missed],
            spills=int(tot("spills")),
            peak_mem_bytes=peaks,
            transfer_busy_ms=tot("transfer_busy_ms"),
            lane_busy_ms=lanes,
            n_prefetched=int(tot("n_prefetched")),
            tier_busy_ms=tiers,
            n_throttled=int(tot("n_throttled")),
            n_preempted=int(tot("n_preempted")),
            fused_steps=int(tot("fused_steps")),
            cache_hits=int(tot("cache_hits")),
            cache_misses=int(tot("cache_misses")),
            n_streamed=int(tot("n_streamed")),
            n_stalled_chunks=int(tot("n_stalled_chunks")),
            stream_busy_ms=tot("stream_busy_ms"),
            n_waves=int(tot("n_waves")),
            overlap_ms=tot("overlap_ms"),
            kernels_by_op=_sum_field(group, "kernels_by_op"),
            static_copies=int(tot("static_copies")),
            static_copy_bytes=int(tot("static_copy_bytes")),
        ))
    return merged
