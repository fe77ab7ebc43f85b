"""Discrete-event simulator for data-flow execution on heterogeneous
processors with discrete memory nodes and a topology of transfer links.

Models exactly the effects the paper evaluates, generalized past its
single-bus platform (§IV: 3 CPU worker cores + 1 GPU worker, one PCIe 3.0
x16 link with one copy engine):

* per-worker in-order execution of assigned kernels;
* **data consistency**: a kernel can only run on a processor once all its
  input blocks are valid on that processor's memory node; cross-node reads
  book transfers on the :class:`~repro_torch.core.comm.CommEngine` — per-link
  bandwidth/latency lanes from the platform's :class:`~repro_torch.core.comm.Topology`
  (the default, a single one-lane shared bus, reproduces the paper's GTX
  platform exactly);
* **compute/transfer overlap**: with ``overlap=True`` (default) the inputs of
  tasks already committed to a worker's queue are *prefetched* while the
  worker is still busy, so cut-edge transfers hide under compute — the
  two-resource event simulation (compute streams + comm lanes on one event
  heap) that makes graph-partition scheduling win on real fabrics.
  ``overlap=False`` reproduces the paper's serialized issue-at-dispatch
  semantics on the same lanes;
* **hierarchical fabrics**: with a :class:`~repro_torch.core.comm.HierTopology`
  every transfer books lanes on each tier it crosses (leaf NIC, rack
  uplink, shared pod uplink), cross-pod traffic contends on the shared
  uplinks, and prefetches are contention-throttled (``throttle``, auto-on
  for hierarchies) so they never queue a demand fetch behind them on a hot
  tier;
* **streaming channels**: with ``streaming=True`` a cross-node input is not
  bulk-fetched before the kernel runs but opened as a
  :class:`~repro_torch.core.comm.StreamChannel` — the copy splits into
  ``chunk_bytes`` chunks that go on the wire while the *producer* is still
  computing, the consumer starts once chunk 0 lands, and residual chunk
  arrivals are charged against the consumer's own compute; channel ``depth``
  bounds the in-flight window (backpressure, ``n_stalled_chunks``).  Deep
  cut-edge chains become pipeline stages (throughput-bound) instead of
  hop-serialized fetch+compute (latency-bound).  Bulk prefetch is subsumed:
  chunk 0 of a channel is never later than a prefetch booked at the
  producer's finish;
* transfer counting / byte accounting (the paper's second metric);
* scheduling-decision overhead (paper §IV.D: dmda pays per-task decision
  time, gp decides once offline);
* **discrete-memory capacity**: every class's memory node has a resident-byte
  budget (``Platform.mem_capacity_bytes``); a kernel's ``mem_bytes`` is
  reserved at dispatch, a request chain's KV footprint grows over its decode
  chunks and frees when the whole request retires, and an overflow forces a
  *spill* of the oldest finished resident block to the host over the
  host link.  A spilled block *pulled back* by a later consumer re-occupies
  residency on the pulling class — and can itself trigger further spills
  (reload accounting; reloads are no longer free apart from the transfer).

The simulator also services the TPU adaptation: memory nodes = device groups,
links = inter-group fabric (ICI/DCN tiers via the topology), workers =
groups' compute streams.  Memory nodes outlive their workers: a class whose
last worker drops keeps serving reads of blocks it already holds (the
executor, which really loses the device memory, recomputes instead).

Dynamic events (the online extension, §IV.D's offline restriction lifted):

* **task arrivals** — ``arrivals`` maps task name -> earliest-ready timestamp;
* **worker drop** — :class:`WorkerDrop` removes a processor mid-run: its queue
  drains back through the policy, a task running on it is aborted and
  re-dispatched, and nothing is ever placed on it again;
* **worker add** — :class:`WorkerAdd` brings a new processor online mid-run.

Policies observe platform changes via ``on_worker_drop`` / ``on_worker_add``
hooks (returning any decision time in ms, charged to the overhead metric).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Mapping, Sequence

from .comm import DEFAULT_CHUNK_BYTES, CommEngine, Topology, platform_topology
from .cost import Link, PCIE3_X16
from .graph import TaskGraph


@dataclasses.dataclass(frozen=True)
class Processor:
    name: str
    cls: str  # processor class ("cpu"/"gpu"/"tpu_pod0"...)
    node: int  # memory node id (discrete memory per class/group)


@dataclasses.dataclass
class Platform:
    procs: list[Processor]
    link: Link = PCIE3_X16
    host_node: int = 0
    # class -> total resident-memory budget in bytes (KV-cache capacity of
    # that class's memory node); absent class = unconstrained.  The "second
    # partition constraint" besides work balance.
    mem_capacity_bytes: dict[str, float] = dataclasses.field(default_factory=dict)
    # per-link transfer lanes between memory nodes; None = the paper's single
    # shared one-lane bus built from ``link`` (exact back-compat)
    topology: Topology | None = None

    def mem_cap_of(self, cls: str) -> float:
        return self.mem_capacity_bytes.get(cls, float("inf"))

    @property
    def topo(self) -> Topology:
        return platform_topology(self)

    def copy(self) -> "Platform":
        return Platform(
            list(self.procs),
            link=self.link,
            host_node=self.host_node,
            mem_capacity_bytes=dict(self.mem_capacity_bytes),
            topology=self.topology,
        )

    @property
    def classes(self) -> list[str]:
        seen: list[str] = []
        for p in self.procs:
            if p.cls not in seen:
                seen.append(p.cls)
        return seen

    def node_of_class(self, cls: str) -> int:
        for p in self.procs:
            if p.cls == cls:
                return p.node
        raise KeyError(cls)

    def workers_of(self, cls: str) -> list[Processor]:
        return [p for p in self.procs if p.cls == cls]


def make_cpu_gpu_platform(
    n_cpu: int = 3, n_gpu: int = 1, link: Link = PCIE3_X16
) -> Platform:
    """The paper's platform: quad-core i7 (3 worker cores + 1 runtime core) and
    one GTX TITAN, over PCIe 3.0 x16 (one copy engine — single-lane bus)."""
    procs = [Processor(f"cpu{i}", "cpu", 0) for i in range(n_cpu)]
    procs += [Processor(f"gpu{i}", "gpu", 1) for i in range(n_gpu)]
    return Platform(procs, link=link, host_node=0)


def make_group_platform(
    group_sizes: Mapping[str, int],
    link: Link,
    mem_capacity_bytes: Mapping[str, float] | None = None,
    topology: Topology | None = None,
) -> Platform:
    """TPU adaptation: one worker per device *group*; each group has its own
    memory node; groups talk over ``link`` (the slow inter-group fabric) or,
    when given, a full per-link ``topology`` (ICI vs DCN tiers, multi-lane).
    ``mem_capacity_bytes`` optionally budgets each group's HBM (KV capacity)."""
    procs = []
    for i, (cls, n) in enumerate(group_sizes.items()):
        for j in range(n):
            procs.append(Processor(f"{cls}.w{j}", cls, i))
    return Platform(
        procs,
        link=link,
        host_node=0,
        mem_capacity_bytes=dict(mem_capacity_bytes or {}),
        topology=topology,
    )


@dataclasses.dataclass(frozen=True)
class WorkerDrop:
    """Processor leaves the platform at ``t_ms`` (failure / elastic scale-in)."""

    t_ms: float
    proc: str


@dataclasses.dataclass(frozen=True)
class WorkerAdd:
    """Processor joins the platform at ``t_ms`` (elastic scale-out)."""

    t_ms: float
    proc: Processor


@dataclasses.dataclass
class SimResult:
    makespan_ms: float
    n_transfers: int
    bytes_transferred: int
    transfer_busy_ms: float
    proc_busy_ms: dict[str, float]
    kernels_per_class: dict[str, int]
    decision_overhead_ms: float
    offline_decision_ms: float
    trace: list[tuple]  # (task, proc, start, finish)
    transfers: list[tuple]  # (block, src_node, dst_node, start, finish)
    aborted: list[tuple] = dataclasses.field(default_factory=list)
    #                           # (task, proc, start, abort_t) — killed by drops
    dropped_procs: list[str] = dataclasses.field(default_factory=list)
    added_procs: list[str] = dataclasses.field(default_factory=list)
    # memory-capacity accounting (KV-cache pressure): spills are forced
    # evictions to host when a class's resident bytes would exceed its budget
    spill_events: int = 0
    spilled_bytes: int = 0
    peak_mem_bytes: dict[str, float] = dataclasses.field(default_factory=dict)
    # communication-engine accounting (per-link lanes + overlap)
    lane_busy_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    n_prefetched: int = 0
    reload_events: int = 0  # spilled blocks pulled back into residency
    # hierarchical-topology accounting: per-tier wire time (leaf/rack/pod on
    # a HierTopology, the link name on flat ones), prefetches deferred by the
    # contention throttle, and total demand-fetch latency (finish - request,
    # queueing included — the quantity throttling protects)
    tier_busy_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    n_throttled: int = 0
    demand_latency_ms: float = 0.0
    # copies cancelled in flight because their destination memory node died
    # with its last worker (lanes released at the preemption time)
    n_preempted: int = 0
    # streaming-channel accounting: channels opened, chunks the backpressure
    # window stalled, and total chunk wire time (part of transfer_busy_ms)
    n_streamed: int = 0
    n_stalled_chunks: int = 0
    stream_busy_ms: float = 0.0
    # per-tier prefetch-depth adjustments (CommEngine.adaptive_depth)
    n_depth_adjust: int = 0
    # wave accounting (wave_schedule): dependency waves of group super-steps
    # dispatched (0 for the plain task-level event simulator)
    n_waves: int = 0
    # conditional-subgraph pruning (speculative workloads): tasks cancelled
    # before they ran because their trigger finished and discarded them
    n_pruned: int = 0
    pruned: list = dataclasses.field(default_factory=list)

    def busy_fraction(self) -> dict[str, float]:
        if self.makespan_ms <= 0:
            return {k: 0.0 for k in self.proc_busy_ms}
        return {k: v / self.makespan_ms for k, v in self.proc_busy_ms.items()}


class Sim:
    """Mutable simulation state handed to policies."""

    def __init__(
        self,
        g: TaskGraph,
        platform: Platform,
        throttle: bool | None = None,
        *,
        streaming: bool = False,
        chunk_bytes: int | None = DEFAULT_CHUNK_BYTES,
        stream_depth: int = 2,
        adaptive_depth: bool = False,
        prefetch_depth: int = 2,
    ):
        self.g = g
        # own copy of the proc list: dynamic events mutate it, and the caller's
        # Platform must stay reusable across runs (the arena shares one)
        self.platform = platform.copy()
        self.topo = self.platform.topo
        self.streaming = streaming
        self.chunk_bytes = chunk_bytes
        self.stream_depth = stream_depth
        self.comm = CommEngine(
            self.topo,
            throttle=throttle,
            adaptive_depth=adaptive_depth,
            base_depth=prefetch_depth,
        )
        self.now = 0.0
        # live KV residency per class: insertion-ordered block -> bytes (the
        # order is the FIFO spill victim order); mem_load is the running sum
        self.resident: dict[str, dict[str, int]] = {}
        self.mem_load: dict[str, float] = {}
        self.proc_free = {p.name: 0.0 for p in platform.procs}
        self.proc_queue: dict[str, deque] = {p.name: deque() for p in platform.procs}
        self.central: deque = deque()
        self.valid: dict[str, dict[int, float]] = {}  # block -> node -> valid_at
        self.finished: set[str] = set()
        self.dead: set[str] = set()  # dropped processor names
        self.proc_by_name = {p.name: p for p in platform.procs}
        # policy estimation helpers (dmda keeps its own view)
        self.est_proc_avail = {p.name: 0.0 for p in platform.procs}

    # -- estimation helpers used by dmda -------------------------------------
    def missing_input_bytes(self, task: str, node: int) -> int:
        nb = 0
        for p in self.g.predecessors(task):
            ent = self._block_entry(p, task)
            if ent is None or node not in ent:
                nb += self.g.edge(p, task).nbytes
        return nb

    def missing_input_ms(self, task: str, node: int) -> float:
        """Estimated transfer time to stage ``task``'s missing inputs onto
        ``node``, priced per block at the actual source->node link (link-aware
        dmda ETA; unknown producers price at the worst link)."""
        ms = 0.0
        for p in self.g.predecessors(task):
            e = self.g.edge(p, task)
            ent = self._block_entry(p, task)
            if ent is not None and node in ent:
                # chunks already in flight on a channel mark validity at the
                # LAST chunk's arrival: the remaining ETA is that arrival gap,
                # not a re-priced full transfer (which would double-count the
                # pending bytes) and not zero (the block is not here yet)
                if self.streaming:
                    ms += max(0.0, ent[node] - self.now)
                continue
            if ent:
                src = min(ent.items(), key=lambda kv: (kv[1], kv[0]))[0]
                ms += self.topo.transfer_ms(e.nbytes, src, node)
            else:
                ms += self.topo.worst_ms(e.nbytes)
        return ms

    def _block_entry(self, pred: str, task: str) -> dict[int, float] | None:
        if self.g.nodes[pred].op == "source":
            block = f"{pred}->{task}"
            return self.valid.get(block, {self.platform.host_node: 0.0})
        return self.valid.get(pred)

    def exec_ms(self, task: str, cls: str) -> float:
        return self.g.nodes[task].cost_on(cls)

    # -- memory-capacity helpers (policies' admission checks) -----------------
    def mem_free(self, cls: str) -> float:
        """Free KV-cache budget on ``cls``'s memory node (inf = uncapped)."""
        return self.platform.mem_cap_of(cls) - self.mem_load.get(cls, 0.0)

    def mem_fits(self, task: str, cls: str) -> bool:
        return self.g.nodes[task].mem_bytes <= self.mem_free(cls) + 1e-6


def simulate(
    g: TaskGraph,
    policy,
    platform: Platform,
    *,
    host_entry: bool = True,
    arrivals: Mapping[str, float] | None = None,
    events: Sequence = (),
    overlap: bool = True,
    prefetch_depth: int = 2,
    throttle: bool | None = None,
    streaming: bool = False,
    chunk_bytes: int | None = DEFAULT_CHUNK_BYTES,
    stream_depth: int = 2,
    adaptive_depth: bool = False,
    prunes: Mapping[str, Sequence[str]] | None = None,
) -> SimResult:
    """Run ``policy`` over task graph ``g`` on ``platform``.

    ``host_entry``: initial data lives on the host node (paper §III.B) — entry
    kernels' inputs are host-resident; kernels running elsewhere must pay the
    transfer for blocks they consume (including graph-entry blocks, modeled by
    the virtual source node if present in ``g``).

    ``arrivals``: task name -> timestamp (ms) before which the task cannot be
    scheduled even if its dependencies are met (online request streams).
    ``events``: :class:`WorkerDrop` / :class:`WorkerAdd` dynamic events.
    Events at ``t_ms <= 0`` apply after ``policy.prepare`` but before the
    first dispatch: the offline decision was made for the full platform, then
    the platform changed — the regime the online policies exist for.

    ``overlap``: prefetch the inputs of the first ``prefetch_depth`` tasks of
    every worker's queue while the worker is busy, hiding transfers under
    compute.  ``overlap=False`` issues every transfer at task start (the
    paper's serialized semantics) on the same per-link lanes.

    ``throttle``: contention-aware prefetch throttling — a prefetch only
    books lanes when every tier on its path is idle; a deferred prefetch
    retries at the next event (or the consumer demands the block at full
    priority).  ``None`` (default) enables it exactly on hierarchical
    topologies, keeping every flat-topology result bit-for-bit unchanged.

    ``streaming``: open cross-node inputs as chunked
    :class:`~repro_torch.core.comm.StreamChannel`\\ s instead of bulk fetches — the
    consumer starts at chunk 0's arrival and residual chunks overlap its
    compute, bounded by ``stream_depth`` in-flight chunks (backpressure).
    Bulk prefetch is disabled in this mode (chunk 0, backdated over the
    producer's compute window, is never later than a prefetch).
    ``streaming=False`` (default) is bit-for-bit the bulk model.

    ``adaptive_depth``: per-tier prefetch lookahead — tiers idle past the
    engine's window earn a deeper speculative queue scan (up to its
    ``max_depth``), throttled tiers fall back toward 1; ``prefetch_depth``
    seeds the base.  Off (default) keeps the static depth bit-for-bit.

    ``prunes``: conditional-subgraph pruning (speculative workloads) —
    ``{trigger: [tasks...]}`` cancels the listed tasks (plus, always, their
    transitive successors) the moment ``trigger`` finishes.  A pruned task
    that never started is retired without running — removed from every
    queue, counted in ``SimResult.n_pruned``, its KV share freed with its
    request; one already *running* at the trigger's finish completes as
    wasted speculation (its successors in the closure are still pruned).
    The scheduler cannot see a prune coming: speculative subgraphs are
    placed like real work and the discard happens mid-flight — exactly the
    regime speculative-decoding streams stress (``arena.ArenaStep.prunes``).
    """
    g.validate()
    sim = Sim(
        g,
        platform,
        throttle=throttle,
        streaming=streaming,
        chunk_bytes=chunk_bytes,
        stream_depth=stream_depth,
        adaptive_depth=adaptive_depth,
        prefetch_depth=prefetch_depth,
    )
    platform = sim.platform  # the mutable copy; dynamic events edit this one
    comm = sim.comm
    offline_ms = policy.prepare(g, platform)
    arrivals = arrivals or {}

    # conditional-subgraph pruning: close each trigger's prune set over its
    # transitive successors up front (an unpruned consumer of a pruned task
    # could never become ready), in deterministic topo order
    prune_closure: dict[str, list[str]] = {}
    if prunes:
        topo = g.topo_order()
        for trig, targets in prunes.items():
            if trig not in g.nodes:
                raise KeyError(f"prune trigger {trig!r} not in graph")
            seen: set[str] = set()
            stack = list(targets)
            while stack:
                x = stack.pop()
                if x in seen:
                    continue
                if x not in g.nodes:
                    raise KeyError(f"pruned task {x!r} not in graph")
                seen.add(x)
                stack.extend(g.successors(x))
            if trig in seen:
                raise ValueError(f"prune trigger {trig!r} would prune itself")
            prune_closure[trig] = [n for n in topo if n in seen]

    pred_count = {n: len(g.predecessors(n)) for n in g.nodes}
    n_tasks = len(g.nodes)

    metrics = dict(overhead=0.0, spills=0, spilled=0, reloads=0)
    peak_mem: dict[str, float] = {}
    # KV-residency grouping: a request chain's footprint stays resident until
    # the whole request retires (kernels tagged meta["req"]); ungrouped blocks
    # free once every consumer has finished (plain dataflow buffer lifetime)
    req_of = {n: k.meta.get("req") for n, k in g.nodes.items()}
    req_tasks: dict = {}
    for n, r in req_of.items():
        if r is not None:
            req_tasks.setdefault(r, []).append(n)
    req_left = {r: len(ts) for r, ts in req_tasks.items()}
    block_cls: dict[str, str] = {}  # resident block -> class holding it
    spilled_live: set[str] = set()  # spilled blocks whose request still lives
    busy = {p.name: 0.0 for p in platform.procs}
    per_class: dict[str, int] = {}
    trace: list[tuple | None] = []  # None = slot voided by an abort
    aborted: list[tuple] = []
    dropped: list[str] = []
    added: list[str] = []

    # running[proc] = (task, start, finish, trace_idx, dispatch_id); a drop
    # cancels the in-flight dispatch by id (its "finish" event becomes a no-op)
    running: dict[str, tuple] = {}
    cancelled: set[int] = set()
    did_counter = [0]
    pruned_set: set[str] = set()
    pruned_log: list[str] = []

    heap: list[tuple] = []  # (time, seq, kind, payload)
    seq = [0]

    def push(t: float, kind: str, payload):
        heapq.heappush(heap, (t, seq[0], kind, payload))
        seq[0] += 1

    def mark_ready(task: str, t: float):
        if task in pruned_set:
            return
        if g.nodes[task].op == "source":
            # the virtual zero-weight kernel always runs on the host node
            # (paper §III.B: all initial data is located on the host memory)
            host = next(
                (p for p in platform.procs if p.node == platform.host_node),
                platform.procs[0],
            )
            sim.proc_queue[host.name].append(task)
            return
        extra = policy.on_ready(task, sim)
        metrics["overhead"] += getattr(policy, "decision_ms", 0.0)
        if extra is not None and extra in sim.dead:
            # static assignments can point at a processor that has since been
            # dropped: re-route to the earliest-available live worker capable
            # of running the task
            costs = g.nodes[task].costs
            live = [p for p in platform.procs if p.cls in costs]
            if not live:
                raise RuntimeError(
                    f"task {task!r} has no live capable worker after drops"
                )
            extra = min(
                live,
                key=lambda p: (
                    sim.proc_free[p.name],
                    len(sim.proc_queue[p.name]),
                    p.name,
                ),
            ).name
        if extra is None:
            sim.central.append(task)
        else:
            q = sim.proc_queue[extra]
            prio = getattr(policy, "priority", None)
            if prio is None:
                q.append(task)
            else:  # keep queue sorted by descending priority (HEFT rank order)
                pr = prio(task)
                i = 0
                for i, existing in enumerate(q):
                    if prio(existing) < pr:
                        break
                else:
                    i = len(q)
                q.insert(i, task)

    def block_valid_at(block: str, node: int) -> float | None:
        ent = sim.valid.get(block)
        if ent is None:
            return None
        return ent.get(node)

    def mem_spill(cls: str, need: int, t: float, protect: str):
        """Forced KV eviction: push oldest finished-resident blocks of ``cls``
        to the host over the host link until ``need`` bytes fit.  The class's
        copy is invalidated, so a later consumer pays the transfer back — and
        the pulled-back block re-occupies residency (reload accounting)."""
        res = sim.resident.get(cls, {})
        cap = platform.mem_cap_of(cls)
        node = next((p.node for p in platform.procs if p.cls == cls), None)
        for block in list(res):
            if sim.mem_load.get(cls, 0.0) + need <= cap + 1e-6:
                break
            if block == protect or block not in sim.finished:
                continue
            nb = res.pop(block)
            sim.mem_load[cls] -= nb
            block_cls.pop(block, None)
            te = comm.fetch(
                block,
                node if node is not None else platform.host_node,
                platform.host_node,
                nb,
                now=t,
                kind="spill",
                book_same_node=True,  # host-coresident spills still pay the
                #   staging link (DRAM copy), as the shared-bus model did
            )
            metrics["spills"] += 1
            metrics["spilled"] += nb
            spilled_live.add(block)
            # only this class's memory-node copy is evicted; other nodes keep
            # theirs, and the host gains one (at the earlier of any existing
            # host copy and this spill's completion)
            ent = sim.valid.setdefault(block, {})
            if node is not None:
                ent.pop(node, None)
            ent.setdefault(platform.host_node, te)

    def mem_add(cls: str, block: str, nb: int, t: float):
        """Reserve ``nb`` resident bytes on ``cls`` for ``block`` (spilling
        first if the budget would overflow); tracks the per-class peak."""
        if nb <= 0:
            return
        if sim.mem_load.get(cls, 0.0) + nb > platform.mem_cap_of(cls) + 1e-6:
            mem_spill(cls, nb, t, protect=block)
        res = sim.resident.setdefault(cls, {})
        res[block] = res.get(block, 0) + nb
        sim.mem_load[cls] = sim.mem_load.get(cls, 0.0) + nb
        block_cls[block] = cls
        peak_mem[cls] = max(peak_mem.get(cls, 0.0), sim.mem_load[cls])

    def mem_remove(block: str):
        spilled_live.discard(block)
        cls = block_cls.pop(block, None)
        if cls is None:
            return
        sim.mem_load[cls] -= sim.resident[cls].pop(block, 0)

    def fetch_block(
        block: str, nbytes: int, dst_node: int, dst_cls: str, t: float, kind: str
    ) -> float | None:
        """Book a copy of ``block`` onto ``dst_node`` from its cheapest valid
        source; marks validity at the completion time (so in-flight copies
        dedup naturally) and applies spill-reload residency accounting.
        A prefetch the contention throttle defers books nothing and returns
        ``None`` — the next scheduling event retries it."""
        ent = sim.valid.get(block) or {}
        src_node, src_t = min(ent.items(), key=lambda kv: (kv[1], kv[0]))
        te = comm.fetch(
            block, src_node, dst_node, nbytes, now=t, src_ready=src_t, kind=kind
        )
        if te is None:  # throttled prefetch: no booking, no validity
            return None
        sim.valid.setdefault(block, {})[dst_node] = te
        if block in spilled_live:
            # a spilled KV block pulled back from host re-occupies residency
            # on the pulling class — and can itself trigger further spills
            spilled_live.discard(block)
            r = req_of.get(block)
            if (r is None or req_left.get(r, 0) > 0) and block in g.nodes:
                metrics["reloads"] += 1
                mem_add(dst_cls, block, g.nodes[block].mem_bytes, t)
        return te

    # producer compute windows: task -> (start, finish), so a channel opened
    # for a task's output can backdate chunk availability over the window
    task_window: dict[str, tuple[float, float]] = {}

    def stream_block(block: str, nbytes: int, dst_node: int, dst_cls: str, t: float):
        """Open a chunked channel for ``block`` toward ``dst_node`` from its
        cheapest valid source (streaming counterpart of :func:`fetch_block`;
        validity is marked by the caller once the channel drains)."""
        ent = sim.valid.get(block) or {}
        src_node, src_t = min(ent.items(), key=lambda kv: (kv[1], kv[0]))
        win = task_window.get(block)
        # pro-rata chunk availability only when the source copy IS the
        # producer's own output (valid exactly at its compute finish); a
        # relayed/old copy exists in full at its validity time
        src_start = win[0] if win is not None and abs(win[1] - src_t) <= 1e-9 else None
        ch = comm.open_stream(
            block,
            src_node,
            dst_node,
            nbytes,
            now=t,
            src_start=src_start,
            src_ready=src_t,
            chunk_bytes=sim.chunk_bytes,
            depth=sim.stream_depth,
        )
        if block in spilled_live:
            spilled_live.discard(block)
            r = req_of.get(block)
            if (r is None or req_left.get(r, 0) > 0) and block in g.nodes:
                metrics["reloads"] += 1
                mem_add(dst_cls, block, g.nodes[block].mem_bytes, t)
        return ch

    def start_task(proc: Processor, task: str, t: float):
        """Book transfers for missing inputs, then run. Returns finish time."""
        arrival = t
        mem_add(proc.cls, task, g.nodes[task].mem_bytes, t)
        channels = []
        for pred in g.predecessors(task):
            e = g.edge(pred, task)
            # each entry kernel's host input is its OWN block (paper §III.B:
            # the zero-weight kernel models per-kernel initial data)
            block = f"{pred}->{task}" if g.nodes[pred].op == "source" else pred
            if g.nodes[pred].op == "source" and block not in sim.valid:
                sim.valid[block] = {platform.host_node: 0.0}
            va = block_valid_at(block, proc.node)
            if va is None:
                if sim.streaming:
                    ch = stream_block(block, e.nbytes, proc.node, proc.cls, t)
                    if ch is not None:
                        channels.append(ch)
                        va = ch.first_ready  # start gate: chunk 0, not all
                    else:
                        va = t
                else:
                    va = fetch_block(
                        block, e.nbytes, proc.node, proc.cls, t, "demand"
                    )
            arrival = max(arrival, va)
        start = max(arrival, sim.proc_free[proc.name], t)
        dur = g.nodes[task].cost_on(proc.cls)
        finish = start + dur
        for ch in channels:
            # residual chunks arrive against the compute window; the kernel
            # completes when compute AND every channel have drained, and the
            # block is valid here once its last chunk lands
            ch_finish, arrival_last = ch.drain(start, dur)
            finish = max(finish, ch_finish)
            sim.valid.setdefault(ch.block, {})[proc.node] = arrival_last
        sim.proc_free[proc.name] = finish
        busy[proc.name] += dur
        per_class[proc.cls] = per_class.get(proc.cls, 0) + 1
        did_counter[0] += 1
        running[proc.name] = (task, start, finish, len(trace), did_counter[0])
        trace.append((task, proc.name, start, finish))
        task_window[task] = (start, finish)
        push(finish, "finish", (task, proc.name, did_counter[0]))

    last_dispatch = {p.name: -1.0 for p in platform.procs}

    def try_dispatch(t: float):
        # keep dispatching until no proc can start anything.  Workers poll in
        # earliest-idle order (ties by how long they've been waiting), so the
        # fast processor that drains its work first also wins races for the
        # central queue — matching the paper's observed eager behaviour.
        progress = True
        while progress:
            progress = False
            order = sorted(
                platform.procs,
                key=lambda p: (sim.proc_free[p.name], last_dispatch[p.name], p.name),
            )
            for p in order:
                if sim.proc_free[p.name] > t + 1e-12:
                    continue
                task = None
                q = sim.proc_queue[p.name]
                if q:
                    task = q.popleft()
                elif sim.central:
                    pick = policy.on_idle(p, sim)
                    if pick is not None:
                        sim.central.remove(pick)
                        task = pick
                if task is not None:
                    start_task(p, task, t)
                    last_dispatch[p.name] = t
                    progress = True

    def issue_prefetch(t: float):
        """Overlap engine: book transfers for the inputs of the first
        ``prefetch_depth`` tasks of every worker's queue — those dispatch
        decisions are already committed, so their cut-edge transfers can
        proceed under whatever the worker is currently computing."""
        if not overlap or sim.streaming:
            # streaming subsumes prefetch: a channel's chunk 0, backdated
            # over the producer's compute window, is never later than a
            # prefetch bookable only after the producer finishes
            return
        adaptive = comm.adaptive_depth
        lookahead = comm.max_depth if adaptive else prefetch_depth
        for p in platform.procs:
            q = sim.proc_queue[p.name]
            # central-queue policies have no per-worker queue to scan; the
            # peek_queue hook lets them expose their intended next tasks
            # (e.g. affinity-steal's class deque) for the same treatment
            hint = policy.peek_queue(p, sim)
            if hint:
                q = list(q) + [h for h in hint if h not in q]
            if not q:
                continue
            for i, task in enumerate(q):
                if i >= lookahead:
                    break
                if g.nodes[task].op == "source":
                    continue
                for pred in g.predecessors(task):
                    e = g.edge(pred, task)
                    src = g.nodes[pred].op == "source"
                    block = f"{pred}->{task}" if src else pred
                    if src and block not in sim.valid:
                        sim.valid[block] = {platform.host_node: 0.0}
                    ent = sim.valid.get(block)
                    if ent is None or p.node in ent:
                        continue  # producer unfinished, or already valid/booked
                    if adaptive:
                        # per-tier depth: the route decides how deep into the
                        # queue this worker may speculate right now
                        src_node = min(
                            ent.items(), key=lambda kv: (kv[1], kv[0])
                        )[0]
                        if i >= comm.prefetch_depth_for(src_node, p.node, t):
                            continue
                    fetch_block(block, e.nbytes, p.node, p.cls, t, "prefetch")

    def apply_prunes(trig: str, t: float):
        """``trig`` finished: discard its speculative closure.  Tasks not yet
        started are cancelled in place (dequeued everywhere, retired without
        running); one currently in flight completes as wasted speculation."""
        for p in prune_closure.get(trig, ()):
            if p in sim.finished or p in pruned_set:
                continue
            if any(run[0] == p for run in running.values()):
                continue  # mid-run: let it finish (wasted work, not lost)
            pruned_set.add(p)
            pruned_log.append(p)
            try:
                sim.central.remove(p)
            except ValueError:
                pass
            for q in sim.proc_queue.values():
                try:
                    q.remove(p)
                except ValueError:
                    pass
            # retire its KV share exactly like a finish would
            r = req_of.get(p)
            if r is not None:
                req_left[r] -= 1
                if req_left[r] == 0:
                    for m in req_tasks[r]:
                        mem_remove(m)

    def ready_or_defer(task: str, t: float):
        """Deps are met at ``t``; hand to the policy now or at the arrival."""
        if task in pruned_set:
            return
        arr = arrivals.get(task, 0.0)
        if arr > t + 1e-12:
            push(arr, "ready", task)
        else:
            mark_ready(task, t)

    def apply_drop(pname: str, t: float):
        proc = sim.proc_by_name.get(pname)
        if proc is None or pname in sim.dead:
            return
        sim.dead.add(pname)
        dropped.append(pname)
        platform.procs[:] = [p for p in platform.procs if p.name != pname]
        orphans = list(sim.proc_queue[pname])
        sim.proc_queue[pname].clear()
        run = running.pop(pname, None)
        if run is not None:
            task, start, finish, ti, did = run
            if finish > t + 1e-9:  # in flight: abort, void accounting, re-run
                cancelled.add(did)
                trace[ti] = None
                busy[pname] -= finish - start
                per_class[proc.cls] -= 1
                aborted.append((task, pname, start, t))
                mem_remove(task)  # its KV reservation re-reserves on restart
                orphans.insert(0, task)
        if not any(p.node == proc.node for p in platform.procs):
            # last worker backed by this memory node: copies still in flight
            # toward it have no consumer left — cancel them, release their
            # lane time, and roll back the validity marked at booking (the
            # source copy always survives, so re-dispatched consumers refetch)
            for tr in comm.preempt_dst(proc.node, t):
                ent = sim.valid.get(tr.block)
                if ent and len(ent) > 1 and ent.get(tr.dst, 0.0) > t + 1e-9:
                    ent.pop(tr.dst)
        hook = getattr(policy, "on_worker_drop", None)
        if hook is not None:
            metrics["overhead"] += hook(proc, sim) or 0.0
        for task in orphans:
            mark_ready(task, t)

    def apply_add(proc: Processor, t: float):
        if proc.name in sim.proc_by_name and proc.name not in sim.dead:
            raise ValueError(f"duplicate worker {proc.name!r}")
        sim.dead.discard(proc.name)
        added.append(proc.name)
        platform.procs.append(proc)
        sim.proc_by_name[proc.name] = proc
        sim.proc_free[proc.name] = t
        sim.proc_queue[proc.name] = deque()
        sim.est_proc_avail[proc.name] = t
        busy.setdefault(proc.name, 0.0)
        last_dispatch.setdefault(proc.name, -1.0)
        hook = getattr(policy, "on_worker_add", None)
        if hook is not None:
            metrics["overhead"] += hook(proc, sim) or 0.0

    for ev in events:
        if isinstance(ev, WorkerDrop):
            if ev.t_ms <= 0:  # platform starts without this worker
                apply_drop(ev.proc, 0.0)
            else:
                push(ev.t_ms, "drop", ev.proc)
        elif isinstance(ev, WorkerAdd):
            if ev.t_ms <= 0:
                apply_add(ev.proc, 0.0)
            else:
                push(ev.t_ms, "add", ev.proc)
        else:
            raise TypeError(f"unknown dynamic event {ev!r}")

    # seed: entry tasks ready at t=0 (or their arrival); pre-existing input
    # blocks valid on host
    for n in g.topo_order():
        if pred_count[n] == 0:
            if host_entry:
                sim.valid.setdefault("__host_inputs__", {})[platform.host_node] = 0.0
            ready_or_defer(n, 0.0)
    try_dispatch(0.0)
    issue_prefetch(0.0)

    done = 0
    makespan = 0.0
    while heap:
        t, _, kind, payload = heapq.heappop(heap)
        sim.now = t
        if kind == "finish":
            task, pname, did = payload
            if did in cancelled:
                continue
            proc = sim.proc_by_name[pname]
            if running.get(pname, (None,) * 5)[4] == did:
                del running[pname]
            sim.finished.add(task)
            sim.valid.setdefault(task, {})[proc.node] = t
            done += 1
            makespan = max(makespan, t)
            if task in prune_closure:
                apply_prunes(task, t)
            # KV lifetime: a request's footprint frees when its whole chain
            # retires; ungrouped blocks free once every consumer finished
            r = req_of.get(task)
            if r is not None:
                req_left[r] -= 1
                if req_left[r] == 0:
                    for m in req_tasks[r]:
                        mem_remove(m)
            else:
                for p in g.predecessors(task):
                    if req_of.get(p) is None and all(
                        s in sim.finished for s in g.successors(p)
                    ):
                        mem_remove(p)
            for s in g.successors(task):
                pred_count[s] -= 1
                if pred_count[s] == 0:
                    ready_or_defer(s, t)
        elif kind == "ready":
            mark_ready(payload, t)
        elif kind == "drop":
            apply_drop(payload, t)
        elif kind == "add":
            apply_add(payload, t)
        try_dispatch(t)
        issue_prefetch(t)
    if done + len(pruned_set) != n_tasks:
        raise RuntimeError(
            f"deadlock: {done}/{n_tasks} tasks completed "
            f"({len(pruned_set)} pruned)"
        )

    return SimResult(
        makespan_ms=makespan,
        n_transfers=comm.n_transfers - comm.kind_counts.get("spill", 0),
        bytes_transferred=comm.bytes_transferred - comm.kind_bytes.get("spill", 0),
        transfer_busy_ms=comm.busy_ms,
        proc_busy_ms=busy,
        kernels_per_class=per_class,
        decision_overhead_ms=metrics["overhead"],
        offline_decision_ms=offline_ms,
        trace=[e for e in trace if e is not None],
        transfers=[
            (t.block, t.src, t.dst, t.start, t.finish)
            for t in comm.transfers
            if t.kind != "spill"
        ],
        aborted=aborted,
        dropped_procs=dropped,
        added_procs=added,
        spill_events=metrics["spills"],
        spilled_bytes=metrics["spilled"],
        peak_mem_bytes=peak_mem,
        lane_busy_ms=comm.lane_busy_ms(),
        n_prefetched=comm.n_prefetched,
        reload_events=metrics["reloads"],
        tier_busy_ms=comm.tier_busy_ms(),
        n_throttled=comm.n_throttled,
        demand_latency_ms=comm.demand_latency_ms(),
        n_preempted=comm.n_preempted,
        n_streamed=comm.n_streamed,
        n_stalled_chunks=comm.n_stalled_chunks,
        stream_busy_ms=comm.stream_busy_ms,
        n_depth_adjust=comm.n_depth_adjust,
        n_pruned=len(pruned_log),
        pruned=pruned_log,
    )


def wave_schedule(
    g: TaskGraph,
    assignment: Mapping[str, str],
    platform: Platform,
    *,
    host_group: str | None = None,
    async_groups: bool = False,
    streaming: bool = False,
    chunk_bytes: int | None = None,
    stream_depth: int = 2,
    input_bytes: Mapping[str, int] | None = None,
    throttle: bool | None = None,
) -> SimResult:
    """Deterministic model of the FUSED executor's group-super-step schedule.

    Mirrors ``ExecSession(fused=True, cost_clock=True, prefetch_depth=0)``
    booking-for-booking: the same chain-planning scan, the same donor choice,
    the same :meth:`CommEngine.fetch`/:meth:`CommEngine.open_stream` calls,
    and the cost table as the kernel clock — so the simulated and executed
    virtual timelines agree exactly (see ``tests/test_waves.py``).  With
    ``async_groups`` every group with a runnable chain dispatches in the same
    wave (pulls booked at the consumer's own gate); without it group-steps
    serialize through the previous step's finish, exactly like
    ``_fused_superstep``.

    Residency is accounted by **interval sweep**, not a sequential running
    sum: every block contributes a ``[production, last-consumer-finish]``
    interval on its holding class (pulled copies contribute on the pulling
    class), and ``peak_mem_bytes`` is the sweep maximum — so two groups'
    footprints that overlap in wave time are counted as co-resident.  When a
    class's peak would exceed ``Platform.mem_capacity_bytes`` the sweep
    evicts the oldest still-active interval (FIFO, like the event
    simulator's spill) and charges ``spill_events``/``spilled_bytes``.

    ``input_bytes`` sizes the seeded ``<kernel>/in`` host blocks (the
    executor derives them from the real arrays); absent keys transfer for
    free, matching a zero-byte seed.
    """
    g.validate()
    classes = platform.classes
    host = host_group if host_group is not None else min(classes)
    node_of = {cls: platform.node_of_class(cls) for cls in classes}
    comm = CommEngine(platform.topo, throttle=throttle)
    in_bytes = dict(input_bytes or {})

    valid: dict[str, set[str]] = {}  # block -> groups holding a copy
    vt_block: dict[tuple[str, str], float] = {}
    seeds: set[str] = set()
    order = [n for n in g.topo_order() if g.nodes[n].op != "source"]
    for n in order:
        preds = g.predecessors(n)
        if not preds or any(g.nodes[p].op == "source" for p in preds):
            block = n + "/in"
            seeds.add(block)
            valid[block] = {host}
            vt_block[(block, host)] = 0.0

    done: set[str] = set()
    group_free: dict[str, float] = {}
    vnow = 0.0
    vmax = 0.0
    n_waves = 0
    pending: list[tuple[str, str, object]] = []  # (block, grp, channel)
    block_window: dict[str, tuple[float, float]] = {}
    busy: dict[str, float] = {}
    per_class: dict[str, int] = {}
    trace: list[tuple] = []
    # residency intervals: [cls, bytes, start, end]; ``end is None`` until the
    # block's last consumer retires (exit blocks close at the makespan)
    intervals: list[list] = []
    own_iv: dict[str, list] = {}  # kernel -> its output's interval

    def pull(key: str, nbytes: int, grp: str, now: float) -> int:
        """Mirror of ``ExecSession._pull`` (demand path) on model state."""
        ent = valid.get(key)
        if ent is None or grp in ent:
            return 0
        donor = min(ent, key=lambda o: (vt_block.get((key, o), 0.0), o))
        nb = nbytes or in_bytes.get(key, 0)
        src_ready = vt_block.get((key, donor), 0.0)
        if streaming:
            win = block_window.get(key)
            src_start = (
                win[0]
                if win is not None and abs(win[1] - src_ready) <= 1e-9
                else None
            )
            ch = comm.open_stream(
                key,
                node_of[donor],
                node_of[grp],
                nb,
                now=now,
                src_start=src_start,
                src_ready=src_ready,
                chunk_bytes=chunk_bytes,
                depth=stream_depth,
            )
            if ch is not None:
                vt_block[(key, grp)] = ch.first_ready
                pending.append((key, grp, ch))
                ent.add(grp)
                return nb
        te = comm.fetch(
            key, node_of[donor], node_of[grp], nb, now=now, src_ready=src_ready
        )
        vt_block[(key, grp)] = te
        ent.add(grp)
        return nb

    n_transfers = 0
    nbytes_total = 0
    while len(done) < len(order):
        # pass 1 — chain planning, one chain per still-unclaimed group (the
        # serial arm plans exactly one chain per round)
        plans: list[dict] = []
        claimed: set[str] = set()
        while True:
            grp: str | None = None
            members: list[str] = []
            midx: dict[str, int] = {}
            entries: list[list] = []
            for n in order:
                if n in done:
                    continue
                n_grp = assignment.get(n, host)
                if n_grp in claimed or (grp is not None and n_grp != grp):
                    continue
                preds = g.predecessors(n)
                entry: list = []
                runnable = True
                for p in preds:
                    if p in midx:
                        continue  # intra-chain: handled by group_free order
                    if g.nodes[p].op == "source":
                        entry.append((n + "/in", 0))
                    elif p in done:
                        entry.append((p, g.edge(p, n).nbytes))
                    else:
                        runnable = False
                        break
                if not runnable:
                    continue
                if not preds and (n + "/in") in valid:
                    entry.append((n + "/in", 0))
                if grp is None:
                    grp = n_grp
                midx[n] = len(members)
                members.append(n)
                entries.append(entry)
            if grp is None:
                break
            claimed.add(grp)
            plans.append(dict(grp=grp, members=members, midx=midx, entries=entries))
            if not async_groups:
                break
        if not plans:
            raise RuntimeError(
                f"deadlock: {len(done)}/{len(order)} kernels scheduled"
            )

        # pass 2 — pulls (async: at the consumer's own gate; serial: at the
        # previous group-step's finish, i.e. the round-start clock)
        consumers: dict[str, set[str]] = {}
        for pl in plans:
            grp = pl["grp"]
            gate = group_free.get(grp, 0.0)
            pulled: set[str] = set()
            ready_vt: list[float] = []
            member_chans: list[list] = []
            for i, n in enumerate(pl["members"]):
                rv = 0.0
                nch0 = len(pending)
                for key, nb in pl["entries"][i]:
                    if key not in valid:
                        continue
                    if key not in pulled:
                        moved = pull(key, nb, grp, gate if async_groups else vnow)
                        if moved:
                            n_transfers += 1
                            nbytes_total += moved
                        pulled.add(key)
                        consumers.setdefault(key, set()).add(grp)
                    rv = max(rv, vt_block.get((key, grp), 0.0))
                ready_vt.append(rv)
                member_chans.append(pending[nch0:])
            pending.clear()
            pl.update(ready_vt=ready_vt, member_chans=member_chans, pulled=pulled)

        # wave seal — mirror of the executor's cross-boundary release +
        # donation: copies dead outside the wave collapse onto the consuming
        # chain, whose copy is then consumed by the fused call (the
        # serialized arm, like _fused_superstep, never releases)
        wave_grp_of = {
            n: pl["grp"] for pl in plans for n in pl["members"]
        }
        for pl in plans if async_groups else []:
            grp = pl["grp"]
            for key in pl["pulled"]:
                if key in seeds or key not in g.nodes:
                    continue
                succs = g.successors(key)
                if not succs or len(consumers.get(key, ())) != 1:
                    continue
                if not all(s in done or wave_grp_of.get(s) == grp for s in succs):
                    continue
                ent = valid.get(key)
                if ent is None:
                    continue
                for ogrp in [o for o in ent if o != grp]:
                    ent.discard(ogrp)
                    vt_block.pop((key, ogrp), None)

        # retire — the cost table IS the clock (cost_clock semantics)
        wave_hi = 0.0
        for pl in plans:
            grp = pl["grp"]
            member_set = pl["midx"].keys()
            for i, n in enumerate(pl["members"]):
                kms = g.nodes[n].cost_on(grp)
                vstart = max(group_free.get(grp, 0.0), pl["ready_vt"][i])
                vfinish = vstart + kms
                for key, cgrp, ch in pl["member_chans"][i]:
                    ch_finish, arrival_last = ch.drain(vstart, kms)
                    vfinish = max(vfinish, ch_finish)
                    vt_block[(key, cgrp)] = arrival_last
                group_free[grp] = vfinish
                vmax = max(vmax, vfinish)
                if not async_groups:
                    vnow = vfinish
                block_window[n] = (vstart, vfinish)
                wave_hi = max(wave_hi, vfinish)
                valid[n] = {grp}
                vt_block[(n, grp)] = vfinish
                done.add(n)
                busy[grp] = busy.get(grp, 0.0) + kms
                per_class[grp] = per_class.get(grp, 0) + 1
                trace.append((n, grp, vstart, vfinish))
                mb = g.nodes[n].mem_bytes
                if mb > 0:
                    iv = [grp, mb, vstart, None]
                    own_iv[n] = iv
                    intervals.append(iv)
                # close consumed predecessors' intervals at this finish
                for p in g.predecessors(n):
                    iv = own_iv.get(p)
                    if iv is not None and all(
                        s in done for s in g.successors(p)
                    ):
                        iv[3] = vfinish
            # donation mirror: the chain's sole dead externals are consumed
            for key in pl["pulled"]:
                if key in seeds or key not in g.nodes:
                    continue
                ent = valid.get(key)
                if ent != {grp} or not g.successors(key):
                    continue
                if all(s in done or s in member_set for s in g.successors(key)):
                    ent.discard(grp)
                    if not ent:
                        del valid[key]
                    vt_block.pop((key, grp), None)
            # pulled-copy residency: a cross-group copy is co-resident on the
            # pulling class from its arrival until the chain retires
            for key in pl["pulled"]:
                mb = (
                    g.nodes[key].mem_bytes
                    if key in g.nodes
                    else in_bytes.get(key, 0)
                )
                arr = vt_block.get((key, grp))
                if mb > 0 and arr is not None:
                    intervals.append([grp, mb, arr, group_free.get(grp, 0.0)])
        if async_groups:
            vnow = max(vnow, wave_hi)
            comm.poll(vnow)
        n_waves += 1

    # interval sweep: per-class co-resident peak + FIFO spill emulation.
    # (The old sequential-group accounting under-counted exactly the overlap
    # waves create: two groups' live footprints in the same wall-clock span.)
    peak_mem: dict[str, float] = {}
    spills = 0
    spilled = 0
    for cls in {iv[0] for iv in intervals}:
        cap = platform.mem_cap_of(cls)
        ivs = sorted(
            (
                [iv[2], vmax if iv[3] is None else iv[3], iv[1]]
                for iv in intervals
                if iv[0] == cls
            ),
            key=lambda e: e[0],
        )
        active: list[list] = []  # FIFO of [start, end, bytes] still resident
        load = 0.0
        peak = 0.0
        for start, end, nb in ivs:
            active = [a for a in active if a[1] > start + 1e-9]
            load = sum(a[2] for a in active)
            while load + nb > cap + 1e-6 and active:
                victim = active.pop(0)  # oldest resident spills to host
                load -= victim[2]
                spills += 1
                spilled += victim[2]
            active.append([start, end, nb])
            load += nb
            peak = max(peak, load)
        peak_mem[cls] = peak

    return SimResult(
        makespan_ms=vmax,
        n_transfers=n_transfers,
        bytes_transferred=nbytes_total,
        transfer_busy_ms=comm.busy_ms,
        proc_busy_ms=busy,
        kernels_per_class=per_class,
        decision_overhead_ms=0.0,
        offline_decision_ms=0.0,
        trace=trace,
        transfers=[
            (t.block, t.src, t.dst, t.start, t.finish) for t in comm.transfers
        ],
        spill_events=spills,
        spilled_bytes=spilled,
        peak_mem_bytes=peak_mem,
        lane_busy_ms=comm.lane_busy_ms(),
        tier_busy_ms=comm.tier_busy_ms(),
        n_streamed=comm.n_streamed,
        n_stalled_chunks=comm.n_stalled_chunks,
        stream_busy_ms=comm.stream_busy_ms,
        n_waves=n_waves,
    )
