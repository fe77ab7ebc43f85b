"""Online incremental re-partition scheduling.

The paper's GP policy decides placement once, offline (§IV.D calls that an
"implementation issue, not caused by nature").  This module lifts the
restriction for a serving system whose task graph and device pool change
between requests:

* :class:`OnlinePartitioner` maintains the multilevel partition from
  ``partition.py`` across **graph deltas** — task arrivals / retirements and
  processor join / leave — using *boundary-local* FM refinement (warm-started
  :func:`repro_torch.core.partition._fm_refine`, which only moves boundary nodes and
  keeps the best-prefix rollback) instead of repartitioning from scratch.
  A refinement only runs when the **imbalance** or the **edge-cut degradation**
  crosses a threshold; a full multilevel repartition is the escalation path
  when local moves cannot restore balance.  Decisions are therefore amortized:
  steady streams pay O(boundary) per delta, not O(graph).

* :class:`IncrementalGpPolicy` adapts the partitioner to the simulator's
  :class:`~repro_torch.core.schedulers.Policy` interface.  Across a stream of graphs
  (the :mod:`repro_torch.core.arena` harness) it carries assignments of persisting
  tasks over and only places the delta; during a run it reacts to
  :class:`~repro_torch.core.simulate.WorkerDrop` / ``WorkerAdd`` events by
  recomputing the paper's Formula (1)/(2) targets over the *live* classes and
  refining with all finished tasks locked.

* **Memory capacity is a first-class dimension**: the partitioner tracks
  exact per-class KV residency across every delta, refuses placements that
  breach a class's byte budget, treats capacity pressure as a refinement
  trigger of its own, and caps Formula (1)/(2) work targets by the memory a
  class can actually hold (:meth:`IncrementalGpPolicy._cap_targets_by_memory`).

Everything is deterministic in ``seed``; wall-clock is only *reported*
(decision-overhead metric), never used for decisions.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Mapping, Sequence

from .comm import Topology, class_nodes_of, link_scale_matrix
from .graph import Kernel, TaskGraph
from .partition import (UGraph, _fm_refine, _repair_capacity, node_weight,
                        partition_indices, weight_graph_of)
from .schedulers import GpPolicy
from .simulate import DEFAULT_CHUNK_BYTES, Platform, Processor, Sim


@dataclasses.dataclass(frozen=True)
class RefineRecord:
    """One (possibly skipped) refinement decision, for audit / benchmarks."""

    kind: str          # "none" | "incremental" | "full"
    reason: str
    ms: float
    cut_before: float
    cut_after: float
    imbalance_before: float
    imbalance_after: float


def _normalize(targets: Mapping[str, float]) -> dict[str, float]:
    s = sum(targets.values())
    if s <= 0:
        raise ValueError(f"degenerate targets {targets!r}")
    return {c: v / s for c, v in targets.items()}


class OnlinePartitioner:
    """Maintains a k-way heterogeneous partition of a live task graph.

    ``targets``: class -> work fraction (the paper's R ratios).
    ``pin``: task -> class assignments that must never move (e.g. the virtual
    source on the host class).
    ``imbalance_trigger``: relative overload of any class that triggers a
    refinement (default ``2 * epsilon``).
    ``cut_trigger``: cut growth factor over the post-refinement baseline that
    triggers a refinement.
    ``capacities``: class -> resident-memory budget in bytes (KV capacity).
    Live per-class residency is tracked exactly across every delta
    (:meth:`mem_loads`); capacity pressure is a refinement trigger of its own,
    and greedy placement / FM moves never breach a budget that any live class
    can still satisfy.

    ``topology`` + ``class_nodes`` make the cut objective and the FM gain
    link-aware: a cut edge is priced at the actual link between the two
    classes' memory nodes (ICI cheap, DCN expensive) instead of one flat
    ``edge_ms``.  With a :class:`~repro_torch.core.comm.HierTopology` that price
    is the bottleneck *tier* of the path (rack uplink in-pod, shared pod
    uplink across pods), and the full-repartition path inherits the
    topology-aware class grouping in recursive bisection — cut edges land on
    cheap tiers first.  ``reload_copies=True`` additionally counts cut KV edges'
    duplicated bytes against the consumer class's budget — the
    reload-accounting view (a block consumed across a cut is resident on
    both sides), so capacity pressure anticipates spill reloads.
    """

    def __init__(self, targets: Mapping[str, float], *, epsilon: float = 0.05,
                 seed: int = 1, weight_source: str | Callable = "min",
                 edge_ms: Callable[[int], float] | None = None,
                 imbalance_trigger: float | None = None,
                 cut_trigger: float = 1.5,
                 pin: Mapping[str, str] | None = None,
                 capacities: Mapping[str, float] | None = None,
                 topology: Topology | None = None,
                 class_nodes: Mapping[str, int] | None = None,
                 reload_copies: bool = False,
                 objective: str = "cut"):
        self.targets = _normalize(targets)
        self.epsilon = epsilon
        self.seed = seed
        self.weight_source = weight_source
        self.edge_ms = edge_ms
        self.imbalance_trigger = (imbalance_trigger if imbalance_trigger
                                  is not None else 2.0 * epsilon)
        self.cut_trigger = cut_trigger
        self.pin = dict(pin or {})
        self.capacities = dict(capacities or {})
        self.topology = topology
        self.class_nodes = dict(class_nodes or {})
        self.reload_copies = reload_copies
        # "interval" = stage-balance refinement for streaming execution (the
        # slowest pipeline stage, compute + non-overlapped cut cost, is what
        # FM shaves); "cut" = classic total-cut objective
        self.objective = objective
        self.g = TaskGraph()
        self.assignment: dict[str, str] = {}
        self.history: list[RefineRecord] = []
        self.n_full = 0
        self.n_incremental = 0
        # compilation-cache revision tag: bumped ONLY by full repartitions
        # (cold resets and escalations rewrite every group's membership, so
        # every compiled super-step keyed on the old tag is stale); warm
        # ingests and boundary-local FM moves keep the tag — only the groups
        # whose chain signature actually changed recompile
        self.revision = 0
        self._baseline_cut = 0.0
        # quantization floor: when neither local moves nor a full repartition
        # can push imbalance below the trigger (coarse task granularity), the
        # achieved value becomes the effective trigger so every subsequent
        # delta does not re-run a provably futile repartition
        self._imb_floor = 0.0
        # analogous floor for irreducible memory overflow (bytes): a demand
        # that simply exceeds total capacity must not re-trigger every delta
        self._mem_floor = 0.0
        self._nw: dict[str, float] = {}   # node-weight cache (costs are stable)
        self._mem_loads: dict[str, float] = {}  # exact live residency / class

    # -- weights -------------------------------------------------------------

    def _node_w(self, name: str) -> float:
        # same dispatch as weight_graph_of, so the trigger gate decides on
        # exactly the weights FM balances; cached (costs are stable)
        w = self._nw.get(name)
        if w is None:
            w = self._nw[name] = node_weight(self.g.nodes[name].costs,
                                             self.weight_source)
        return w

    def _node_m(self, name: str) -> float:
        return float(self.g.nodes[name].mem_bytes)

    def _total_w(self) -> float:
        return sum(self._node_w(n) for n in self.g.nodes)

    def _cap_of(self, cls: str) -> float:
        return self.capacities.get(cls, math.inf)

    def _caps_vector(self, classes: Sequence[str]) -> list[float] | None:
        if not self.capacities:
            return None
        return [self._cap_of(c) for c in classes]

    def _recount_mem(self) -> None:
        """Rebuild the residency ledger from the assignment (refinements
        rewrite placements wholesale; deltas update it incrementally)."""
        loads: dict[str, float] = {}
        for n in self.g.nodes:
            c = self.assignment.get(n)
            if c is not None:
                loads[c] = loads.get(c, 0.0) + self._node_m(n)
        self._mem_loads = loads

    def _edge_w(self, nbytes: int) -> float:
        return max(self.edge_ms(nbytes) if self.edge_ms else float(nbytes),
                   1e-9)

    def _cut_edge_ms(self, ca: str, cb: str, nbytes: int) -> float:
        """Price of a cut edge between classes ``ca`` and ``cb`` — the actual
        src->dst link when the topology is known, else the flat edge weight."""
        if self.topology is not None:
            na, nb = self.class_nodes.get(ca), self.class_nodes.get(cb)
            if na is not None and nb is not None:
                return max(self.topology.transfer_ms(nbytes, na, nb), 1e-9)
        return self._edge_w(nbytes)

    def _link_scale(self, classes: Sequence[str]) -> list[list[float]] | None:
        """Relative link-cost matrix over ``classes`` for FM's gain function
        (None when every class pair rides the same link — scalar exact).
        Classes without a known node (e.g. stranded dead classes) price at
        the default link via distinct fresh node ids (shared helper, same
        semantics as the gp path)."""
        if self.topology is None or not self.class_nodes:
            return None
        return link_scale_matrix(self.topology, self.class_nodes, classes)

    def _ugraph(self) -> tuple[UGraph, list[str]]:
        return weight_graph_of(self.g, weight_source=self.weight_source,
                               edge_ms=self.edge_ms)

    # -- metrics -------------------------------------------------------------

    def loads(self) -> dict[str, float]:
        pw = {c: 0.0 for c in self.targets}
        for n in self.g.nodes:
            c = self.assignment.get(n)  # mid-ingest some nodes are unplaced
            if c in pw:
                pw[c] += self._node_w(n)
        return pw

    def imbalance(self) -> float:
        """max over classes of load / target-load, minus 1 (0 = perfect)."""
        pw = self.loads()
        total = self._total_w()
        if total <= 0:
            return 0.0
        worst = 0.0
        for c, t in self.targets.items():
            if t <= 1e-12:
                if pw.get(c, 0.0) > 1e-12:
                    return float("inf")
                continue
            worst = max(worst, pw[c] / (t * total) - 1.0)
        return worst

    def cut(self) -> float:
        cut = 0.0
        for e in self.g.edges:
            ca, cb = self.assignment[e.src], self.assignment[e.dst]
            if ca != cb:
                cut += self._cut_edge_ms(ca, cb, e.nbytes)
        return cut

    def cut_copy_bytes(self) -> dict[str, float]:
        """Per-class bytes of KV blocks *duplicated* onto a consumer class by
        cut edges: a block consumed across a cut is resident on both its
        producer's class and the consumer's (the spill-reload view).  Counted
        once per (producer, consumer-class) pair."""
        extra: dict[str, float] = {}
        seen: set[tuple[str, str]] = set()
        for e in self.g.edges:
            m = float(self.g.nodes[e.src].mem_bytes)
            if m <= 0:
                continue
            ca = self.assignment.get(e.src)
            cb = self.assignment.get(e.dst)
            if ca is None or cb is None or ca == cb or (e.src, cb) in seen:
                continue
            seen.add((e.src, cb))
            extra[cb] = extra.get(cb, 0.0) + m
        return extra

    def mem_loads(self) -> dict[str, float]:
        """Exact live residency (bytes) per class — maintained incrementally
        across :meth:`add_task` / :meth:`retire_task` and rebuilt whenever a
        refinement rewrites the assignment."""
        out = {c: 0.0 for c in self.targets}
        out.update(self._mem_loads)
        return out

    def mem_overflow(self) -> float:
        """Worst per-class residency overflow above its budget, in bytes
        (0 = every class within capacity, or no capacities declared).  With
        ``reload_copies`` the duplicated bytes of cut KV edges count against
        the consumer class too, so pressure anticipates spill reloads."""
        if not self.capacities:
            return 0.0
        loads = dict(self._mem_loads)
        if self.reload_copies:
            for c, extra in self.cut_copy_bytes().items():
                loads[c] = loads.get(c, 0.0) + extra
        return max(0.0, max((load - self._cap_of(c)
                             for c, load in loads.items()),
                            default=0.0))

    def request_residency(self) -> dict[str, dict[str, float]]:
        """Resident KV bytes per request id, split by holding class — the
        partition-affinity signal the fleet tier consumes: a request whose
        KV already lives on this partition's classes is *warm* here, and
        routing it elsewhere throws that residency away (cold prefill)."""
        out: dict[str, dict[str, float]] = {}
        for n, k in self.g.nodes.items():
            r = k.meta.get("req")
            m = float(k.mem_bytes)
            if r is None or m <= 0:
                continue
            c = self.assignment.get(n)
            if c is None:
                continue
            ent = out.setdefault(r, {})
            ent[c] = ent.get(c, 0.0) + m
        return out

    # -- graph deltas --------------------------------------------------------

    def reset(self, g: TaskGraph, targets: Mapping[str, float] | None = None):
        """Full (cold) ingest: copy ``g`` and repartition from scratch."""
        if targets is not None:
            self.targets = _normalize(targets)
        self.g = g
        self._nw.clear()
        self._imb_floor = 0.0
        self._mem_floor = 0.0
        self._full_repartition("reset")

    def ingest(self, g: TaskGraph,
               targets: Mapping[str, float] | None = None) -> RefineRecord:
        """Warm ingest of a whole new graph revision: carry assignments of
        persisting tasks over, greedy-place the delta, refine if triggered."""
        if targets is not None:
            self.targets = _normalize(targets)
        old = self.assignment
        self.g = g
        self._nw.clear()
        self._imb_floor = 0.0  # new revision: the old quantization floor is stale
        self._mem_floor = 0.0
        self.assignment = {}
        self._mem_loads = {}
        fresh: list[str] = []
        for name in self.g.topo_order():
            cls = self.pin.get(name) or old.get(name)
            if cls is not None and self.targets.get(cls, 0.0) > 1e-12:
                self.assignment[name] = cls
                self._mem_loads[cls] = (self._mem_loads.get(cls, 0.0)
                                        + self._node_m(name))
            else:
                fresh.append(name)
        # amortized placement: one load scan, then O(degree) per fresh node
        pw = self.loads()
        total = self._total_w()
        for name in fresh:
            cls = self._greedy_class(name, pw=pw, total=total)
            self.assignment[name] = cls
            pw[cls] = pw.get(cls, 0.0) + self._node_w(name)
            self._mem_loads[cls] = (self._mem_loads.get(cls, 0.0)
                                    + self._node_m(name))
        return self.maybe_refine("ingest")

    def add_task(self, kernel: Kernel,
                 deps: Sequence[tuple[str, int]] = (), *,
                 refine: bool = True) -> RefineRecord | None:
        """Task arrival: add node + dependency edges, greedy-place it near its
        neighbours (within free memory budgets), then refine if the
        thresholds trip.  Residency accounting updates exactly."""
        self.g.add_kernel(kernel)
        for src, nbytes in deps:
            self.g.add_edge(src, kernel.name, nbytes=nbytes)
        cls = self.pin.get(kernel.name) or self._greedy_class(kernel.name)
        self.assignment[kernel.name] = cls
        self._mem_loads[cls] = (self._mem_loads.get(cls, 0.0)
                                + self._node_m(kernel.name))
        if refine:
            return self.maybe_refine(f"arrival:{kernel.name}")
        return None

    def retire_task(self, name: str, *, refine: bool = True) -> RefineRecord | None:
        """Task retirement (request finished): drop node + incident edges and
        release its resident bytes from the class that held it."""
        cls = self.assignment.get(name)
        if cls is not None:
            self._mem_loads[cls] = max(
                0.0, self._mem_loads.get(cls, 0.0) - self._node_m(name))
        self.g.remove_kernel(name)
        self.assignment.pop(name, None)
        self._nw.pop(name, None)
        self.pin.pop(name, None)
        if refine:
            return self.maybe_refine(f"retire:{name}")
        return None

    def set_targets(self, targets: Mapping[str, float], *,
                    locked: Sequence[str] = (),
                    capacities: Mapping[str, float] | None = None,
                    reason: str = "platform-change") -> RefineRecord:
        """Processor join/leave: new work fractions (and optionally new
        memory budgets — a dead class's capacity leaves with it).  Tasks
        stranded on a class whose target dropped to ~0 (all its workers left)
        are greedily evacuated first; then normal threshold-gated refinement
        runs with ``locked`` tasks (e.g. already-executed ones) pinned in
        place."""
        self.targets = _normalize(targets)
        if capacities is not None:
            self.capacities = dict(capacities)
            self._mem_floor = 0.0
        lock = set(locked)
        for name in self.g.topo_order():
            cls = self.assignment.get(name)
            if (cls not in self.targets or self.targets[cls] <= 1e-12) \
                    and name not in lock and name not in self.pin:
                new_cls = self._greedy_class(name)
                self.assignment[name] = new_cls
                m = self._node_m(name)
                if m and cls is not None:
                    self._mem_loads[cls] = max(
                        0.0, self._mem_loads.get(cls, 0.0) - m)
                if m:
                    self._mem_loads[new_cls] = (
                        self._mem_loads.get(new_cls, 0.0) + m)
        return self.maybe_refine(reason, locked=lock, force=True)

    # -- placement -----------------------------------------------------------

    def _greedy_class(self, name: str, *, pw: dict[str, float] | None = None,
                      total: float | None = None) -> str:
        """Deterministic affinity + capacity placement for one node: prefer
        the class holding the heaviest incident edges, subject to the epsilon
        work band AND the memory budget (a class without free bytes for the
        node is outranked by any class that still fits); break ties toward
        the most underloaded class."""
        w = self._node_w(name)
        m = self._node_m(name)
        if pw is None:
            pw = self.loads()
        if total is None:
            total = self._total_w()
        aff: dict[str, float] = {}
        for p in self.g.predecessors(name):
            c = self.assignment.get(p)
            if c is not None:
                aff[c] = aff.get(c, 0.0) + self._edge_w(self.g.edge(p, name).nbytes)
        for s in self.g.successors(name):
            c = self.assignment.get(s)
            if c is not None:
                aff[c] = aff.get(c, 0.0) + self._edge_w(self.g.edge(name, s).nbytes)
        best = None
        for i, (c, t) in enumerate(self.targets.items()):
            if t <= 1e-12:
                continue
            goal = t * total
            mem_fits = (self._mem_loads.get(c, 0.0) + m
                        <= self._cap_of(c) + 1e-6)
            fits = pw.get(c, 0.0) + w <= goal * (1 + self.epsilon) + 1e-12
            rel_load = (pw.get(c, 0.0) + w) / max(goal, 1e-12)
            cand = (mem_fits, fits, aff.get(c, 0.0), -rel_load, -i)
            if best is None or cand > best[0]:
                best = (cand, c)
        assert best is not None, "no live class to place on"
        return best[1]

    # -- refinement ----------------------------------------------------------

    def maybe_refine(self, reason: str, *, locked: Sequence[str] = (),
                     force: bool = False) -> RefineRecord:
        """Threshold gate -> boundary-local FM -> full-repartition escalation.

        Triggers: work imbalance above the trigger, cut degradation above the
        baseline factor, or **capacity pressure** — any class resident above
        its memory budget (beyond the proven-irreducible floor)."""
        t0 = time.perf_counter()
        imb0, cut0 = self.imbalance(), self.cut()
        cut_ok = cut0 <= self.cut_trigger * self._baseline_cut + 1e-9
        trigger = max(self.imbalance_trigger, self._imb_floor)
        mem_over0 = self.mem_overflow()
        mem_ok = mem_over0 <= self._mem_floor + 1e-6
        if not force and imb0 <= trigger + 1e-12 and cut_ok and mem_ok:
            rec = RefineRecord("none", reason, (time.perf_counter() - t0) * 1e3,
                               cut0, cut0, imb0, imb0)
            self.history.append(rec)
            return rec

        kind = self._incremental_refine(locked)
        imb1 = self.imbalance()
        if (imb1 > trigger or self.mem_overflow() > self._mem_floor + 1e-6) \
                and not locked:
            # local moves could not restore balance/capacity: escalate
            self._full_repartition(reason)
            kind = "full"
            imb1 = self.imbalance()
        cut1 = self.cut()
        self._baseline_cut = cut1
        # only an *unconstrained* refinement proves the residual imbalance
        # unreachable (quantization); a lock-constrained failure must not
        # suppress later attempts once the locks are gone
        mem_over1 = self.mem_overflow()
        if not locked:
            self._imb_floor = imb1 if imb1 > self.imbalance_trigger else 0.0
            self._mem_floor = mem_over1 if mem_over1 > 1e-6 else 0.0
        else:
            if imb1 <= self.imbalance_trigger:
                self._imb_floor = 0.0
            if mem_over1 <= 1e-6:
                self._mem_floor = 0.0
        rec = RefineRecord(kind, reason, (time.perf_counter() - t0) * 1e3,
                           cut0, cut1, imb0, imb1)
        self.history.append(rec)
        return rec

    def _incremental_refine(self, locked: Sequence[str] = ()) -> str:
        if self.g.num_nodes() == 0:
            return "incremental"
        ug, names = self._ugraph()
        classes = list(self.targets)
        # locked tasks may be stranded on a class that just lost its target
        # (e.g. finished work on a dead pod): carry it with a zero target so
        # nothing new lands there but the warm start stays representable
        classes += sorted({c for c in self.assignment.values()
                           if c not in self.targets})
        cidx = {c: i for i, c in enumerate(classes)}
        part = [cidx[self.assignment[n]] for n in names]
        lock = set(locked) | set(self.pin)
        mask = [n in lock for n in names]
        caps = self._caps_vector(classes)
        if caps is not None:
            # arrivals may have left a class over budget: evacuate first so
            # FM starts feasible, then keep every move capacity-legal
            part = _repair_capacity(ug, part, caps, locked=mask)
        part = _fm_refine(ug, part, [self.targets.get(c, 0.0) for c in classes],
                          self.epsilon, max_passes=2, locked=mask,
                          mem_caps=caps, link_scale=self._link_scale(classes),
                          objective=self.objective)
        self.assignment = {n: classes[part[i]] for i, n in enumerate(names)}
        self.assignment.update(self.pin)
        self._recount_mem()
        self.n_incremental += 1
        return "incremental"

    def _full_repartition(self, reason: str):
        self.revision += 1
        if self.g.num_nodes() == 0:
            self.assignment = {}
            self._mem_loads = {}
            self._baseline_cut = 0.0
            return
        ug, names = self._ugraph()
        classes = list(self.targets)
        caps = self._caps_vector(classes)
        scale = self._link_scale(classes)
        part = partition_indices(ug, [self.targets[c] for c in classes],
                                 epsilon=self.epsilon, seed=self.seed,
                                 capacities=caps, link_scale=scale,
                                 objective=self.objective)
        self.assignment = {n: classes[part[i]] for i, n in enumerate(names)}
        if self.pin:
            self.assignment.update(self.pin)
            cidx = {c: i for i, c in enumerate(classes)}
            fixed = [cidx[self.assignment[n]] for n in names]
            mask = [n in self.pin for n in names]
            fixed = _fm_refine(ug, fixed, [self.targets[c] for c in classes],
                               self.epsilon, max_passes=2, locked=mask,
                               mem_caps=caps, link_scale=scale,
                               objective=self.objective)
            self.assignment = {n: classes[fixed[i]] for i, n in enumerate(names)}
            self.assignment.update(self.pin)
        self._recount_mem()
        self.n_full += 1
        self._baseline_cut = self.cut()


# ---------------------------------------------------------------------------
# Policy adapter
# ---------------------------------------------------------------------------

class IncrementalGpPolicy(GpPolicy):
    """GP with online incremental re-partitioning.

    * ``prepare`` on the first graph = the paper's offline partition; on later
      graphs of a stream it carries persisting tasks' placements over and only
      places / refines the delta (``min_overlap`` gates the warm path).
    * ``on_worker_drop`` / ``on_worker_add`` recompute Formula (1)/(2) targets
      over the live classes and refine with finished tasks locked.
    * ``observe_step_ms`` ingests *measured* per-class step times (executor
      wall clocks / :class:`~repro_torch.ft.elastic.HeartbeatMonitor` EWMAs);
      :meth:`_targets_for` then corrects the static cost-table targets by the
      observed throughput, so partition targets track real hardware — the
      straggler-aware closing of the measurement loop.
    * ``admit_task`` admits one late-arriving task into the live partition
      (partial-graph admission for staggered request streams).
    """

    name = "incremental-gp"

    def __init__(self, *, weight_source: str = "min", epsilon: float = 0.05,
                 seed: int = 1, targets: Mapping[str, float] | None = None,
                 scale_by_workers: bool = False,
                 imbalance_trigger: float | None = None,
                 cut_trigger: float = 1.5, min_overlap: float = 0.5,
                 decision_ms: float = 0.0,
                 capacities: Mapping[str, float] | None = None,
                 mem_aware: bool = True, reload_aware: bool = True,
                 streaming: bool = False,
                 chunk_bytes: int | None = DEFAULT_CHUNK_BYTES,
                 async_groups: bool = False):
        super().__init__(weight_source=weight_source, epsilon=epsilon,
                         seed=seed, targets=targets,
                         scale_by_workers=scale_by_workers,
                         capacities=capacities, mem_aware=mem_aware)
        self.reload_aware = reload_aware
        # streaming execution: price a cut edge at the NON-OVERLAPPED chunk
        # cost (residual chunks hide under the consumer's compute; only the
        # first chunk's transfer is exposed) and refine for the pipeline
        # interval instead of total cut
        self.streaming = streaming
        # None -> price streamed edges at the topology's per-route default
        # chunk size (flat topologies resolve to DEFAULT_CHUNK_BYTES)
        self.chunk_bytes = chunk_bytes
        # async multi-group waves: the executed makespan is the MAX over
        # concurrent group chains, not their sum — refine for the
        # stage-balance interval objective, like streaming does
        self.async_groups = async_groups
        self.decision_ms = decision_ms
        self.imbalance_trigger = imbalance_trigger
        self.cut_trigger = cut_trigger
        self.min_overlap = min_overlap
        self.partitioner: OnlinePartitioner | None = None
        self.live_step_ms: dict[str, float] = {}   # class -> measured ms
        self.stats = {"prepare_full": 0, "prepare_warm": 0, "carried": 0,
                      "placed": 0, "admitted": 0}

    # -- measured-cost feedback ------------------------------------------------

    def observe_step_ms(self, step_ms: Mapping[str, float]) -> None:
        """Ingest live per-class step times (already-smoothed EWMAs from a
        :class:`~repro_torch.ft.elastic.HeartbeatMonitor`, or raw executor means).
        Non-positive entries are ignored; consumed by :meth:`_targets_for`."""
        for cls, ms in step_ms.items():
            if ms > 0:
                self.live_step_ms[cls] = float(ms)

    # -- super-step cache keying -----------------------------------------------

    @property
    def revision(self) -> int:
        """Compilation-cache revision tag for the executor's fused
        super-steps: follows the partitioner's full-repartition counter, so
        warm ingests / boundary-local refinements keep compiled group-steps
        warm and a full-repartition escalation invalidates them all."""
        p = self.partitioner
        return p.revision if p is not None else 0

    # -- fleet-tier residency export -------------------------------------------

    def residency(self) -> dict:
        """Everything the fleet router's affinity score reads, in one dict:
        per-request resident KV bytes by class (``requests``), class-level
        residency (``mem_loads``) and cut-duplication pressure
        (``cut_copy_bytes``), plus whether duplicated copies count against
        capacity (``reload_copies``).  Empty before the first prepare."""
        p = self.partitioner
        if p is None:
            return {"requests": {}, "mem_loads": {}, "cut_copy_bytes": {},
                    "reload_copies": False}
        return {"requests": p.request_residency(),
                "mem_loads": p.mem_loads(),
                "cut_copy_bytes": p.cut_copy_bytes(),
                "reload_copies": p.reload_copies}

    def _targets_for(self, g: TaskGraph, platform: Platform) -> dict[str, float]:
        """Formula (1)/(2) targets corrected by *measured* throughput, then
        capped by free memory.

        Each class with a live observation has its static share scaled by
        (cost-table mean kernel ms / observed ms), then the vector is
        renormalized.  Unmeasured classes keep their static share, so with no
        feedback this is exactly :meth:`targets_for` (the paper's offline
        formula); with feedback, a straggling class's target shrinks in
        proportion to how much slower it *actually* runs than the table says.

        On a capacity-declaring platform the result is then passed through
        :meth:`_cap_targets_by_memory`: a class cannot be asked to hold a
        work share whose footprint exceeds its KV budget.  Explicit
        ``targets`` overrides bypass both corrections.
        """
        targets = self.targets_for(g, platform)
        if self.targets_override:
            return targets
        if self.live_step_ms:
            kernels = [k for k in g.nodes.values() if k.op != "source"]
            scaled: dict[str, float] = {}
            for c, t in targets.items():
                ratio = 1.0
                live = self.live_step_ms.get(c, 0.0)
                if live > 0 and kernels:
                    costs = [k.costs[c] for k in kernels if c in k.costs]
                    table = sum(costs) / len(costs) if costs else 0.0
                    if table > 0:
                        ratio = table / live
                scaled[c] = t * ratio
            s = sum(scaled.values())
            if s > 0:
                targets = {c: v / s for c, v in scaled.items()}
        return self._cap_targets_by_memory(targets, g, platform)

    def _cap_targets_by_memory(self, targets: Mapping[str, float],
                               g: TaskGraph, platform: Platform,
                               ) -> dict[str, float]:
        """Clamp each class's work share at its share of the graph's resident
        footprint it can actually hold (water-filling: clamped classes stick
        at capacity, the remainder redistributes over the others
        proportionally).  Assumes footprint roughly tracks work share — exact
        balance is still enforced by the partitioner's hard capacity vector;
        this only keeps Formula (1)/(2) from *asking* for an impossible
        split.  No-op without declared capacities or footprints."""
        caps = self.capacities_for(platform)
        if not caps:
            return dict(targets)
        total_mem = float(g.total_mem_bytes())
        if total_mem <= 0:
            return dict(targets)
        frac = {c: caps.get(c, math.inf) / total_mem for c in targets}
        clamped: dict[str, float] = {}
        for _ in range(len(targets) + 1):
            used = sum(clamped.values())
            rest = {c: targets[c] for c in targets if c not in clamped}
            rest_sum = sum(rest.values())
            if used >= 1.0 - 1e-12 or rest_sum <= 0:
                break
            scale = (1.0 - used) / rest_sum
            over = [c for c in rest if rest[c] * scale > frac[c] + 1e-12]
            if not over:
                return {c: clamped.get(c, targets[c] * scale) for c in targets}
            for c in over:
                clamped[c] = frac[c]
        # demand exceeds total capacity: best effort, shares ~ capacity
        cap_frac = {c: (frac[c] if math.isfinite(frac[c]) else 1.0)
                    for c in targets}
        s = sum(cap_frac.values())
        if s <= 0:
            return dict(targets)
        return {c: v / s for c, v in cap_frac.items()}

    def prepare(self, g: TaskGraph, platform: Platform) -> float:
        t0 = time.perf_counter()
        targets = self._targets_for(g, platform)
        host_cls = next((p.cls for p in platform.procs
                         if p.node == platform.host_node),
                        platform.procs[0].cls)
        pin = {n: host_cls for n, k in g.nodes.items() if k.op == "source"}
        topo = platform.topo
        class_nodes = class_nodes_of(platform)
        p = self.partitioner
        overlap = 0.0
        if p is not None and g.num_nodes():
            overlap = len(p.g.nodes.keys() & g.nodes.keys()) / g.num_nodes()
        caps = self.capacities_for(platform)
        if self.streaming:
            # only the first chunk's wire time is exposed on a streamed edge;
            # residual chunks hide under the consumer's compute
            cb = (self.chunk_bytes if self.chunk_bytes is not None
                  else topo.stream_chunk_bytes())
            edge_ms = lambda nb: topo.worst_ms(min(nb, cb))  # noqa: E731
            objective = "interval"
        else:
            edge_ms = lambda nb: topo.worst_ms(nb)  # noqa: E731
            # wave dispatch runs independent groups concurrently: the
            # executed interval, not the total cut, is what FM should shave
            objective = "interval" if self.async_groups else "cut"
        if p is None or overlap < self.min_overlap:
            p = OnlinePartitioner(
                targets, epsilon=self.epsilon, seed=self.seed,
                weight_source=self.weight_source,
                edge_ms=edge_ms,
                imbalance_trigger=self.imbalance_trigger,
                cut_trigger=self.cut_trigger, pin=pin,
                capacities=caps, topology=topo, class_nodes=class_nodes,
                reload_copies=self.reload_aware and bool(caps),
                objective=objective)
            p.reset(g)
            self.partitioner = p
            self.stats["prepare_full"] += 1
        else:
            carried = len(p.g.nodes.keys() & g.nodes.keys())
            p.pin = dict(pin)
            p.capacities = dict(caps or {})
            p.topology = topo
            p.class_nodes = dict(class_nodes)
            p.reload_copies = self.reload_aware and bool(caps)
            p.edge_ms = edge_ms
            p.objective = objective
            p.ingest(g, targets=targets)
            self.stats["prepare_warm"] += 1
            self.stats["carried"] += carried
            self.stats["placed"] += g.num_nodes() - carried
        self.assignment = dict(p.assignment)
        self.targets = dict(p.targets)
        return (time.perf_counter() - t0) * 1e3

    def admit_task(self, kernel: Kernel,
                   deps: Sequence[tuple[str, int]] = ()) -> float:
        """Admit one late-arriving task into the live partition (the serving
        executor admits request chains as their arrival times pass, instead
        of re-preparing the whole revision).  Mutates the partitioner's graph:
        callers replaying shared stream revisions must hand ``prepare`` a
        private copy first.  Returns decision wall-time in ms."""
        t0 = time.perf_counter()
        p = self.partitioner
        if p is None:
            raise RuntimeError("admit_task() before prepare()")
        p.add_task(kernel, deps)
        self.assignment.update(p.assignment)
        self.stats["admitted"] += 1
        return (time.perf_counter() - t0) * 1e3

    # -- elastic platform events ---------------------------------------------

    def _retarget(self, sim: Sim, reason: str) -> float:
        t0 = time.perf_counter()
        p = self.partitioner
        if p is not None and sim.platform.procs:
            # recompute Formula (1)/(2) over the live platform; a partial-class
            # drop changes targets too when worker-count scaling is on, and
            # live measured costs (if any) fold in via _targets_for
            targets = self._targets_for(sim.g, sim.platform)
            changed = (set(targets) != set(p.targets)
                       or any(abs(targets[c] - p.targets.get(c, 0.0)) > 1e-6
                              for c in targets))
            if changed:
                locked = set(sim.finished) & set(p.g.nodes)
                # a class's memory budget and link endpoints join/leave with
                # its workers
                p.class_nodes = class_nodes_of(sim.platform)
                p.set_targets(targets, locked=locked, reason=reason,
                              capacities=self.capacities_for(sim.platform))
                self.assignment.update(p.assignment)
                self.targets = dict(p.targets)
        return (time.perf_counter() - t0) * 1e3

    def on_worker_drop(self, proc: Processor, sim: Sim) -> float:
        return self._retarget(sim, f"drop:{proc.name}")

    def on_worker_add(self, proc: Processor, sim: Sim) -> float:
        return self._retarget(sim, f"add:{proc.name}")
