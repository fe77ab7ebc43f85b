"""Scheduling policies compared in the paper (§IV.C) plus extras.

* :class:`EagerPolicy` — StarPU ``eager``: one central ready queue, any idle
  worker greedily pops the next task (no data- or perf-awareness).
* :class:`DmdaPolicy` — StarPU ``dmda`` (deque-model data-aware): at ready
  time, assign the task to the worker minimizing *estimated completion* =
  max(worker available, now) + missing-input transfer time + execution time
  from the performance history.  Pays a per-decision overhead (§IV.D).
* :class:`GpPolicy` — the paper's contribution: offline multilevel graph
  partition with heterogeneous target ratios (Formula (1)/(2)); each kernel is
  pinned to its partition's class; the runtime only enforces dependencies.
* :class:`HeftPolicy` — classic HEFT list scheduling (beyond-paper baseline).
* :class:`AffinityStealPolicy` — affinity-driven work stealing (XKaapi-style,
  beyond-paper): per-group deques, idle groups steal only tasks whose missing
  inputs are cheap to pull on the live topology (steal gain = victim-queue
  wait minus the priced pull cost).  The strongest online baseline the gp
  family is benchmarked against (``benchmarks/scenario_bench.py``).
* :class:`RandomPolicy` / :class:`SingleClassPolicy` — controls.
* :class:`WorkerPullPolicy` — the executed-mode dispatch shim: replays any
  reactive queue policy through the discrete-event simulator (its native
  worker-pull habitat) and exports the emergent kernel -> class placement, so
  eager/dmda/heft run on real device groups too.

All cost estimates are topology-aware: dmda prices missing inputs per block
at the actual source->destination link, HEFT's EFT loop charges the real
src-node -> dst-node link, and gp's cut objective uses the platform
topology's link-scale matrix (see ``repro_torch.core.comm``).  On a hierarchical
topology every such price is the bottleneck tier of the actual path (a
cross-pod hop costs the shared uplink, an in-pod hop only the rack link),
so all five policies see the same tiered fabric the simulator charges.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Mapping

from .comm import link_scale_for
from .cost import workload_ratios
from .graph import TaskGraph
from .partition import partition_taskgraph
from .simulate import Platform, Processor, Sim, simulate


class Policy:
    name = "base"
    decision_ms = 0.0
    # True when prepare() yields a kernel -> class map the real executor can
    # honor directly (gp family); reactive queue policies need the
    # WorkerPullPolicy shim for executed mode
    produces_assignment = False

    def prepare(self, g: TaskGraph, platform: Platform) -> float:
        """Offline work; returns offline decision wall-time in ms."""
        return 0.0

    def on_ready(self, task: str, sim: Sim) -> str | None:
        """Return a worker name to enqueue on, or None for the central queue."""
        return None

    def on_idle(self, proc: Processor, sim: Sim) -> str | None:
        """Central-queue policies: pick a task for an idle worker (FIFO)."""
        return sim.central[0] if sim.central else None

    def peek_queue(self, proc: Processor, sim: Sim):
        """Central-queue policies: the tasks ``proc`` is likely to run next,
        in order, so the overlap engine can prefetch their inputs under the
        worker's current compute.  ``None`` (default) hints nothing — push
        policies already expose per-worker queues to the engine."""
        return None

    def on_worker_drop(self, proc: Processor, sim: Sim) -> float:
        """Platform lost ``proc`` (already removed from ``sim.platform``).
        Returns decision time in ms, charged to the overhead metric."""
        return 0.0

    def on_worker_add(self, proc: Processor, sim: Sim) -> float:
        """Platform gained ``proc`` (already inserted into ``sim.platform``)."""
        return 0.0


class EagerPolicy(Policy):
    """Greedy work sharing: exploit any idle processor (paper §IV.C).

    ``mem_aware=True`` (default) adds the capacity admission check on
    platforms that declare memory budgets: an idle worker skips central-queue
    tasks that no longer fit its node's free KV budget while some other live
    class still could take them (overflow-bound tasks dispatch anyway and pay
    the spill).  Capacity-free platforms behave exactly as before."""

    name = "eager"

    def __init__(self, mem_aware: bool = True):
        self.mem_aware = mem_aware

    def on_idle(self, proc: Processor, sim: Sim) -> str | None:
        if not self.mem_aware or not sim.platform.mem_capacity_bytes:
            return super().on_idle(proc, sim)
        for task in sim.central:
            if sim.mem_fits(task, proc.cls):
                return task
            if not any(sim.mem_fits(task, c) for c in sim.platform.classes):
                return task  # fits nowhere live: run here, spill pays
        return None


class DmdaPolicy(Policy):
    """Data-aware earliest-estimated-completion assignment at ready time.

    With ``mem_aware`` (default) and a capacity-declaring platform, workers
    whose memory node cannot hold the task's footprint are excluded from the
    ETA race unless no live worker fits — the same admission check the GP
    flavours apply, keeping the five-policy comparison fair."""

    name = "dmda"

    def __init__(self, decision_ms: float = 0.005, mem_aware: bool = True):
        self.decision_ms = decision_ms
        self.mem_aware = mem_aware

    def on_ready(self, task: str, sim: Sim) -> str:
        procs = sim.platform.procs
        if self.mem_aware and sim.platform.mem_capacity_bytes:
            fitting = [p for p in procs if sim.mem_fits(task, p.cls)]
            if fitting:
                procs = fitting
        best_proc, best_eta = None, None
        for p in procs:
            # per-block, per-link transfer estimate (src node -> p.node)
            ttrans = sim.missing_input_ms(task, p.node)
            texec = sim.exec_ms(task, p.cls)
            eta = max(sim.est_proc_avail[p.name], sim.now) + ttrans + texec
            if best_eta is None or eta < best_eta - 1e-12:
                best_proc, best_eta = p, eta
        assert best_proc is not None
        sim.est_proc_avail[best_proc.name] = best_eta
        return best_proc.name


class AffinityStealPolicy(Policy):
    """Affinity-driven work stealing (XKaapi-style locality-aware stealing).

    The strongest *online* baseline the gp family competes against: a
    pull-based policy whose per-group deques bind tasks to the class where
    their inputs are (or will be) resident, and whose idle groups steal only
    when the steal actually pays — the thief compares the victim-queue wait
    it would save against the topology-priced cost of pulling the task's
    missing inputs to its own memory node
    (:meth:`~repro_torch.core.simulate.Sim.missing_input_ms`, the same per-link
    pricing dmda's ETA and the gp family's ``link_scale`` matrix use).

    Mechanics: every ready task is *homed* to the class minimizing
    pull + execution cost and parked in that class's deque (physically the
    simulator's central queue, so nothing is ever lost to policy-state
    churn).  An idle worker serves its own class's deque FIFO; empty-handed,
    it considers stealing:

    ``steal gain = (victim wait + exec on victim) - (pull cost + exec here)``

    and steals only when the gain clears ``steal_threshold_ms``.  Victim
    selection is a knob: ``"max-queue"`` raids the class with the largest
    backlog (classic load stealing, locality-gated); ``"min-pull"`` scans
    every foreign task for the cheapest pull (locality stealing,
    load-gated).  Ties break toward the task with the most input bytes
    already resident on the thief's node (``resident_ties=True``).

    Churn-safe by construction: a dropped class's deque is re-homed across
    the survivors (tasks still queued lose nothing — they sit in the
    central queue), a task aborted mid-run is re-homed when it re-enters via
    ``on_ready``, and a new class starts stealing its share immediately.
    Executed mode goes through the :class:`WorkerPullPolicy` shim like every
    reactive queue policy.
    """

    name = "affinity-steal"

    def __init__(
        self,
        *,
        steal_threshold_ms: float = 0.5,
        victim: str = "max-queue",
        resident_ties: bool = True,
        mem_aware: bool = True,
        decision_ms: float = 0.003,
    ):
        if victim not in ("max-queue", "min-pull"):
            raise ValueError(f"unknown victim selection {victim!r}")
        self.steal_threshold_ms = steal_threshold_ms
        self.victim = victim
        self.resident_ties = resident_ties
        self.mem_aware = mem_aware
        self.decision_ms = decision_ms
        self.deques: dict[str, deque] = {}
        self.home: dict[str, str] = {}
        self._skipped: set[str] = set()
        self._horizon: dict[str, float] = {}

    def prepare(self, g: TaskGraph, platform: Platform) -> float:
        # per-stream policy instances persist (arena semantics): every graph
        # revision starts with fresh deques, placement state is per-interval
        self.deques = {}
        self.home = {}
        self._skipped = set()
        self._horizon = {}
        return 0.0

    # -- homing ---------------------------------------------------------------
    def _pull_ms(self, task: str, node: int, sim: Sim) -> float:
        return sim.missing_input_ms(task, node)

    def _booked(self, cls: str, sim: Sim) -> float:
        """The class's booking horizon: a virtual clock bumped at homing time
        (like dmda's per-worker ``est_proc_avail``, aggregated per class).
        Sequential chains expose only one ready task at a time, so the deque
        is empty at every individual ready event — without this persistent
        horizon several interleaved chains all home to the fastest class and
        its congestion stays invisible until the workers idle."""
        return max(self._horizon.get(cls, 0.0), sim.now)

    def _home_for(self, task: str, sim: Sim, *, book: bool = True) -> str:
        costs = sim.g.nodes[task].costs
        best, best_eta = None, None
        for cls in sim.platform.classes:
            if cls not in costs:
                continue
            node = sim.platform.node_of_class(cls)
            nw = len(sim.platform.workers_of(cls))
            base = self._booked(cls, sim) if nw else float("inf")
            eta = base + self._pull_ms(task, node, sim) + costs[cls]
            if self.mem_aware and not sim.mem_fits(task, cls):
                eta += 1e9  # only homed here when nothing else fits
            if best_eta is None or eta < best_eta - 1e-12:
                best, best_eta = cls, eta
        if best is None:  # no live class has a cost entry: park anywhere
            best = sim.platform.classes[0] if sim.platform.classes else "?"
        if book:
            nw = len(sim.platform.workers_of(best))
            self._horizon[best] = (self._booked(best, sim)
                                   + costs.get(best, 0.0) / max(nw, 1))
        return best

    def on_ready(self, task: str, sim: Sim) -> str | None:
        home = self._home_for(task, sim)
        self.home[task] = home
        self.deques.setdefault(home, deque()).append(task)
        return None  # physically parked in the central queue

    def peek_queue(self, proc: Processor, sim: Sim):
        # expose the class deque to the overlap engine: the worker will
        # serve it FIFO, so its heads are prefetchable exactly like a push
        # policy's committed per-worker queue
        return self._queued(proc.cls, sim)

    # -- dequeue/steal --------------------------------------------------------
    def _queued(self, cls: str, sim: Sim) -> list[str]:
        """Live deque view: lazily drops tasks no longer in the central
        queue (dispatched, stolen, aborted elsewhere, or pruned)."""
        dq = self.deques.get(cls)
        if not dq:
            return []
        central = set(sim.central)
        while dq and dq[0] not in central:
            dq.popleft()
        return [t for t in dq if t in central]

    def _wait_ms(self, cls: str, ahead_ms: float, sim: Sim) -> float:
        workers = sim.platform.workers_of(cls)
        if not workers:
            return float("inf")  # orphaned deque: stealing is free win
        avail = min(max(sim.proc_free[w.name], sim.now) for w in workers)
        return (avail - sim.now) + ahead_ms / len(workers)

    def _steal_gain(self, task: str, vcls: str, ahead_ms: float,
                    proc: Processor, sim: Sim) -> float:
        costs = sim.g.nodes[task].costs
        if proc.cls not in costs:
            return float("-inf")
        if (self.mem_aware and sim.platform.mem_capacity_bytes
                and not sim.mem_fits(task, proc.cls)
                and any(sim.mem_fits(task, c)
                        for c in sim.platform.classes)):
            return float("-inf")  # don't steal into an overflowing node
        wait = self._wait_ms(vcls, ahead_ms, sim)
        if wait == float("inf"):
            return float("inf")  # orphaned home: stealing is a rescue
        if task in self._skipped:
            # the home class capacity-skipped it; a fitting thief MUST take
            # it regardless of threshold, or it could starve in the central
            # queue (the victim never runs it, other thieves never clear the
            # gain bar)
            return float("inf")
        here = self._pull_ms(task, proc.node, sim) + costs[proc.cls]
        return (wait + costs.get(vcls, 0.0)) - here

    def _resident_frac(self, task: str, node: int, sim: Sim) -> float:
        total = sum(sim.g.edge(p, task).nbytes
                    for p in sim.g.predecessors(task))
        if total <= 0:
            return 1.0
        return 1.0 - sim.missing_input_bytes(task, node) / total

    def on_idle(self, proc: Processor, sim: Sim) -> str | None:
        # 1) serve the worker's own class deque FIFO (capacity-admitted)
        own = self._queued(proc.cls, sim)
        for task in own:
            if proc.cls not in sim.g.nodes[task].costs:
                continue
            if (self.mem_aware and sim.platform.mem_capacity_bytes
                    and not sim.mem_fits(task, proc.cls)
                    and any(sim.mem_fits(task, c)
                            for c in sim.platform.classes)):
                self._skipped.add(task)  # rescue-stealable by fitting thieves
                continue
            self.deques[proc.cls].remove(task)
            self._skipped.discard(task)
            return task
        # 2) empty-handed: steal, if the locality-priced gain clears the bar
        victims: list[tuple[str, list[str]]] = []
        for cls in list(self.deques):
            if cls == proc.cls:
                continue
            q = self._queued(cls, sim)
            if q:
                victims.append((cls, q))
        if not victims:
            return None
        exec_of = {
            cls: {t: sim.g.nodes[t].costs.get(cls, 0.0) for t in q}
            for cls, q in victims
        }
        best: tuple | None = None  # (-gain, -resident_frac, name)
        if self.victim == "max-queue":
            # raid the most-loaded class (by pending work) from the TAIL —
            # the task that would wait longest behind the victim's backlog
            # (the owner serves its deque FIFO, thieves take the other end:
            # classic stealing); ties across equally-loaded victims break
            # by resident bytes
            victims.sort(key=lambda cq: -sum(exec_of[cq[0]].values()))
            top_load = sum(exec_of[victims[0][0]].values())
            for cls, q in victims:
                if sum(exec_of[cls].values()) < top_load - 1e-9:
                    break
                task = q[-1]
                ahead = sum(exec_of[cls].values()) - exec_of[cls][task]
                gain = self._steal_gain(task, cls, ahead, proc, sim)
                if gain > self.steal_threshold_ms:
                    key = (-gain,
                           -self._resident_frac(task, proc.node, sim)
                           if self.resident_ties else 0.0,
                           task, cls)
                    if best is None or key < best:
                        best = key
        else:  # "min-pull": cheapest-to-pull foreign task, gain-gated
            for cls, q in victims:
                ahead = 0.0
                for task in q:
                    gain = self._steal_gain(task, cls, ahead, proc, sim)
                    ahead += exec_of[cls][task]
                    if gain <= self.steal_threshold_ms:
                        continue
                    key = (self._pull_ms(task, proc.node, sim),
                           -self._resident_frac(task, proc.node, sim)
                           if self.resident_ties else 0.0,
                           task, cls)
                    if best is None or key < best:
                        best = key
        if best is None:
            return None
        task, cls = best[2], best[3]
        self.deques[cls].remove(task)
        self._skipped.discard(task)
        self.home[task] = proc.cls
        self.deques.setdefault(proc.cls, deque())
        # move the booking with the task: the victim's horizon sheds the
        # stolen work, the thief's absorbs it
        n_v = len(sim.platform.workers_of(cls))
        if n_v:
            self._horizon[cls] = max(
                sim.now,
                self._booked(cls, sim)
                - sim.g.nodes[task].costs.get(cls, 0.0) / n_v,
            )
        n_t = len(sim.platform.workers_of(proc.cls))
        self._horizon[proc.cls] = (
            self._booked(proc.cls, sim)
            + sim.g.nodes[task].costs.get(proc.cls, 0.0) / max(n_t, 1)
        )
        return task

    # -- churn hooks ----------------------------------------------------------
    def on_worker_drop(self, proc: Processor, sim: Sim) -> float:
        t0 = time.perf_counter()
        if not sim.platform.workers_of(proc.cls):
            # class lost its last worker: re-home its queued tasks across the
            # survivors (they stay physically in the central queue throughout)
            orphans = list(self.deques.pop(proc.cls, ()))
            for task in orphans:
                if task in sim.central and task in sim.g.nodes:
                    home = self._home_for(task, sim)
                    self.home[task] = home
                    self.deques.setdefault(home, deque()).append(task)
        return (time.perf_counter() - t0) * 1e3

    def on_worker_add(self, proc: Processor, sim: Sim) -> float:
        # nothing to migrate: the newcomer starts stealing its share
        self.deques.setdefault(proc.cls, deque())
        return 0.0


class GpPolicy(Policy):
    """The paper's graph-partition policy.

    ``produces_assignment``: prepare() leaves a kernel -> class map in
    ``self.assignment`` that the real-device executor honors directly.

    ``weight_source`` follows §III.B: node weights can come from the GPU or the
    CPU execution time (GPU default — smaller node weights give edge weights
    higher partitioning priority).  Targets come from Formula (1)/(2), scaled
    by per-class worker counts.
    """

    name = "gp"
    produces_assignment = True

    def __init__(
        self,
        *,
        weight_source: str = "gpu",
        epsilon: float = 0.05,
        seed: int = 1,
        targets: Mapping[str, float] | None = None,
        scale_by_workers: bool = False,
        capacities: Mapping[str, float] | None = None,
        mem_aware: bool = True,
    ):
        """``scale_by_workers=False`` is the paper's literal Formula (1)/(2)
        (per-kernel times only); True additionally scales each class's share
        by its worker count (a natural extension when classes have several
        independent workers — used by the TPU-group adaptation).

        ``capacities`` (class -> bytes) overrides the platform's declared
        memory budgets; ``mem_aware=False`` partitions capacity-blind even on
        a budgeted platform (the ablation baseline)."""
        self.weight_source = weight_source
        self.epsilon = epsilon
        self.seed = seed
        self.targets_override = dict(targets) if targets else None
        self.scale_by_workers = scale_by_workers
        self.capacities_override = dict(capacities) if capacities else None
        self.mem_aware = mem_aware
        self.assignment: dict[str, str] = {}
        self._rr: dict[str, int] = {}

    def capacities_for(self, platform: Platform) -> dict[str, float] | None:
        """Per-class memory budgets the partitioner must respect (None =
        capacity-blind: no override, opted out, or an unbudgeted platform)."""
        if self.capacities_override is not None:
            return dict(self.capacities_override)
        if not self.mem_aware or not platform.mem_capacity_bytes:
            return None
        return {c: platform.mem_cap_of(c) for c in platform.classes}

    def targets_for(self, g: TaskGraph, platform: Platform) -> dict[str, float]:
        """Formula (1)/(2) targets (or the override), optionally scaled by
        per-class worker counts — shared with the online variant so the two
        GP flavours stay comparable."""
        if self.targets_override:
            return dict(self.targets_override)
        classes = platform.classes
        targets = workload_ratios(g, classes)
        if self.scale_by_workers:
            scaled = {c: targets[c] * len(platform.workers_of(c)) for c in classes}
            s = sum(scaled.values())
            targets = {c: v / s for c, v in scaled.items()}
        return targets

    def prepare(self, g: TaskGraph, platform: Platform) -> float:
        t0 = time.perf_counter()
        targets = self.targets_for(g, platform)
        topo = platform.topo
        host_cls = next(p.cls for p in platform.procs if p.node == platform.host_node)
        pin = {n: host_cls for n, k in g.nodes.items() if k.op == "source"}
        # edge weights priced at the worst link; the link-scale matrix turns
        # that into per-class-pair prices inside the FM gain function
        self.assignment = partition_taskgraph(
            g,
            targets,
            weight_source=self.weight_source,
            edge_ms=lambda nb: topo.worst_ms(nb),
            epsilon=self.epsilon,
            seed=self.seed,
            pin=pin,
            capacities=self.capacities_for(platform),
            link_scale=link_scale_for(platform, list(targets)),
        )
        self.targets = targets
        return (time.perf_counter() - t0) * 1e3

    def on_ready(self, task: str, sim: Sim) -> str:
        cls = self.assignment[task]
        workers = sim.platform.workers_of(cls)
        if not workers:
            # assigned class lost every worker to drops: fall back to any
            # live class the kernel has a cost for (least-loaded)
            costs = sim.g.nodes[task].costs
            workers = [p for p in sim.platform.procs if p.cls in costs]
            cls = None
        w = min(
            workers,
            key=lambda p: (
                sim.est_proc_avail[p.name],
                len(sim.proc_queue[p.name]),
                p.name,
            ),
        )
        # least-loaded worker within the pinned class (StarPU would let its
        # per-class queue do this; we approximate with earliest-available)
        sim.est_proc_avail[w.name] = max(
            sim.est_proc_avail[w.name], sim.now
        ) + sim.exec_ms(task, cls if cls is not None else w.cls)
        return w.name


class HeftPolicy(Policy):
    """Heterogeneous Earliest Finish Time (offline list scheduling)."""

    name = "heft"

    def __init__(self):
        self.assignment: dict[str, str] = {}
        self.rank: dict[str, float] = {}

    def prepare(self, g: TaskGraph, platform: Platform) -> float:
        t0 = time.perf_counter()
        classes = platform.classes
        mean_cost = {
            n: sum(k.costs.get(c, 0.0) for c in classes) / len(classes)
            for n, k in g.nodes.items()
        }
        topo = platform.topo
        mean_edge = {
            (e.src, e.dst): topo.worst_ms(e.nbytes) * 0.5 for e in g.edges
        }  # 0.5: same-node edges are free on average
        rank: dict[str, float] = {}
        for n in reversed(g.topo_order()):
            succ = g.successors(n)
            rank[n] = mean_cost[n] + max(
                (mean_edge[(n, s)] + rank[s] for s in succ), default=0.0
            )
        self.rank = rank
        # EFT assignment in rank order, non-insertion variant
        avail = {p.name: 0.0 for p in platform.procs}
        finish: dict[str, float] = {}
        where: dict[str, Processor] = {}
        for n in sorted(g.nodes, key=lambda x: -rank[x]):
            best = None
            for p in platform.procs:
                ready = 0.0
                for pr in g.predecessors(n):
                    c = finish.get(pr, 0.0)
                    if where.get(pr) is not None and where[pr].node != p.node:
                        # the actual src-node -> dst-node link, not a flat bus
                        c += topo.transfer_ms(
                            g.edge(pr, n).nbytes, where[pr].node, p.node
                        )
                    ready = max(ready, c)
                eft = max(avail[p.name], ready) + g.nodes[n].cost_on(p.cls)
                if best is None or eft < best[0]:
                    best = (eft, p)
            eft, p = best
            avail[p.name] = eft
            finish[n] = eft
            where[n] = p
            self.assignment[n] = p.name
        return (time.perf_counter() - t0) * 1e3

    def on_ready(self, task: str, sim: Sim) -> str:
        return self.assignment[task]

    def priority(self, task: str) -> float:
        return self.rank[task]


class RandomPolicy(Policy):
    name = "random"

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._n = 0

    def on_ready(self, task: str, sim: Sim) -> str:
        self._n += 1
        h = hash((task, self.seed, self._n)) & 0xFFFFFFFF
        procs = sim.platform.procs
        return procs[h % len(procs)].name


class SingleClassPolicy(Policy):
    """Pin everything to one class (e.g. gpu-only / cpu-only controls)."""

    def __init__(self, cls: str):
        self.cls = cls
        self.name = f"only-{cls}"
        self._rr = 0

    def on_ready(self, task: str, sim: Sim) -> str:
        workers = sim.platform.workers_of(self.cls)
        w = min(workers, key=lambda p: (sim.est_proc_avail[p.name], p.name))
        sim.est_proc_avail[w.name] = max(
            sim.est_proc_avail[w.name], sim.now
        ) + sim.exec_ms(task, self.cls)
        return w.name


class WorkerPullPolicy(Policy):
    """Executed-mode dispatch shim for reactive queue policies.

    eager/dmda/heft decide placement *during* dispatch — an idle worker pulls
    the next task — so they have no kernel -> class map the real executor
    could honor up front.  This shim gives them one: ``prepare`` replays the
    wrapped policy through the discrete-event simulator (its native
    worker-pull habitat, same platform, same cost tables) and exports the
    emergent task -> class placement; platform churn re-runs the pull loop
    over the unfinished suffix.  The real-device table in
    ``launch/serve.py --execute`` compares all five policies through this.
    """

    produces_assignment = True

    def __init__(self, base: Policy):
        self.base = base
        self.name = base.name
        self.assignment: dict[str, str] = {}

    def _pull_assign(self, g: TaskGraph, platform: Platform) -> dict[str, str]:
        res = simulate(g, self.base, platform)
        cls_of = {p.name: p.cls for p in platform.procs}
        return {
            task: cls_of[proc]
            for task, proc, _start, _finish in res.trace
            if proc in cls_of and g.nodes[task].op != "source"
        }

    def prepare(self, g: TaskGraph, platform: Platform) -> float:
        t0 = time.perf_counter()
        self.assignment = self._pull_assign(g, platform) if g.num_nodes() else {}
        return (time.perf_counter() - t0) * 1e3

    def _replan(self, state) -> float:
        """Platform churn (serving executor's ``_LiveState``): re-run the
        pull loop on the live platform; only unfinished tasks may move."""
        t0 = time.perf_counter()
        if state.platform.procs and state.g.num_nodes():
            fresh = self._pull_assign(state.g, state.platform)
            for task, cls in fresh.items():
                if task not in state.finished:
                    self.assignment[task] = cls
        return (time.perf_counter() - t0) * 1e3

    def on_worker_drop(self, proc: Processor, state) -> float:
        return self._replan(state)

    def on_worker_add(self, proc: Processor, state) -> float:
        return self._replan(state)

    def on_ready(self, task: str, sim: Sim) -> str | None:
        # shim used inside the simulator (parity tests): defer to the base
        return self.base.on_ready(task, sim)

    def on_idle(self, proc: Processor, sim: Sim) -> str | None:
        return self.base.on_idle(proc, sim)


def as_executed(policy: Policy) -> Policy:
    """The executed-mode form of ``policy``: itself when its prepare()
    already yields a class assignment (gp family), else wrapped in the
    worker-pull shim."""
    if getattr(policy, "produces_assignment", False):
        return policy
    return WorkerPullPolicy(policy)


ALL_POLICIES = {
    "eager": EagerPolicy,
    "dmda": DmdaPolicy,
    "affinity-steal": AffinityStealPolicy,
    "gp": GpPolicy,
    "heft": HeftPolicy,
    "random": RandomPolicy,
}


def make_policy(name: str, **kw) -> Policy:
    if name.startswith("only-"):
        return SingleClassPolicy(name[len("only-") :])
    if name == "incremental-gp":
        from .online import IncrementalGpPolicy  # lazy: avoids import cycle

        return IncrementalGpPolicy(**kw)
    return ALL_POLICIES[name](**kw)


POLICY_NAMES = tuple(ALL_POLICIES) + ("incremental-gp",)
