"""Fleet tier: partition-affine request routing across executor replicas.

The paper's thesis — partition placement beats queue scheduling because it
keeps data where the work is — stops at one executor.  A serving fleet runs
N replicas behind a front end, and a locality-oblivious front end (round
robin, join-shortest-queue) throws away everything the partitioner learned:
a request whose KV cache is resident on replica A pays a full cold prefill
when the front end sends its next turn to replica B.

:class:`ReplicaRouter` closes that gap.  It admits one shared arena stream
and places each *request* by partition affinity:

* **warm** — the request's KV already resides on some replica (the
  :meth:`~repro_torch.core.online.IncrementalGpPolicy.residency` export:
  per-request bytes from ``OnlinePartitioner.request_residency``); route it
  home, where its prefill runs as a cheap KV *resume*, unless home is
  overloaded this interval;
* **spill** — fresh requests (and warm ones whose home is overloaded,
  draining, or gone) go to the least-loaded replica, ties broken by
  class-level residency pressure (``mem_loads`` + ``cut_copy_bytes`` when
  the partitioner counts reload copies) — join-shortest-queue with a memory
  tie-break.

Replica-level elasticity mirrors the per-worker machinery one tier down
(``WorkerAdd`` / ``WorkerDrop`` churn *inside* a replica still flows through
each step's events): :meth:`ReplicaRouter.add_replica` scales out, and
:meth:`ReplicaRouter.drain` removes a replica *gracefully* — every request
warm there has its KV proactively migrated (counted in
``kv_migrated_bytes``) so it stays warm at its new home, where an abrupt
:meth:`ReplicaRouter.drop_replica` loses the residency and forces cold
prefills.

Replicas are duck-typed: anything with ``name``, ``run_step(step)`` and
optionally ``residency()`` works.  :class:`SimReplica` wraps a simulated
platform + persistent policy; ``repro_torch.core.serving.ExecutorReplica`` wraps
a real-device :class:`~repro_torch.core.serving.ServingExecutor`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from .arena import ArenaStep, requests_of, split_step
from .schedulers import make_policy
from .simulate import Platform, SimResult, simulate

MODES = ("affinity", "round-robin", "jsq")


class SimReplica:
    """One simulated executor replica: a platform plus a persistent policy
    (stateful policies keep their partition warm across stream steps)."""

    def __init__(self, name: str, platform: Platform, policy="incremental-gp",
                 *, policy_kwargs: Mapping | None = None, overlap: bool = True):
        self.name = name
        self.platform = platform
        if isinstance(policy, str):
            policy = make_policy(policy, **(policy_kwargs or {}))
        self.policy = policy
        self.overlap = overlap

    def run_step(self, step: ArenaStep) -> SimResult:
        return simulate(step.graph, self.policy, self.platform,
                        arrivals=step.arrivals, events=step.events,
                        overlap=self.overlap)

    def residency(self) -> dict:
        hook = getattr(self.policy, "residency", None)
        return hook() if hook is not None else {}


@dataclasses.dataclass
class RouterStepReport:
    """One fleet interval: every replica ran its share of the step."""

    tag: str
    makespan_ms: float                  # slowest replica's interval makespan
    per_replica_ms: dict                # replica -> its interval makespan
    latency_ms: dict                    # request -> completion latency (ms)
    warm_hits: int                      # warm requests routed to their home
    warm_misses: int                    # warm requests routed away (KV lost)
    cold: int                           # fresh requests (no residency yet)
    transfers: int = 0
    bytes_moved: int = 0
    spills: int = 0
    n_preempted: int = 0

    def mean_latency_ms(self) -> float:
        lat = list(self.latency_ms.values())
        return sum(lat) / len(lat) if lat else 0.0


@dataclasses.dataclass
class RouterReport:
    """A whole stream through the fleet under one routing mode."""

    mode: str
    steps: list[RouterStepReport] = dataclasses.field(default_factory=list)
    kv_migrated_bytes: float = 0.0      # drained residency moved proactively
    n_migrated: int = 0
    drained: list = dataclasses.field(default_factory=list)
    dropped: list = dataclasses.field(default_factory=list)
    added: list = dataclasses.field(default_factory=list)

    def _latencies(self) -> list[float]:
        return [v for s in self.steps for v in s.latency_ms.values()]

    def mean_latency_ms(self) -> float:
        lat = self._latencies()
        return sum(lat) / len(lat) if lat else 0.0

    def p95_latency_ms(self) -> float:
        lat = sorted(self._latencies())
        if not lat:
            return 0.0
        return lat[min(int(0.95 * (len(lat) - 1) + 0.5), len(lat) - 1)]

    def total_makespan_ms(self) -> float:
        return sum(s.makespan_ms for s in self.steps)

    def warm_hit_rate(self) -> float:
        hits = sum(s.warm_hits for s in self.steps)
        warm = hits + sum(s.warm_misses for s in self.steps)
        return hits / warm if warm else 0.0

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "steps": len(self.steps),
            "mean_latency_ms": self.mean_latency_ms(),
            "p95_latency_ms": self.p95_latency_ms(),
            "total_makespan_ms": self.total_makespan_ms(),
            "warm_hits": sum(s.warm_hits for s in self.steps),
            "warm_misses": sum(s.warm_misses for s in self.steps),
            "cold": sum(s.cold for s in self.steps),
            "warm_hit_rate": self.warm_hit_rate(),
            "transfers": sum(s.transfers for s in self.steps),
            "bytes_moved": sum(s.bytes_moved for s in self.steps),
            "spills": sum(s.spills for s in self.steps),
            "preempted": sum(s.n_preempted for s in self.steps),
            "kv_migrated_bytes": self.kv_migrated_bytes,
            "n_migrated": self.n_migrated,
        }


class ReplicaRouter:
    """Admit a shared request stream, place each request on a replica.

    ``mode`` picks the placement rule — ``"affinity"`` (partition-affine:
    warm requests home, spill least-loaded), ``"round-robin"``, or
    ``"jsq"`` (join-shortest-queue by estimated interval work).  All three
    share the same replicas, the same stream split, and the same warm-KV
    cost model, so a comparison isolates the *routing signal*: with no warm
    requests, affinity degenerates to exactly jsq.

    ``overload`` guards affinity against hot-spotting: a warm request only
    goes home while home's assigned work this interval stays below
    ``overload`` x the fleet-mean share; past that it spills like a cold
    one (and pays the KV loss) rather than queueing behind a burst.
    """

    def __init__(self, replicas: Sequence, *, mode: str = "affinity",
                 resume_factor: float = 0.1, overload: float = 2.0):
        if mode not in MODES:
            raise ValueError(f"unknown router mode {mode!r} (pick from {MODES})")
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.replicas = {r.name: r for r in replicas}
        self.mode = mode
        self.resume_factor = resume_factor
        self.overload = overload
        self.dead: set[str] = set()
        # warm ledger: request -> (home replica, resident KV bytes)
        self.warm_home: dict[str, str] = {}
        self.warm_bytes: dict[str, float] = {}
        # class-level residency pressure per replica (spill tie-break)
        self._pressure: dict[str, float] = {}
        self._rr = 0
        self.report = RouterReport(mode=mode)

    # -- fleet membership ------------------------------------------------------

    def live(self) -> list[str]:
        return [n for n in self.replicas if n not in self.dead]

    def add_replica(self, replica) -> None:
        """Scale-out: the new replica joins cold and fills via spill."""
        if replica.name in self.replicas and replica.name not in self.dead:
            raise ValueError(f"duplicate replica {replica.name!r}")
        self.replicas[replica.name] = replica
        self.dead.discard(replica.name)
        self.report.added.append(replica.name)

    def drain(self, name: str, target: str | None = None) -> float:
        """Graceful removal: proactively migrate every warm request's KV off
        ``name`` (to ``target``, or the least-pressured live replica) BEFORE
        the replica goes away, so those requests stay warm at their new
        home.  Returns the migrated bytes (also accumulated on the report).
        This is the fleet-tier analogue of re-homing a class's blocks before
        a planned ``WorkerDrop``."""
        if name not in self.replicas or name in self.dead:
            raise KeyError(f"unknown or dead replica {name!r}")
        # replica-level drain hook: the executor's own residency snapshot
        # (authoritative at drain time) overrides the router's estimate
        hook = getattr(self.replicas[name], "drain_kv", None)
        if hook is not None:
            for req, nb in (hook() or {}).items():
                if self.warm_home.get(req) == name:
                    self.warm_bytes[req] = float(nb)
        self.dead.add(name)
        others = self.live()
        moved = 0.0
        for req, home in list(self.warm_home.items()):
            if home != name:
                continue
            if not others:
                del self.warm_home[req]
                self.warm_bytes.pop(req, None)
                continue
            dst = target if target in others else min(
                others, key=lambda r: (self._pressure.get(r, 0.0), r))
            self.warm_home[req] = dst
            nb = self.warm_bytes.get(req, 0.0)
            moved += nb
            self._pressure[dst] = self._pressure.get(dst, 0.0) + nb
            self.report.n_migrated += 1
        self.report.kv_migrated_bytes += moved
        self.report.drained.append(name)
        return moved

    def drop_replica(self, name: str) -> None:
        """Abrupt removal (failure): residency on ``name`` is simply lost —
        its warm requests go cold and re-prefill wherever they land next."""
        if name not in self.replicas or name in self.dead:
            raise KeyError(f"unknown or dead replica {name!r}")
        self.dead.add(name)
        for req, home in list(self.warm_home.items()):
            if home == name:
                del self.warm_home[req]
                self.warm_bytes.pop(req, None)
        self.report.dropped.append(name)

    # -- placement -------------------------------------------------------------

    def _est_cost(self, g, names: list[str], entries: set[str],
                  warm: bool) -> float:
        tot = 0.0
        for n in names:
            c = min(g.nodes[n].costs.values())
            if warm and n in entries:
                c *= self.resume_factor
            tot += c
        return tot

    def route_step(self, step: ArenaStep) -> dict[str, str]:
        """Request -> replica placement for one interval, in arrival order
        (the order a front end actually sees)."""
        live = self.live()
        if not live:
            raise RuntimeError("every replica is drained or dropped")
        g = step.graph
        groups = requests_of(g)
        entries = {n for n in g.nodes
                   if all(g.nodes[p].op == "source" for p in g.predecessors(n))}
        arrivals = step.arrivals or {}

        def arrival(req: str) -> float:
            return min((arrivals.get(n, 0.0) for n in groups[req]), default=0.0)

        order = sorted(groups, key=lambda r: (arrival(r), r))
        load = {r: 0.0 for r in live}
        total_est = sum(
            self._est_cost(g, ns, entries, False) for ns in groups.values())
        cap = self.overload * total_est / len(live)
        placement: dict[str, str] = {}

        def spill_target() -> str:
            return min(live, key=lambda r: (load[r],
                                            self._pressure.get(r, 0.0), r))

        for req in order:
            names = groups[req]
            home = self.warm_home.get(req)
            if self.mode == "round-robin":
                rep = live[self._rr % len(live)]
                self._rr += 1
            elif self.mode == "jsq":
                rep = spill_target()
            elif home in load and load[home] <= cap + 1e-9:
                rep = home  # affinity: warm request goes home
            else:
                rep = spill_target()  # cold, home overloaded, or home gone
            placement[req] = rep
            load[rep] += self._est_cost(g, names, entries, rep == home)
        return placement

    # -- execution -------------------------------------------------------------

    def run_step(self, step: ArenaStep) -> RouterStepReport:
        """Route, split, run every replica's share, merge, refresh the warm
        ledger from each replica's residency export."""
        placement = self.route_step(step)
        groups = requests_of(step.graph)
        warm = {rep: {req for req, r in placement.items()
                      if r == rep and self.warm_home.get(req) == rep}
                for rep in self.live()}
        hits = sum(len(s) for s in warm.values())
        misses = sum(1 for req in placement
                     if self.warm_home.get(req) not in (None, placement[req]))
        substeps = split_step(step, placement, warm=warm,
                              resume_factor=self.resume_factor)
        rep_ms: dict[str, float] = {}
        latency: dict[str, float] = {}
        transfers = bytes_moved = spills = preempted = 0
        for rep_name, sub in substeps.items():
            replica = self.replicas[rep_name]
            res = replica.run_step(sub)
            rep_ms[rep_name] = getattr(res, "makespan_ms", 0.0)
            transfers += getattr(res, "n_transfers", 0)
            bytes_moved += getattr(res, "bytes_transferred", 0)
            spills += getattr(res, "spill_events", None) or getattr(
                res, "spills", 0)
            preempted += getattr(res, "n_preempted", 0)
            trace = getattr(res, "trace", None)
            if trace:
                fin: dict[str, float] = {}
                for task, _proc, _s, f in trace:
                    req = step.graph.nodes[task].meta.get("req", task)
                    fin[req] = max(fin.get(req, 0.0), f)
                arr = sub.arrivals or {}
                for req, f in fin.items():
                    t0 = min((arr.get(n, 0.0) for n in groups.get(req, ())),
                             default=0.0)
                    latency[req] = f - t0
            self._refresh_residency(rep_name, replica, placement, step, groups)
        # requests absent from this step have retired: their KV is freed
        for req in list(self.warm_home):
            if req not in placement:
                del self.warm_home[req]
                self.warm_bytes.pop(req, None)
        rep = RouterStepReport(
            tag=step.tag,
            makespan_ms=max(rep_ms.values(), default=0.0),
            per_replica_ms=rep_ms,
            latency_ms=latency,
            warm_hits=hits,
            warm_misses=misses,
            cold=len(placement) - hits - misses,
            transfers=transfers,
            bytes_moved=bytes_moved,
            spills=spills,
            n_preempted=preempted,
        )
        self.report.steps.append(rep)
        return rep

    def _refresh_residency(self, rep_name: str, replica, placement, step,
                           groups):
        """Warm ledger + pressure from the replica's partitioner export;
        graph KV bytes are the fallback for partition-less policies."""
        res = {}
        hook = getattr(replica, "residency", None)
        if hook is not None:
            res = hook() or {}
        per_req = res.get("requests", {})
        for req, rep in placement.items():
            if rep != rep_name:
                continue
            self.warm_home[req] = rep_name
            if req in per_req:
                nb = sum(per_req[req].values())
            else:
                nb = sum(step.graph.nodes[n].mem_bytes
                         for n in groups.get(req, ()))
            self.warm_bytes[req] = float(nb)
        pressure = sum(res.get("mem_loads", {}).values())
        if res.get("reload_copies"):
            pressure += sum(res.get("cut_copy_bytes", {}).values())
        if not res:
            pressure = sum(self.warm_bytes.get(r, 0.0)
                           for r, h in self.warm_home.items() if h == rep_name)
        self._pressure[rep_name] = pressure

    def run(self, stream: Sequence[ArenaStep], *,
            drain_at: Mapping[int, str] | None = None,
            drop_at: Mapping[int, str] | None = None,
            add_at: Mapping[int, Sequence] | None = None) -> RouterReport:
        """Route a whole stream; fleet churn keyed by step index fires
        *before* that step routes (drain migrates KV first, so the step's
        warm requests follow their cache to its new home)."""
        for i, step in enumerate(stream):
            for replica in (add_at or {}).get(i, ()):
                self.add_replica(replica)
            if drain_at and i in drain_at:
                self.drain(drain_at[i])
            if drop_at and i in drop_at:
                self.drop_replica(drop_at[i])
            self.run_step(step)
        return self.report


__all__ = [
    "MODES",
    "ReplicaRouter",
    "RouterReport",
    "RouterStepReport",
    "SimReplica",
]
