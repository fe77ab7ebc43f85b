"""Fault tolerance + elasticity: heartbeats, failure detection, straggler
mitigation, and elastic re-partitioning.

This is the paper's scheduler made *online* (its §IV.D names the offline
restriction an "implementation issue, not caused by nature"):

* every device group reports heartbeats with step timings;
* a failed / straggling group changes the *throughput vector* of the
  platform — exactly the paper's Formula (1)/(2) inputs;
* the controller recomputes target ratios and re-partitions the task graph
  (or re-sizes the data-parallel mesh) with ``repro_torch.core.partition``;
* training resumes from the last checkpoint on the surviving mesh.

On this single-host container, failures are *injected* (tests/ft) — the
detection/replan path is identical to what a real multi-host deployment
runs; only the transport (here: in-process dict) differs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Mapping

from ..core.graph import TaskGraph
from ..core.partition import partition_taskgraph, cut_stats


@dataclasses.dataclass
class Heartbeat:
    group: str
    step: int
    step_time_ms: float
    t_wall: float


class HeartbeatMonitor:
    """Tracks per-group liveness + EWMA step times; flags failures and
    stragglers."""

    def __init__(
        self,
        groups: list[str],
        *,
        timeout_s: float = 10.0,
        straggle_factor: float = 1.5,
        ewma: float = 0.3,
    ):
        self.timeout_s = timeout_s
        self.straggle_factor = straggle_factor
        self.ewma = ewma
        self.last: dict[str, Heartbeat] = {}
        self.step_ms: dict[str, float] = {g: 0.0 for g in groups}
        self.groups = list(groups)

    def report(self, hb: Heartbeat):
        self.last[hb.group] = hb
        prev = self.step_ms.get(hb.group, 0.0)
        self.step_ms[hb.group] = (
            hb.step_time_ms
            if prev == 0.0
            else (1 - self.ewma) * prev + self.ewma * hb.step_time_ms
        )

    def failed(self, now: float | None = None) -> list[str]:
        now = time.time() if now is None else now
        out = []
        for g in self.groups:
            hb = self.last.get(g)
            if hb is None or now - hb.t_wall > self.timeout_s:
                out.append(g)
        return out

    def stragglers(self) -> list[str]:
        alive = {g: t for g, t in self.step_ms.items() if t > 0}
        if len(alive) < 2:
            return []
        med = sorted(alive.values())[len(alive) // 2]
        return [g for g, t in alive.items() if t > self.straggle_factor * med]


@dataclasses.dataclass
class ReplanResult:
    assignment: Mapping[str, str]
    targets: Mapping[str, float]
    stats: dict
    reason: str


def throughput_targets(
    step_ms: Mapping[str, float],
    *,
    workers: Mapping[str, int] | None = None,
    dead: Iterable[str] = (),
) -> dict[str, float]:
    """Target work fractions proportional to *measured* throughput
    (1 / step-time, optionally scaled by worker count) — the paper's
    Formula (1)/(2) with live data instead of offline profiles.  Dead or
    unmeasured groups get zero share."""
    gone = set(dead)
    alive = {g_: t for g_, t in step_ms.items() if g_ not in gone and t > 0}
    assert alive, "no surviving groups"
    inv = {g_: (workers or {}).get(g_, 1) / t for g_, t in alive.items()}
    s = sum(inv.values())
    return {g_: v / s for g_, v in inv.items()}


def feed_policy(policy, monitor: HeartbeatMonitor) -> dict[str, float]:
    """Monitor -> policy wiring: push per-group EWMA step times into an
    online policy's live-cost view
    (:meth:`repro_torch.core.online.IncrementalGpPolicy.observe_step_ms`), so the
    next target computation is straggler-aware.  Returns the pushed view."""
    view = {g_: t for g_, t in monitor.step_ms.items() if t > 0}
    policy.observe_step_ms(view)
    return view


def replan(
    g: TaskGraph,
    step_ms: Mapping[str, float],
    dead: list[str],
    *,
    edge_ms: Callable[[int], float] | None = None,
    seed: int = 1,
) -> ReplanResult:
    """Re-partition a task graph after failures / straggle.

    Surviving groups get target fractions proportional to their *measured*
    throughput (1 / step_time) — the paper's ratio formula with live data
    instead of offline profiles.  Dead groups get zero.
    """
    targets = throughput_targets(step_ms, dead=dead)
    assignment = partition_taskgraph(g, targets, edge_ms=edge_ms, seed=seed)
    stats = cut_stats(g, assignment, edge_ms=edge_ms)
    reason = f"dead={dead}" if dead else "straggler rebalance"
    return ReplanResult(assignment, targets, stats, reason)


# -- elastic data-parallel mesh resize ---------------------------------------


def surviving_mesh_shape(n_chips_alive: int, model_par: int) -> tuple[int, int]:
    """Largest (data, model) mesh that fits the survivors, keeping TP intact.
    Training resumes from the last checkpoint at the reduced DP width (the
    batch is re-sharded; accumulation steps keep the global batch)."""
    assert n_chips_alive >= model_par, "cannot keep TP groups intact"
    return (n_chips_alive // model_par, model_par)


def accumulation_for(global_batch: int, dp: int, per_device_batch: int) -> int:
    """Gradient-accumulation steps to preserve the global batch after a
    mesh shrink."""
    per_step = dp * per_device_batch
    return max(1, -(-global_batch // per_step))
