"""Multilevel graph partitioner — the METIS role in the paper, built from
scratch (no external dependency).

Pipeline (classic multilevel scheme, as METIS):
  1. **Coarsen** by heavy-edge matching until the graph is small;
  2. **Initial partition** at the coarsest level by greedy graph growing
     (multiple random trials, keep the best cut);
  3. **Uncoarsen + refine** with Fiduccia–Mattheyses boundary passes that keep
     partition weights within ``epsilon`` of heterogeneous *target fractions*
     (the paper's R_cpu/R_gpu from Formula (1)/(2)).

k-way partitions are produced by recursive bisection with target-weight
splitting, then a final k-way FM pass.  Everything is deterministic in
``seed`` (own LCG; no global RNG).

**Multi-constraint extension** (beyond the paper): every node carries a weight
*vector* — compute milliseconds (``nw``, the balance objective) and resident
memory bytes (``nm``, e.g. a request's KV-cache footprint).  Each part may
declare an absolute memory budget (``capacities``); coarsening aggregates both
dimensions, the initial growth and every FM move reject placements that would
breach a part's budget, and a greedy repair pass evacuates over-budget parts
when a warm start arrives infeasible.  The work dimension stays *balanced to
targets*; the memory dimension is a *hard cap* — the discrete-memory reality
("a distributed system within a computer") a serving system dies on first.

The partitioner consumes a generic undirected weighted graph; `weight_graph_of`
adapts a :class:`TaskGraph` using the paper's conventions:

* node weight = kernel time on a *chosen* class (`weight_source`).  The paper
  (§III.B) discusses choosing GPU time (small node weights -> edge weights
  dominate -> fewer cuts) vs CPU time (opposite); we expose exactly that knob.
* node memory = ``Kernel.mem_bytes`` (the resident footprint);
* edge weight = transfer time of the producer block over the bus (ms), merged
  for parallel edges.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

from .graph import TaskGraph


# ---------------------------------------------------------------------------
# plain array graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UGraph:
    """Undirected weighted graph in index space.

    ``nw`` is the balance dimension (compute ms); ``nm`` is the optional
    second constraint dimension (resident memory bytes) — ``None`` means the
    graph has no memory dimension and capacity vectors are ignored.
    """

    nw: list[float]  # node weights (compute)
    adj: list[dict[int, float]]  # adj[u][v] = edge weight (sym)
    nm: list[float] | None = None  # node memory (bytes), optional

    @property
    def n(self) -> int:
        return len(self.nw)

    def total_w(self) -> float:
        return sum(self.nw)

    def mem(self, u: int) -> float:
        return self.nm[u] if self.nm is not None else 0.0

    def total_m(self) -> float:
        return sum(self.nm) if self.nm is not None else 0.0

    def part_mem(self, part: list[int], k: int) -> list[float]:
        pm = [0.0] * k
        if self.nm is not None:
            for u in range(self.n):
                pm[part[u]] += self.nm[u]
        return pm

    def edge_cut(
        self, part: list[int], link_scale: Sequence[Sequence[float]] | None = None
    ) -> float:
        """Total cut weight; with ``link_scale`` each cut edge is priced at
        the relative cost of the link between its endpoints' parts (entry
        (p, q) of the matrix, diagonal 0) — the topology-aware objective."""
        cut = 0.0
        for u in range(self.n):
            pu = part[u]
            for v, w in self.adj[u].items():
                if v > u and part[v] != pu:
                    cut += w if link_scale is None else w * link_scale[pu][part[v]]
        return cut


def _lcg(seed: int):
    s = [(seed * 2862933555777941757 + 3037000493) % 2**64 or 1]

    def rnd(n: int) -> int:
        s[0] = (s[0] * 2862933555777941757 + 3037000493) % 2**64
        return (s[0] >> 33) % n

    return rnd


def _caps_active(g: UGraph, caps: Sequence[float] | None) -> bool:
    return caps is not None and g.nm is not None and any(c != math.inf for c in caps)


# ---------------------------------------------------------------------------
# coarsening: heavy-edge matching
# ---------------------------------------------------------------------------


def _coarsen(g: UGraph, rnd) -> tuple[UGraph, list[int]]:
    """One level of heavy-edge matching.  Returns (coarse graph, mapping).

    Both weight dimensions aggregate: a coarse node's compute weight and
    memory footprint are the sums over its matched pair.
    """
    n = g.n
    order = list(range(n))
    for i in range(n - 1, 0, -1):  # Fisher-Yates with our LCG
        j = rnd(i + 1)
        order[i], order[j] = order[j], order[i]
    match = [-1] * n
    for u in order:
        if match[u] != -1:
            continue
        best, bw = -1, -1.0
        for v, w in g.adj[u].items():
            if match[v] == -1 and v != u and w > bw:
                best, bw = v, w
        if best != -1:
            match[u], match[best] = best, u
        else:
            match[u] = u
    cmap = [-1] * n
    nc = 0
    for u in range(n):
        if cmap[u] == -1:
            cmap[u] = nc
            if match[u] != u:
                cmap[match[u]] = nc
            nc += 1
    nw = [0.0] * nc
    nm = [0.0] * nc if g.nm is not None else None
    adj: list[dict[int, float]] = [dict() for _ in range(nc)]
    for u in range(n):
        cu = cmap[u]
        nw[cu] += g.nw[u]
        if nm is not None:
            nm[cu] += g.nm[u]
        for v, w in g.adj[u].items():
            cv = cmap[v]
            if cu != cv:
                adj[cu][cv] = adj[cu].get(cv, 0.0) + w
    # each undirected edge visited twice above -> halve
    for u in range(nc):
        for v in list(adj[u]):
            adj[u][v] *= 0.5
    return UGraph(nw, adj, nm), cmap


# ---------------------------------------------------------------------------
# initial bisection: greedy graph growing
# ---------------------------------------------------------------------------


def _grow_bisection(
    g: UGraph,
    t0: float,
    rnd,
    trials: int = 8,
    caps: Sequence[float] | None = None,
) -> list[int]:
    """Grow partition 0 from a random seed until its weight reaches t0*total.

    With ``caps``, a node never joins partition 0 past its memory budget
    (partition 1's budget is restored afterwards by the repair pass)."""
    total = g.total_w()
    cap0 = caps[0] if _caps_active(g, caps) else math.inf
    best_part, best_cut = None, math.inf
    for _ in range(max(1, trials)):
        start = rnd(g.n)
        part = [1] * g.n
        w0 = 0.0
        m0 = 0.0
        # frontier with gains: prefer nodes most connected into partition 0
        in0 = [False] * g.n
        gain = {start: 0.0}
        skipped: set[int] = set()
        while w0 < t0 * total:
            if not gain:
                # disconnected graph (e.g. independent request chains):
                # re-seed the growth from an unassigned node
                rest = [u for u in range(g.n) if not in0[u] and u not in skipped]
                if not rest:
                    break
                gain = {rest[rnd(len(rest))]: 0.0}
            u = max(gain, key=lambda x: (gain[x], -x))
            del gain[u]
            if in0[u]:
                continue
            if m0 + g.mem(u) > cap0 + 1e-9:
                # memory budget of partition 0 exhausted for this node
                skipped.add(u)
                continue
            if w0 + g.nw[u] > t0 * total * 1.25 and w0 > 0:
                # adding u overshoots badly; try another frontier node
                skipped.add(u)
                continue
            in0[u] = True
            part[u] = 0
            w0 += g.nw[u]
            m0 += g.mem(u)
            for v, w in g.adj[u].items():
                if not in0[v]:
                    gain[v] = gain.get(v, 0.0) + w
        cut = g.edge_cut(part)
        if cut < best_cut:
            best_cut, best_part = cut, part
    assert best_part is not None
    return best_part


# ---------------------------------------------------------------------------
# capacity repair (memory dimension)
# ---------------------------------------------------------------------------


def _repair_capacity(
    g: UGraph,
    part: list[int],
    caps: Sequence[float] | None,
    locked: Sequence[bool] | None = None,
) -> list[int]:
    """Evacuate over-budget parts: greedily move nodes out of any part whose
    resident memory exceeds its capacity, into parts with free budget,
    preferring moves that hurt the edge cut least (then moves that relieve
    the most bytes).  Best-effort: an infeasible instance (total footprint
    above total capacity, or a single node above every free budget) leaves
    the smallest achievable overflow in place."""
    if not _caps_active(g, caps):
        return part
    k = len(caps)
    pm = g.part_mem(part, k)
    for _ in range(2 * g.n):  # each move strictly shrinks an over-budget part
        over = [p for p in range(k) if pm[p] > caps[p] + 1e-6]
        if not over:
            break
        p = max(over, key=lambda q: pm[q] - caps[q])
        best = None
        for u in range(g.n):
            if part[u] != p or g.mem(u) <= 0 or (locked is not None and locked[u]):
                continue
            ext: dict[int, float] = {}
            internal = 0.0
            for v, w in g.adj[u].items():
                if part[v] == p:
                    internal += w
                else:
                    ext[part[v]] = ext.get(part[v], 0.0) + w
            for q in range(k):
                if q == p or pm[q] + g.mem(u) > caps[q] + 1e-6:
                    continue
                cand = (ext.get(q, 0.0) - internal, g.mem(u), -u, q)
                if best is None or cand > best[0]:
                    best = (cand, u, q)
        if best is None:
            break  # stuck: no movable node fits anywhere
        _, u, q = best
        pm[p] -= g.mem(u)
        pm[q] += g.mem(u)
        part[u] = q
    return part


# ---------------------------------------------------------------------------
# FM refinement (2-way and k-way passes)
# ---------------------------------------------------------------------------


def _fm_refine(
    g: UGraph,
    part: list[int],
    targets: Sequence[float],
    epsilon: float,
    max_passes: int = 8,
    locked: Sequence[bool] | None = None,
    mem_caps: Sequence[float] | None = None,
    link_scale: Sequence[Sequence[float]] | None = None,
    objective: str = "cut",
) -> list[int]:
    """Boundary FM with best-prefix rollback, k-way (single-move granularity).

    Balance constraint: partition p weight must stay within
    [targets[p]*total*(1-eps_lo), targets[p]*total*(1+epsilon)] where eps_lo is
    relaxed — we never force moves, only allow those not violating the upper
    bound and not emptying a mandatory partition.

    Capacity constraint: with ``mem_caps``, a move whose destination part
    would exceed its memory budget is rejected outright (gain-ordered moves,
    capacity-vetoed) — the multi-constraint invariant: FM never *creates* a
    capacity violation.

    Link awareness: with ``link_scale`` (k x k relative link costs, diagonal
    0) the gain of a move prices every incident edge at the *actual* link
    between its endpoints' parts, so FM prefers cutting edges across fast
    links (ICI) over slow ones (DCN).  ``None`` keeps the uniform objective
    (all cut edges cost their scalar weight) — exactly the old behaviour.

    ``locked[u]`` pins node u to its current partition (online refinement:
    already-executed or pinned tasks still contribute weight and edge gain but
    may not move).

    ``objective="interval"`` switches the gain from total cut cost to the
    *pipeline interval*: each part's load is its compute weight PLUS every
    incident cut edge's (link-scaled) weight — the time a pipeline stage
    needs per wave when cut traffic does NOT fully hide under its compute —
    and a move's gain is the reduction of the max over parts.  That is the
    stage-balance objective streaming execution wants: the slowest stage
    bounds throughput, so FM should shave the bottleneck stage rather than
    shave total cut bytes.  ``"cut"`` (default) is the classic objective,
    bit-identical to the historical behaviour.
    """
    k = len(targets)
    total = g.total_w()
    pw = [0.0] * k
    for u in range(g.n):
        pw[part[u]] += g.nw[u]
    cap = [targets[p] * total * (1 + epsilon) + 1e-12 for p in range(k)]
    caps_on = _caps_active(g, mem_caps)
    pm = g.part_mem(part, k) if caps_on else None

    def ext_int(u: int) -> tuple[dict[int, float], float]:
        """edge weight from u to each other partition, and internal weight."""
        ext: dict[int, float] = {}
        internal = 0.0
        pu = part[u]
        for v, w in g.adj[u].items():
            pv = part[v]
            if pv == pu:
                internal += w
            else:
                ext[pv] = ext.get(pv, 0.0) + w
        return ext, internal

    def move_gain(ext: dict[int, float], internal: float, pu: int, to: int) -> float:
        """Cut-cost reduction of moving a node from ``pu`` to ``to``."""
        if link_scale is None:
            return ext.get(to, 0.0) - internal
        old = sum(w * link_scale[pu][r] for r, w in ext.items())
        new = internal * link_scale[to][pu]
        for r, w in ext.items():
            if r != to:
                new += w * link_scale[to][r]
        return old - new

    interval = objective == "interval"

    def scale(p: int, q: int) -> float:
        return 1.0 if link_scale is None else link_scale[p][q]

    def interval_loads() -> list[float]:
        """Per-part pipeline interval: compute weight + incident cut cost
        (each cut edge charges BOTH endpoints' stages — both sides hold the
        wire for it)."""
        loads = list(pw)
        for u in range(g.n):
            pu = part[u]
            for v, w in g.adj[u].items():
                pv = part[v]
                if pv != pu:
                    loads[pu] += w * scale(pu, pv)
        return loads

    iload = interval_loads() if interval else None

    def interval_gain(
        u: int, ext: dict[int, float], internal: float, pu: int, to: int
    ) -> tuple[float, dict[int, float]]:
        """(bottleneck reduction, changed per-part loads) for moving ``u``.
        O(k + deg): only pu, to, and u's external neighbor parts change."""
        xcut = internal * scale(to, pu)  # u's old internal edges, now cut
        new = {
            pu: iload[pu]
            - g.nw[u]
            - sum(w * scale(pu, r) for r, w in ext.items())
            + xcut
        }
        reroute = 0.0  # u's edges to third parts now charge `to`, not pu
        for r, w in ext.items():
            if r != to:
                new[r] = iload[r] + w * (scale(to, r) - scale(pu, r))
                reroute += w * scale(to, r)
        new[to] = (
            iload[to]
            + g.nw[u]
            - ext.get(to, 0.0) * scale(pu, to)
            + xcut
            + reroute
        )
        before = max(iload)
        after = max(new.get(p, iload[p]) for p in range(k))
        return before - after, new

    for _ in range(max_passes):
        moved = list(locked) if locked is not None else [False] * g.n
        moves: list[tuple[int, int, int]] = []  # (node, from, to)
        gains_cum: list[float] = []
        cum = 0.0
        improved_in_pass = False
        # iterate: repeatedly pick best feasible boundary move
        for _step in range(g.n):
            best = None  # (gain, u, to)
            for u in range(g.n):
                if moved[u]:
                    continue
                ext, internal = ext_int(u)
                if not ext:
                    continue
                pu = part[u]
                for to in ext:
                    if pw[to] + g.nw[u] > cap[to]:
                        continue
                    if caps_on and pm[to] + g.mem(u) > mem_caps[to] + 1e-6:
                        continue
                    # don't empty a partition that has a nonzero target
                    if targets[pu] > 0 and pw[pu] - g.nw[u] < 0:
                        continue
                    if interval:
                        gain, _ = interval_gain(u, ext, internal, pu, to)
                    else:
                        gain = move_gain(ext, internal, pu, to)
                    # tie-break toward balance deficit
                    deficit = targets[to] * total - pw[to]
                    cand = (gain, deficit, -u)
                    if best is None or cand > best[0]:
                        best = (cand, u, to)
            if best is None:
                break
            (gain, _, _), u, to = best
            frm = part[u]
            if interval:  # apply the changed stage loads before part mutates
                ext, internal = ext_int(u)
                _, changed = interval_gain(u, ext, internal, frm, to)
                for p, val in changed.items():
                    iload[p] = val
            part[u] = to
            pw[frm] -= g.nw[u]
            pw[to] += g.nw[u]
            if caps_on:
                pm[frm] -= g.mem(u)
                pm[to] += g.mem(u)
            moved[u] = True
            cum += gain
            moves.append((u, frm, to))
            gains_cum.append(cum)
            if gain > 0:
                improved_in_pass = True
            if len(moves) >= max(32, g.n // 2):
                break
        if not moves:
            break
        # rollback to best prefix
        best_i = max(range(len(gains_cum)), key=lambda i: gains_cum[i])
        if gains_cum[best_i] <= 1e-12:
            best_i = -1  # no net improvement: undo everything
        for i in range(len(moves) - 1, best_i, -1):
            u, frm, to = moves[i]
            part[u] = frm
            pw[to] -= g.nw[u]
            pw[frm] += g.nw[u]
            if caps_on:
                pm[to] -= g.mem(u)
                pm[frm] += g.mem(u)
        if interval and best_i < len(moves) - 1:
            iload = interval_loads()  # incremental loads predate the rollback
        if best_i == -1 or not improved_in_pass:
            break
    return part


# ---------------------------------------------------------------------------
# multilevel driver
# ---------------------------------------------------------------------------


def _bisect_multilevel(
    g: UGraph,
    t0: float,
    epsilon: float,
    seed: int,
    caps: Sequence[float] | None = None,
) -> list[int]:
    rnd = _lcg(seed)
    levels: list[tuple[UGraph, list[int]]] = []
    cur = g
    while cur.n > 48:
        coarse, cmap = _coarsen(cur, rnd)
        if coarse.n >= cur.n * 0.95:  # matching stalled
            break
        levels.append((cur, cmap))
        cur = coarse
    part = _grow_bisection(cur, t0, rnd, caps=caps)
    part = _repair_capacity(cur, part, caps)
    part = _fm_refine(cur, part, [t0, 1 - t0], epsilon, mem_caps=caps)
    while levels:
        fine, cmap = levels.pop()
        part = [part[cmap[u]] for u in range(fine.n)]
        # projection preserves both weight dimensions, so a feasible coarse
        # partition projects to a feasible fine one; FM keeps it that way
        part = _fm_refine(fine, part, [t0, 1 - t0], epsilon, mem_caps=caps)
    return part


def _group_classes(
    targets: Sequence[float],
    link_scale: Sequence[Sequence[float]] | None,
) -> tuple[list[int], list[int], float, float]:
    """Split class indices into two recursive-bisection sides.

    Without ``link_scale``: the classic greedy halving on sorted targets
    (bit-identical to the historical behaviour).  With it: exhaustively score
    every split by (target-sum imbalance, intra-group link cost) — keeping
    cheaply-linked classes (one pod's racks) on the same side, so the
    expensive tier is crossed only by the first bisection's cut, whose
    volume FM minimizes, while sub-splits cut across cheap links.  The
    exhaustive scan is capped at 12 classes (2^k splits); beyond that the
    legacy greedy halving applies and link awareness is left to the FM
    passes — fleets with more classes than that should coarsen classes
    before partitioning."""
    k = len(targets)
    if link_scale is not None and 2 < k <= 12:
        best = None
        for mask in range(1, 2 ** (k - 1)):  # class k-1 pinned to side B
            sa = [i for i in range(k) if mask >> i & 1]
            sb = [i for i in range(k) if not mask >> i & 1]
            wa = sum(targets[i] for i in sa)
            intra = sum(
                link_scale[i][j]
                for side in (sa, sb)
                for i in side
                for j in side
                if i < j
            )
            cand = (round(abs(2 * wa - 1), 9), intra, mask)
            if best is None or cand < best[0]:
                best = (cand, sa, sb, wa)
        _, sa, sb, wa = best
        return sa, sb, wa, 1.0 - wa
    order = sorted(range(k), key=lambda i: -targets[i])
    ga, gb, wa, wb = [], [], 0.0, 0.0
    for i in order:
        if wa <= wb:
            ga.append(i)
            wa += targets[i]
        else:
            gb.append(i)
            wb += targets[i]
    return ga, gb, wa, wb


def partition_indices(
    g: UGraph,
    targets: Sequence[float],
    *,
    epsilon: float = 0.05,
    seed: int = 1,
    capacities: Sequence[float] | None = None,
    link_scale: Sequence[Sequence[float]] | None = None,
    objective: str = "cut",
) -> list[int]:
    """k-way partition of an index graph into parts with target weight
    fractions ``targets`` (sum to 1) and optional absolute memory budgets
    ``capacities`` (same units as ``g.nm``; ``math.inf`` = unconstrained).

    The capacity vector is a hard constraint: whenever a feasible assignment
    is reachable by the greedy repair + capacity-vetoed FM moves, no part
    exceeds its budget in the returned partition.

    ``link_scale`` (k x k relative link costs between the parts' memory
    nodes, diagonal 0) makes the refinement passes topology-aware: a cut
    edge across a fast link costs less than one across a slow link.  With
    two parts the scale is a constant factor, so it only changes results
    for k >= 3 (distinct link tiers).

    ``objective="interval"`` refines for the streaming pipeline interval
    (max over parts of compute + incident cut cost) instead of total cut —
    the coarse multilevel bisections stay cut-based (interval is a
    refinement objective; cut is the right coarse proxy), the FM polish
    passes optimize the bottleneck stage."""
    k = len(targets)
    tsum = sum(targets)
    if not math.isclose(tsum, 1.0, rel_tol=1e-6):
        targets = [t / tsum for t in targets]
    if capacities is not None and len(capacities) != k:
        raise ValueError(f"capacities has {len(capacities)} entries for {k} targets")
    if link_scale is not None and len(link_scale) != k:
        raise ValueError(f"link_scale has {len(link_scale)} rows for {k} targets")
    if k == 1:
        return [0] * g.n
    # Degenerate targets (paper Fig 6: R_cpu ~ 0): assign everything to the
    # dominant side directly — unless budgets force spreading the footprint.
    live = [i for i, t in enumerate(targets) if t > 1e-9]
    if len(live) == 1:
        part = [live[0]] * g.n
        return _repair_capacity(g, part, capacities)

    if k == 2:
        part = _bisect_multilevel(g, targets[0], epsilon, seed, caps=capacities)
        part = _repair_capacity(g, part, capacities)
        return _fm_refine(
            g,
            part,
            targets,
            epsilon,
            mem_caps=capacities,
            link_scale=link_scale,
            objective=objective,
        )

    # recursive bisection: split the class list into two halves with closest
    # target sums.  With ``link_scale`` the grouping is topology-aware: among
    # the best-balanced splits, pick the one with the least INTRA-group link
    # cost (cheaply-linked classes stay on one side — on a rack/pod
    # hierarchy, each pod's classes together), so the expensive tier is
    # crossed only between the two sides, by the one cut whose volume the
    # first bisection's FM minimizes, and sub-splits cut across cheap links.
    ga, gb, wa, wb = _group_classes(targets, link_scale)
    caps2 = None
    if capacities is not None:
        caps2 = [
            sum(capacities[i] for i in ga),
            sum(capacities[i] for i in gb),
        ]
    part2 = _bisect_multilevel(g, wa, epsilon, seed, caps=caps2)
    part2 = _repair_capacity(g, part2, caps2)
    part2 = _fm_refine(g, part2, [wa, wb], epsilon, mem_caps=caps2)
    out = [-1] * g.n
    for side, group, wsum in ((0, ga, wa), (1, gb, wb)):
        idx = [u for u in range(g.n) if part2[u] == side]
        if not idx:
            continue
        sub_nw = [g.nw[u] for u in idx]
        sub_nm = [g.nm[u] for u in idx] if g.nm is not None else None
        remap = {u: i for i, u in enumerate(idx)}
        sub_adj: list[dict[int, float]] = [dict() for _ in idx]
        for u in idx:
            for v, w in g.adj[u].items():
                if v in remap:
                    sub_adj[remap[u]][remap[v]] = w
        sub = UGraph(sub_nw, sub_adj, sub_nm)
        sub_targets = [targets[i] / wsum for i in group]
        sub_caps = [capacities[i] for i in group] if capacities else None
        sub_scale = None
        if link_scale is not None:
            sub_scale = [[link_scale[i][j] for j in group] for i in group]
        sub_part = partition_indices(
            sub,
            sub_targets,
            epsilon=epsilon,
            seed=seed + 17,
            capacities=sub_caps,
            link_scale=sub_scale,
            objective=objective,
        )
        for u in idx:
            out[u] = group[sub_part[remap[u]]]
    # final k-way polish; repair first so FM starts feasible
    out = _repair_capacity(g, out, capacities)
    return _fm_refine(
        g,
        out,
        targets,
        epsilon,
        mem_caps=capacities,
        link_scale=link_scale,
        objective=objective,
    )


# ---------------------------------------------------------------------------
# TaskGraph adapter (paper semantics)
# ---------------------------------------------------------------------------


def node_weight(
    costs: Mapping[str, float],
    weight_source: str | Callable[[Mapping[str, float]], float],
) -> float:
    """The paper's §III.B node-weight choice: which class's time becomes the
    scalar node weight ("gpu"/"cpu"/any class name, "min", "mean", or a
    callable over the per-class cost dict).  Floored at 1e-9 so zero-cost
    kernels stay movable."""
    if callable(weight_source):
        w = weight_source(costs)
    elif weight_source == "min":
        w = min(costs.values()) if costs else 0.0
    elif weight_source == "mean":
        w = sum(costs.values()) / len(costs) if costs else 0.0
    else:
        w = costs.get(weight_source, min(costs.values()) if costs else 0.0)
    return max(w, 1e-9)


def weight_graph_of(
    tg: TaskGraph,
    *,
    weight_source: str | Callable[[Mapping[str, float]], float] = "gpu",
    edge_ms: Callable[[int], float] | None = None,
) -> tuple[UGraph, list[str]]:
    """Build the undirected weighted graph the partitioner consumes.

    ``weight_source``: which class's time becomes the compute node weight —
    the paper's §III.B discussion.  "gpu"/"cpu"/any class name, "min", "mean",
    or a callable over the per-class cost dict.
    ``edge_ms``: bytes -> transfer ms; defaults to identity on bytes (pure cut
    minimization in byte space).

    The memory dimension rides along: ``UGraph.nm`` carries each kernel's
    ``mem_bytes`` (``None`` when the graph declares no footprints, keeping
    scalar-weight behaviour bit-identical)."""
    names = list(tg.topo_order())
    index = {n: i for i, n in enumerate(names)}
    nw = [node_weight(tg.nodes[n].costs, weight_source) for n in names]
    nm: list[float] | None = [float(tg.nodes[n].mem_bytes) for n in names]
    if not any(nm):
        nm = None
    adj: list[dict[int, float]] = [dict() for _ in names]
    for e in tg.edges:
        u, v = index[e.src], index[e.dst]
        w = edge_ms(e.nbytes) if edge_ms else float(e.nbytes)
        w = max(w, 1e-9)
        adj[u][v] = adj[u].get(v, 0.0) + w
        adj[v][u] = adj[v].get(u, 0.0) + w
    return UGraph(nw, adj, nm), names


def partition_taskgraph(
    tg: TaskGraph,
    targets: Mapping[str, float],
    *,
    weight_source: str = "gpu",
    edge_ms: Callable[[int], float] | None = None,
    epsilon: float = 0.05,
    seed: int = 1,
    pin: Mapping[str, str] | None = None,
    capacities: Mapping[str, float] | None = None,
    link_scale: Sequence[Sequence[float]] | None = None,
    objective: str = "cut",
) -> dict[str, str]:
    """Partition a TaskGraph into processor classes with target work fractions
    (the paper's full gp pipeline minus the runtime).

    Returns kernel name -> class name.  ``pin`` forces given kernels onto a
    class (e.g. the virtual source onto the host); pins are applied after
    partitioning by overriding the assignment (their weight contribution is
    negligible for the source node, which has zero cost).  ``capacities``
    maps a class to its memory budget in bytes (absent class = unconstrained).
    ``link_scale`` (indexed like ``list(targets)``) prices cut edges at the
    relative cost of the link between the two classes' memory nodes — build
    it with :func:`repro_torch.core.comm.link_scale_for`.
    """
    classes = list(targets)
    ug, names = weight_graph_of(tg, weight_source=weight_source, edge_ms=edge_ms)
    caps = None
    if capacities is not None:
        caps = [float(capacities.get(c, math.inf)) for c in classes]
    part = partition_indices(
        ug,
        [targets[c] for c in classes],
        epsilon=epsilon,
        seed=seed,
        capacities=caps,
        link_scale=link_scale,
        objective=objective,
    )
    out = {names[i]: classes[part[i]] for i in range(len(names))}
    if pin:
        out.update(pin)
    return out


def cut_stats(
    tg: TaskGraph,
    assignment: Mapping[str, str],
    edge_ms: Callable[[int], float] | None = None,
    link_ms: Callable[[str, str, int], float] | None = None,
) -> dict:
    """Cut edges / bytes / ms plus per-class node-weight and footprint sums.

    ``edge_ms`` prices every cut edge with one flat bytes->ms function;
    ``link_ms(src_cls, dst_cls, nbytes)`` prices it at the actual link
    between the assigned classes (topology-exact reporting) and wins when
    both are given."""
    cut_edges = 0
    cut_bytes = 0
    cut_ms = 0.0
    for e in tg.edges:
        ca, cb = assignment[e.src], assignment[e.dst]
        if ca != cb:
            cut_edges += 1
            cut_bytes += e.nbytes
            if link_ms is not None:
                cut_ms += link_ms(ca, cb, e.nbytes)
            elif edge_ms is not None:
                cut_ms += edge_ms(e.nbytes)
    loads: dict[str, float] = {}
    mem: dict[str, int] = {}
    for n, k in tg.nodes.items():
        c = assignment[n]
        loads[c] = loads.get(c, 0.0) + (k.costs.get(c, 0.0))
        mem[c] = mem.get(c, 0) + k.mem_bytes
    return {
        "cut_edges": cut_edges,
        "cut_bytes": cut_bytes,
        "cut_ms": cut_ms,
        "loads_ms": loads,
        "mem_bytes": mem,
    }
