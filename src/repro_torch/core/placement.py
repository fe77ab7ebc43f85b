"""MoE expert placement by co-activation graph partitioning.

The paper's objective — minimize traffic over the slow link subject to
balanced load — applied to expert parallelism: experts that co-fire on the
same token cost a *duplicate token send* when they live on different EP
shards (the token crosses the all-to-all once per distinct destination
shard).  Partitioning the co-activation graph into ``n_shards`` balanced
groups minimizes exactly those duplicate sends; ``moe.dispatch_bytes``
measures the win and the EP layer applies the permutation
(``expert_perm``) at routing time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .partition import UGraph, partition_indices


@dataclasses.dataclass
class PlacementResult:
    expert_to_shard: np.ndarray      # (E,) shard id per (logical) expert
    perm: np.ndarray                 # (E,) logical expert -> physical slot
    cut_weight: float                # co-activation weight crossing shards
    loads: np.ndarray                # (n_shards,) activation mass


def coactivation_graph(co: np.ndarray, loads: np.ndarray | None = None
                       ) -> UGraph:
    """co: (E, E) symmetric co-activation counts; node weight = expert
    activation mass (diagonal of routing counts) for load balance."""
    E = co.shape[0]
    nw = list((loads if loads is not None else co.sum(1)).astype(float))
    adj = [dict() for _ in range(E)]
    for i in range(E):
        for j in range(E):
            if i != j and co[i, j] > 0:
                adj[i][j] = float(co[i, j])
    return UGraph([max(w, 1e-9) for w in nw], adj)


def place_experts(co: np.ndarray, n_shards: int, *,
                  loads: np.ndarray | None = None, slots_per_shard: int | None
                  = None, epsilon: float = 0.10, seed: int = 1
                  ) -> PlacementResult:
    """Partition experts into ``n_shards`` balanced groups minimizing
    co-activation cut, then lay groups out into contiguous physical slots
    (slot // slots_per_shard == shard), which is what the EP all_to_all
    expects."""
    E = co.shape[0]
    slots = slots_per_shard or -(-E // n_shards)
    g = coactivation_graph(co, loads)
    part = partition_indices(g, [1.0 / n_shards] * n_shards,
                             epsilon=epsilon, seed=seed)
    part = np.array(part)
    # capacity-respecting fixup: shards own at most `slots` experts
    order = np.argsort([-g.nw[i] for i in range(E)])
    counts = np.zeros(n_shards, int)
    final = -np.ones(E, int)
    for i in order:
        s = part[i]
        if counts[s] < slots:
            final[i] = s
            counts[s] += 1
    for i in order:
        if final[i] < 0:
            s = int(np.argmin(counts))
            final[i] = s
            counts[s] += 1
    # physical slots: fill each shard's slot range in expert order
    perm = -np.ones(E, int)
    next_slot = {s: s * slots for s in range(n_shards)}
    for i in range(E):
        s = final[i]
        perm[i] = next_slot[s]
        next_slot[s] += 1
    cut = 0.0
    for i in range(E):
        for j in range(i + 1, E):
            if final[i] != final[j]:
                cut += co[i, j]
    loads_out = np.zeros(n_shards)
    for i in range(E):
        loads_out[final[i]] += g.nw[i]
    return PlacementResult(final, perm, cut, loads_out)


def random_placement(E: int, n_shards: int, seed: int = 0) -> PlacementResult:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(E)
    slots = -(-E // n_shards)
    shard = perm // slots
    return PlacementResult(shard, perm, float("nan"),
                           np.bincount(shard, minlength=n_shards).astype(float))


def synth_coactivation(E: int, k: int, n_tokens: int = 4096, *,
                       n_clusters: int = 4, affinity: float = 0.8,
                       seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic routing trace with clustered expert affinity (tokens pick
    their k experts mostly within one cluster — the structure real MoE
    routers exhibit and the reason partitioned placement wins).
    Returns (co (E,E), idx (n_tokens, k))."""
    rng = np.random.default_rng(seed)
    cluster = rng.integers(0, n_clusters, size=E)
    by_cluster = [np.where(cluster == c)[0] for c in range(n_clusters)]
    idx = np.zeros((n_tokens, k), int)
    for t in range(n_tokens):
        c = rng.integers(n_clusters)
        pool = by_cluster[c]
        for j in range(k):
            if len(pool) and rng.random() < affinity:
                idx[t, j] = rng.choice(pool)
            else:
                idx[t, j] = rng.integers(E)
    co = np.zeros((E, E))
    for t in range(n_tokens):
        u = np.unique(idx[t])
        for a in range(len(u)):
            for b in range(a + 1, len(u)):
                co[u[a], u[b]] += 1
                co[u[b], u[a]] += 1
    return co, idx
