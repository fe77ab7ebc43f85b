"""Pipeline-stage assignment by graph partitioning — the paper's technique
applied to the layer graph of any ``--arch``.

The layer graph of a transformer is a chain (enc-dec: two chains + cross
edges): node weight = per-layer step time from the analytic roofline model,
edge weight = activation bytes crossing the stage boundary.  Partitioning
into ``n_stages`` with equal targets = pipeline stage assignment; the edge
cut = inter-stage (pod-crossing) activation traffic.

Two partitioners:
* ``fm_stages``        — the paper-faithful multilevel FM partitioner
  (general graphs; may produce non-contiguous stages, which a pipeline
  cannot execute without extra transfers — reported as a metric);
* ``dp_stages``        — beyond-paper: optimal *contiguous* chain split by
  DP (minimize max stage weight), the constraint the generic partitioner
  cannot express.

``benchmarks/pipeline_partition_bench.py`` compares both + uniform split.

Node weights divide each layer's FLOPs by ``peak_flops``, by default
:data:`PEAK_FLOPS_BF16`, one NVIDIA H100 SXM's dense bf16 tensor-core peak.
The rate scales every weight alike, but the planners round and break ties
on the absolute weights, so a plan can change with it: a caller that plans
for another device passes that device's peak.
"""

from __future__ import annotations

import dataclasses

from .graph import TaskGraph
from .partition import partition_taskgraph
from ..configs.base import ModelConfig

# NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, no sparsity,
# at the full 700 W power limit
PEAK_FLOPS_BF16 = 989e12


def layer_flops(cfg: ModelConfig, layer_idx: int, batch: int,
                seq: int) -> float:
    """Analytic per-layer forward FLOPs (per step, whole batch)."""
    spec = cfg.layer_specs()[layer_idx]
    d = cfg.d_model
    T = batch * seq
    f = 0.0
    if spec.mixer == "attn":
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        f += 2 * T * d * (H + 2 * K) * hd + 2 * T * H * hd * d
        f += 4 * T * seq * H * hd * 0.5          # causal attention
    elif spec.mixer == "mla":
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        H = cfg.n_heads
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        f += 2 * T * (d * r_q + r_q * H * (dn + dr) + d * (r_kv + dr)
                      + r_kv * H * (dn + dv) + H * dv * d)
        f += 4 * T * seq * H * (dn + dr) * 0.5
    elif spec.mixer == "mamba":
        di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
        f += 2 * T * d * 2 * di + 2 * T * di * d + 10 * T * di * ds
    elif spec.mixer == "rwkv6":
        A = cfg.rwkv_n_heads * cfg.rwkv_head_size
        f += 2 * T * d * 4 * A + 2 * T * A * d + 8 * T * A * cfg.rwkv_head_size
    if spec.ffn == "dense":
        f += 6 * T * d * cfg.d_ff
    else:
        f += 6 * T * d * cfg.moe_d_ff * cfg.top_k
        if cfg.n_shared_experts:
            f += 6 * T * d * cfg.moe_d_ff * cfg.n_shared_experts
    return f


def layer_graph(cfg: ModelConfig, *, batch: int, seq: int,
                act_bytes: int = 2, peak_flops: float = PEAK_FLOPS_BF16) -> TaskGraph:
    """Chain task-graph of the arch's layers, roofline-weighted at
    ``peak_flops`` FLOP/s."""
    g = TaskGraph()
    edge_bytes = batch * seq * cfg.d_model * act_bytes
    n = cfg.n_layers
    for i in range(n):
        fl = layer_flops(cfg, i, batch, seq)
        ms = max(fl / peak_flops, 1e-9) * 1e3
        g.add(f"L{i}", op=f"layer.{cfg.layer_specs()[i].mixer}",
              costs={"stage": ms}, out_bytes=edge_bytes)
    for i in range(n - 1):
        g.add_edge(f"L{i}", f"L{i+1}", nbytes=edge_bytes)
    return g


@dataclasses.dataclass
class StagePlan:
    assignment: dict[str, int]          # layer name -> stage
    loads_ms: list[float]
    cut_bytes: int
    contiguous: bool
    bottleneck_ms: float

    @property
    def imbalance(self) -> float:
        lo = sum(self.loads_ms) / len(self.loads_ms)
        return self.bottleneck_ms / lo if lo else 0.0


def _plan_from_assignment(g: TaskGraph, asg: dict[str, int],
                          n_stages: int) -> StagePlan:
    loads = [0.0] * n_stages
    for name, st in asg.items():
        loads[st] += g.nodes[name].costs["stage"]
    cut = sum(e.nbytes for e in g.edges if asg[e.src] != asg[e.dst])
    order = [asg[f"L{i}"] for i in range(g.num_nodes())]
    contiguous = all(order[i] <= order[i + 1] for i in range(len(order) - 1))
    return StagePlan(asg, loads, cut, contiguous, max(loads))


def fm_stages(cfg: ModelConfig, n_stages: int, *, batch: int, seq: int,
              seed: int = 1, peak_flops: float = PEAK_FLOPS_BF16) -> StagePlan:
    """Paper-faithful: multilevel FM with equal stage targets."""
    g = layer_graph(cfg, batch=batch, seq=seq, peak_flops=peak_flops)
    targets = {str(s): 1.0 / n_stages for s in range(n_stages)}
    asg = partition_taskgraph(g, targets, weight_source="stage", seed=seed)
    return _plan_from_assignment(g, {k: int(v) for k, v in asg.items()},
                                 n_stages)


def dp_stages(cfg: ModelConfig, n_stages: int, *, batch: int,
              seq: int, peak_flops: float = PEAK_FLOPS_BF16) -> StagePlan:
    """Optimal contiguous chain split (minimize max stage time) by DP."""
    g = layer_graph(cfg, batch=batch, seq=seq, peak_flops=peak_flops)
    w = [g.nodes[f"L{i}"].costs["stage"] for i in range(g.num_nodes())]
    n = len(w)
    k = n_stages
    prefix = [0.0]
    for x in w:
        prefix.append(prefix[-1] + x)

    # dp[j][i] = min over split of max-load using j stages for first i layers
    INF = float("inf")
    dp = [[INF] * (n + 1) for _ in range(k + 1)]
    cut_at = [[0] * (n + 1) for _ in range(k + 1)]
    dp[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(1, n + 1):
            for m in range(j - 1, i):
                cand = max(dp[j - 1][m], prefix[i] - prefix[m])
                if cand < dp[j][i]:
                    dp[j][i] = cand
                    cut_at[j][i] = m
    # recover
    bounds = [n]
    j, i = k, n
    while j > 0:
        m = cut_at[j][i]
        bounds.append(m)
        i, j = m, j - 1
    bounds = bounds[::-1]
    asg = {}
    for s in range(k):
        for i in range(bounds[s], bounds[s + 1]):
            asg[f"L{i}"] = s
    return _plan_from_assignment(g, asg, k)


def uniform_stages(cfg: ModelConfig, n_stages: int, *, batch: int,
                   seq: int, peak_flops: float = PEAK_FLOPS_BF16) -> StagePlan:
    """Naive equal-layer-count split (the no-analysis baseline)."""
    g = layer_graph(cfg, batch=batch, seq=seq, peak_flops=peak_flops)
    n = g.num_nodes()
    per = -(-n // n_stages)
    asg = {f"L{i}": min(i // per, n_stages - 1) for i in range(n)}
    return _plan_from_assignment(g, asg, n_stages)
