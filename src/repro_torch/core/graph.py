"""Task-graph IR for the data-flow programming model (paper §II/§III).

A :class:`TaskGraph` is a DAG of *kernels* (nodes) connected by *data
dependencies* (edges).  Following the paper:

* every node carries a cost **per processor class** (ms), acquired either by
  offline measurement or an analytic model (``core/cost.py``);
* every edge carries the number of bytes that flow from producer to consumer —
  the edge *weight* is the transfer time of those bytes over the slow bus;
* all initial data lives on the host, expressed (as in the paper, §III.B) by a
  virtual ``source`` node of weight zero with an edge to every entry kernel.

The IR is deliberately framework-free (pure Python + dicts) so the partitioner,
the simulator, and the real JAX executor all consume the same object.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

SOURCE = "__source__"  # virtual host node (paper: "empty kernel whose weight is 0")


@dataclasses.dataclass
class Kernel:
    """One node: an independent computation with per-processor-class costs."""

    name: str
    op: str = "generic"               # kernel type, e.g. "matmul" / "matadd"
    costs: dict[str, float] = dataclasses.field(default_factory=dict)  # class -> ms
    out_bytes: int = 0                # size of the (single) output block
    mem_bytes: int = 0                # resident footprint while the kernel's
    #                                   output lives on a memory node (KV state)
    meta: dict = dataclasses.field(default_factory=dict)
    fn: Callable | None = None        # optional real implementation (executor)

    def cost_on(self, proc_class: str) -> float:
        if proc_class not in self.costs:
            raise KeyError(f"kernel {self.name!r} has no cost for class {proc_class!r}")
        return self.costs[proc_class]


@dataclasses.dataclass(frozen=True)
class Edge:
    src: str
    dst: str
    nbytes: int = 0
    blocks: int = 1  # data blocks this dependency carries (cost models resolve
    #                  nbytes = blocks * block_size when nbytes is left 0)


class TaskGraph:
    """Directed acyclic graph of kernels; insertion-ordered, validated."""

    def __init__(self) -> None:
        self.nodes: dict[str, Kernel] = {}
        self._succ: dict[str, list[str]] = {}
        self._pred: dict[str, list[str]] = {}
        self._edges: dict[tuple[str, str], Edge] = {}

    # -- construction -------------------------------------------------------
    def add_kernel(self, kernel: Kernel) -> Kernel:
        if kernel.name in self.nodes:
            raise ValueError(f"duplicate kernel {kernel.name!r}")
        self.nodes[kernel.name] = kernel
        self._succ[kernel.name] = []
        self._pred[kernel.name] = []
        return kernel

    def add(self, name: str, **kw) -> Kernel:
        return self.add_kernel(Kernel(name=name, **kw))

    def add_edge(self, src: str, dst: str, nbytes: int = 0, blocks: int = 1) -> Edge:
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError(f"edge {src}->{dst} references unknown kernel")
        if (src, dst) in self._edges:
            raise ValueError(f"duplicate edge {src}->{dst}")
        e = Edge(src, dst, nbytes, blocks)
        self._edges[(src, dst)] = e
        self._succ[src].append(dst)
        self._pred[dst].append(src)
        return e

    def remove_kernel(self, name: str) -> Kernel:
        """Remove a kernel and all incident edges (online task retirement)."""
        if name not in self.nodes:
            raise KeyError(f"unknown kernel {name!r}")
        k = self.nodes.pop(name)
        for s in self._succ.pop(name):
            self._pred[s].remove(name)
            del self._edges[(name, s)]
        for p in self._pred.pop(name):
            self._succ[p].remove(name)
            del self._edges[(p, name)]
        return k

    # -- queries -------------------------------------------------------------
    def successors(self, name: str) -> list[str]:
        return self._succ[name]

    def predecessors(self, name: str) -> list[str]:
        return self._pred[name]

    def edge(self, src: str, dst: str) -> Edge:
        return self._edges[(src, dst)]

    @property
    def edges(self) -> list[Edge]:
        return list(self._edges.values())

    def num_nodes(self) -> int:
        return len(self.nodes)

    def num_edges(self) -> int:
        return len(self._edges)

    def entry_nodes(self) -> list[str]:
        return [n for n, p in self._pred.items() if not p]

    def exit_nodes(self) -> list[str]:
        return [n for n, s in self._succ.items() if not s]

    def topo_order(self) -> list[str]:
        """Kahn's algorithm; raises on cycles."""
        indeg = {n: len(p) for n, p in self._pred.items()}
        ready = [n for n, d in indeg.items() if d == 0]
        order: list[str] = []
        while ready:
            n = ready.pop()
            order.append(n)
            for s in self._succ[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(order) != len(self.nodes):
            raise ValueError("task graph contains a cycle")
        return order

    def validate(self) -> None:
        self.topo_order()

    # -- analysis helpers ----------------------------------------------------
    def critical_path_ms(self, proc_class_best: Callable[[Kernel], float]) -> float:
        """Longest path through the DAG using ``proc_class_best(kernel)`` node
        costs and zero edge costs (a lower bound on any makespan)."""
        dist: dict[str, float] = {}
        for n in self.topo_order():
            base = max((dist[p] for p in self._pred[n]), default=0.0)
            dist[n] = base + proc_class_best(self.nodes[n])
        return max(dist.values(), default=0.0)

    def total_work_ms(self, proc_class_best: Callable[[Kernel], float]) -> float:
        return sum(proc_class_best(k) for k in self.nodes.values())

    def total_mem_bytes(self) -> int:
        """Aggregate resident footprint of the whole graph (the second balance
        dimension: every kernel's live output simultaneously resident)."""
        return sum(k.mem_bytes for k in self.nodes.values())

    def mem_bytes_by(self, group_of: Callable[[str], str]) -> dict[str, int]:
        """Footprint aggregated by an arbitrary grouping of kernels (e.g. an
        assignment's class, or a request id from ``meta``)."""
        out: dict[str, int] = {}
        for n, k in self.nodes.items():
            g = group_of(n)
            out[g] = out.get(g, 0) + k.mem_bytes
        return out

    def fingerprint(self) -> str:
        h = hashlib.sha256()
        for n in sorted(self.nodes):
            k = self.nodes[n]
            h.update(f"{n}|{k.op}|{sorted(k.costs.items())}|{k.out_bytes}"
                     f"|{k.mem_bytes}".encode())
        for (s, d), e in sorted(self._edges.items()):
            h.update(f"{s}->{d}|{e.nbytes}".encode())
        return h.hexdigest()[:16]

    def copy(self) -> "TaskGraph":
        g = TaskGraph()
        for k in self.nodes.values():
            g.add_kernel(dataclasses.replace(k, costs=dict(k.costs), meta=dict(k.meta)))
        for e in self.edges:
            g.add_edge(e.src, e.dst, e.nbytes, e.blocks)
        return g


# ---------------------------------------------------------------------------
# DAG generator (paper §IV.A: "We implemented a DAG generator to generate the
# structure for test tasks ... 38 kernels and 75 data dependencies; all kernels
# are of the same type of matrix computation which has two inputs and one
# output.")
#
# Structural note: with strictly two-input kernels, 38 kernels admit at most
# 74 kernel->kernel dependencies, so 75 dependencies necessarily include the
# arrows from the paper's virtual "empty kernel" (§III.B: "all initial kernels
# have data dependencies pointing from an empty kernel whose weight is set to
# zero").  The unique arrow budget is: source->k0, source->k1, k0->k1, and two
# parents for each of k2..k37 => 2 + 1 + 72 = 75.  We generate exactly that.
# ---------------------------------------------------------------------------

def _make_lcg(seed: int):
    state = [(seed * 6364136223846793005 + 1442695040888963407) % 2**64 or 1]

    def rnd(n: int) -> int:  # LCG — reproducible, no global RNG state
        state[0] = (state[0] * 6364136223846793005 + 1442695040888963407) % 2**64
        return (state[0] >> 33) % n

    return rnd


def generate_dag(
    n_kernels: int,
    *,
    op: str = "matmul",
    out_bytes: int = 0,
    seed: int = 0,
    fan_in: int = 2,
    recency: int = 6,
    include_source: bool = True,
) -> TaskGraph:
    """Random DAG of two-input/one-output kernels (paper's generator shape).

    Every kernel has exactly ``fan_in`` inputs, drawn from earlier kernels
    (one parent biased to the last ``recency`` kernels — controls depth vs
    width) or, when too few kernels exist yet, from the virtual host source.
    Deterministic in ``seed``.
    """
    rnd = _make_lcg(seed)
    g = TaskGraph()
    names = [f"k{i}" for i in range(n_kernels)]
    for nm in names:
        g.add(nm, op=op, out_bytes=out_bytes)
    if include_source:
        g.add_kernel(Kernel(name=SOURCE, op="source", costs={}))

    for i, nm in enumerate(names):
        parents: list[str] = []
        host_blocks = 0
        # parent 1: recency-biased (graph depth), parent 2: uniform (fan-out)
        for which in range(fan_in):
            pool_lo = max(0, i - recency) if which == 0 else 0
            cand = None
            for _ in range(8):  # rejection-sample a distinct parent
                if i == 0:
                    break
                j = pool_lo + rnd(i - pool_lo)
                if names[j] not in parents:
                    cand = names[j]
                    break
            if cand is None:
                # no distinct kernel parent available: this input is initial
                # host data (an arrow from the zero-weight source kernel)
                host_blocks += 1
                continue
            parents.append(cand)
        for p in parents:
            g.add_edge(p, nm, blocks=1)
        if include_source and host_blocks:
            g.add_edge(SOURCE, nm, blocks=host_blocks)
    g.validate()
    return g


def generate_paper_dag(op: str = "matmul", out_bytes: int = 0, seed: int = 7) -> TaskGraph:
    """The paper's test task: 38 kernels, 75 data dependencies (incl. the
    arrows from the zero-weight source kernel), two inputs / one output each
    (§IV.A, §III.B)."""
    g = generate_dag(38, op=op, out_bytes=out_bytes, seed=seed, fan_in=2,
                     recency=6, include_source=True)
    assert g.num_nodes() == 39 and g.num_edges() == 75, (
        g.num_nodes(), g.num_edges())
    return g


def resolve_edge_bytes(g: TaskGraph) -> None:
    """Fill in ``nbytes`` for edges left at 0: ``blocks`` x the producer's
    block size (source edges use the consumer's block size — initial inputs
    are matrices of the consumer's shape).  Mutates ``g`` in place."""
    import dataclasses as _dc
    for e in list(g.edges):
        if e.nbytes:
            continue
        if g.nodes[e.src].op == "source":
            base = g.nodes[e.dst].out_bytes
        else:
            base = g.nodes[e.src].out_bytes
        g._edges[(e.src, e.dst)] = _dc.replace(e, nbytes=e.blocks * base)
