"""DOT graph-description interface (paper §III.A: DOT is the user-facing way to
express data dependencies; also used to visualize original + partitioned DAGs).

We support the subset the paper uses: ``digraph name { a -> b; ... }`` with
optional ``[weight=..., nbytes=...]`` edge attributes and
``a [cost_cpu=..., cost_gpu=..., op=...]`` node attributes.  The writer emits
partition results as node colors/cluster subgraphs so both humans and programs
can read them (paper requirement #"easily displayed").
"""

from __future__ import annotations

import re

from .graph import TaskGraph

_NODE_RE = re.compile(r"^\s*\"?([\w./-]+)\"?\s*(?:\[(.*)\])?\s*;?\s*$")
_EDGE_RE = re.compile(r"^\s*\"?([\w./-]+)\"?\s*->\s*\"?([\w./-]+)\"?\s*(?:\[(.*)\])?\s*;?\s*$")
_ATTR_RE = re.compile(r"([\w]+)\s*=\s*\"?([^,\"\]]+)\"?")


def _parse_attrs(text: str | None) -> dict[str, str]:
    if not text:
        return {}
    return {k: v.strip() for k, v in _ATTR_RE.findall(text)}


def parse_dot(text: str) -> TaskGraph:
    """Parse a DOT digraph into a TaskGraph.

    Node attrs: ``op``, ``out_bytes`` and any ``cost_<class>`` (ms).
    Edge attrs: ``nbytes`` (preferred) or ``weight`` (ms — stored in meta).
    Unknown attrs are kept in ``Kernel.meta``.
    """
    g = TaskGraph()
    pending_edges: list[tuple[str, str, dict[str, str]]] = []
    body = text
    m = re.search(r"\{(.*)\}", text, re.S)
    if m:
        body = m.group(1)
    # statements are ';'-separated; attribute lists may contain ';' only in
    # quoted strings, which our subset does not use
    stmts = []
    for raw in body.splitlines():
        stmts.extend(raw.split(";"))
    for raw in stmts:
        line = raw.split("//")[0].strip()
        if not line or line.startswith(("graph", "node", "edge", "#", "label", "rankdir", "subgraph", "}")):
            continue
        em = _EDGE_RE.match(line)
        if em:
            attrs = _parse_attrs(em.group(3))
            pending_edges.append((em.group(1), em.group(2), attrs))
            continue
        nm = _NODE_RE.match(line)
        if nm:
            name = nm.group(1)
            if name in g.nodes:
                continue
            attrs = _parse_attrs(nm.group(2))
            costs = {k[len("cost_"):]: float(v) for k, v in attrs.items() if k.startswith("cost_")}
            meta = {k: v for k, v in attrs.items() if not k.startswith("cost_") and k not in ("op", "out_bytes")}
            g.add(name, op=attrs.get("op", "generic"),
                  costs=costs, out_bytes=int(float(attrs.get("out_bytes", 0))), meta=meta)
    for src, dst, attrs in pending_edges:
        for n in (src, dst):
            if n not in g.nodes:
                g.add(n)
        nbytes = int(float(attrs.get("nbytes", attrs.get("weight", 0))))
        g.add_edge(src, dst, nbytes=nbytes)
    g.validate()
    return g


_PALETTE = ["lightblue", "salmon", "palegreen", "khaki", "plum", "lightgray",
            "orange", "cyan", "pink", "yellowgreen"]


def to_dot(g: TaskGraph, assignment: dict[str, int] | None = None,
           name: str = "taskgraph") -> str:
    """Emit DOT; when ``assignment`` (node -> partition id) is given, color nodes
    by partition and annotate cut edges — the paper's visualization of the
    partition result."""
    lines = [f"digraph {name} {{", "  rankdir=TB;"]
    for n, k in g.nodes.items():
        attrs = [f'op="{k.op}"']
        for c, v in sorted(k.costs.items()):
            attrs.append(f'cost_{c}="{v:.6g}"')
        if k.out_bytes:
            attrs.append(f'out_bytes="{k.out_bytes}"')
        if assignment is not None and n in assignment:
            p = assignment[n]
            attrs += [f'style=filled', f'fillcolor="{_PALETTE[p % len(_PALETTE)]}"',
                      f'partition="{p}"']
        lines.append(f'  "{n}" [{", ".join(attrs)}];')
    for e in g.edges:
        attrs = [f'nbytes="{e.nbytes}"']
        if assignment is not None and assignment.get(e.src) != assignment.get(e.dst):
            attrs += ['color=red', 'penwidth=2']  # cut edge = bus transfer
        lines.append(f'  "{e.src}" -> "{e.dst}" [{", ".join(attrs)}];')
    lines.append("}")
    return "\n".join(lines)


def roundtrip(g: TaskGraph) -> TaskGraph:
    return parse_dot(to_dot(g))
