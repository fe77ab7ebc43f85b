"""Collective and memory accounting of a traced step (the port of
``repro/launch/hlo.py``).

The reference reads the partitioned HLO module's text.  The port has no
HLO: each rank runs its own step eagerly, so what it reads is the
:class:`~repro_torch.launch.flops.StepTrace` of that step, the ops the step
dispatched as they ran (loops included as many times as they ran, so
nothing is multiplied by a trip count):

* **collectives**: every ``torch.distributed`` collective the rank issued
  (the ``c10d`` ops: all-reduce, all-gather, reduce-scatter, all-to-all),
  its bytes by the reference's wire model (an all-reduce twice its payload,
  reduce-scatter pass plus all-gather pass; the others their output once;
  the ``(N-1)/N`` factor dropped) and the process group it ran over, which
  names its mesh axis;
* **memory bytes**: every op's inputs plus outputs, unfused (no view
  counted), the twin of the reference's no-reuse walk of the post-fusion
  HLO, which the dry run records as ``bytes_hlo_walk``; the
  fusion-optimistic model it reports as ``bytes_per_device`` is the
  trace's ``mem_bytes``.

All of it is per device: the step traced is one rank's.
"""

from __future__ import annotations

from collections import defaultdict


def axis_of_groups(mesh) -> dict[str, str]:
    """{process-group name: mesh axis} of ``mesh``'s axes above 1."""
    return {mesh.device_mesh.get_group(a).group_name: a
            for a in mesh.axis_names if mesh.shape[a] > 1}


def analyze(trace, mesh=None) -> dict:
    """The reference's record of a step's collectives from its trace: the
    wire bytes of each kind, ``total``, ``count``, ``per_kind_count`` and the
    twelve heaviest ``top_ops`` (identical ops aggregated); with ``mesh``,
    also ``per_axis``, the wire bytes over each mesh axis."""
    axes = axis_of_groups(mesh) if mesh is not None else {}
    coll: dict = defaultdict(int)
    coll_n: dict = defaultdict(int)
    per_axis: dict = defaultdict(int)
    agg: dict = defaultdict(int)
    for c in trace.collectives:
        coll[c.kind] += c.wire_bytes
        coll_n[c.kind] += 1
        axis = axes.get(c.group, c.group)
        if mesh is not None:
            per_axis[axis] += c.wire_bytes
        agg[(f"{c.desc} over {axis}", c.wire_bytes)] += 1
    top = sorted(((op, nb, n, nb * n) for (op, nb), n in agg.items()), key=lambda t: -t[3])[:12]
    out = {
        **{k: int(v) for k, v in coll.items()},
        "total": int(sum(coll.values())),
        "count": int(sum(coll_n.values())),
        "per_kind_count": {k: int(v) for k, v in coll_n.items()},
        "top_ops": [{"op": k, "bytes": int(b), "times": int(n), "total": int(t)}
                    for k, b, n, t in top],
    }
    if mesh is not None:
        out["per_axis"] = {k: int(v) for k, v in per_axis.items()}
    return {"mem_bytes": trace.io_bytes, "collectives": out}

