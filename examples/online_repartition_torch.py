"""Online incremental re-partitioning on the PyTorch port (the twin of
``examples/online_repartition.py``): the paper's GP scheduler kept live
under a churning serving workload.

A heterogeneous two-pod platform serves request chains.  Requests arrive and
retire one at a time; the :class:`repro_torch.core.online.OnlinePartitioner`
maintains the partition with boundary-local FM refinement, only escalating
to a full repartition when local moves cannot restore balance.  Mid-run the
small pod loses a worker class share (targets shift), exercising the elastic
path.  Finally the scheduler arena replays a whole stream through every
policy for comparison (simulated).  The scheduler core is host code:
nothing here touches a device.

Run:  PYTHONPATH=src python examples/online_repartition_torch.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.arena import format_table
from repro_torch.core.graph import Kernel
from repro_torch.core.online import OnlinePartitioner
from repro_torch.launch.serve import run_arena

KV = 16 << 20
COSTS = {"big": 8.0, "small": 24.0}


def fmt(rec):
    return (f"{rec.kind:<11s} imb {rec.imbalance_before:.3f}->"
            f"{rec.imbalance_after:.3f}  cut {rec.cut_before:.1f}->"
            f"{rec.cut_after:.1f}ms  ({rec.reason})")


def main(argv=None):
    argparse.ArgumentParser().parse_args(argv)
    part = OnlinePartitioner({"big": 0.6, "small": 0.4}, epsilon=0.05, seed=1,
                             edge_ms=lambda nb: nb / 6.25e9 * 1e3)

    # -- request arrivals: chains of decode chunks --------------------------
    for rid in range(6):
        prev = None
        for c in range(4):
            name = f"r{rid}.d{c}"
            deps = [(prev, KV)] if prev else []
            part.add_task(Kernel(name, op="decode", costs=dict(COSTS), out_bytes=KV), deps)
            prev = name
    print("after 6 arrivals:", fmt(part.history[-1]))
    print("  loads:", {k: round(v, 1) for k, v in part.loads().items()},
          " cut_ms:", round(part.cut(), 2))

    # -- retirements: the oldest requests finish ----------------------------
    for rid in range(3):
        for c in range(4):
            part.retire_task(f"r{rid}.d{c}")
    print("after 3 retirements:", fmt(part.history[-1]))
    print("  loads:", {k: round(v, 1) for k, v in part.loads().items()})

    # -- elastic event: the big pod halves (targets shift 60/40 -> 33/67) ---
    rec = part.set_targets({"big": 1 / 3, "small": 2 / 3},
                           reason="big pod scale-in")
    print("after scale-in:", fmt(rec))
    print("  loads:", {k: round(v, 1) for k, v in part.loads().items()},
          " full repartitions:", part.n_full,
          " incremental refines:", part.n_incremental)

    # -- full policy-vs-policy stream through the arena ---------------------
    print("\nSchedulerArena on a churning request stream (drop at step 3):")
    rows, _ = run_arena(12, 6, steps=5, drop_step=3, seed=0)
    print(format_table(rows))


if __name__ == "__main__":
    main()
