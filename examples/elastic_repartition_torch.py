"""Fault-tolerance scenario on the PyTorch port (the twin of
``examples/elastic_repartition.py``): a heterogeneous 3-group cluster loses
a group mid-run; the monitor detects it and the graph is RE-partitioned
with the surviving groups' measured throughputs (the paper's scheduler made
elastic — its §IV.D offline restriction lifted).  The scheduler core is
host code: nothing here touches a device.

Run:  PYTHONPATH=src python examples/elastic_repartition_torch.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import time

from repro_torch.core.cost import paper_calibrated_model
from repro_torch.core.graph import generate_dag
from repro_torch.ft.elastic import Heartbeat, HeartbeatMonitor, replan


def main(argv=None):
    argparse.ArgumentParser().parse_args(argv)
    model = paper_calibrated_model()
    g = model.weight_graph(generate_dag(60, op="matmul", seed=11),
                           {"matmul": 512})
    for k in g.nodes.values():   # three device groups, heterogeneous speeds
        base = k.costs.get("gpu", 0.0)
        k.costs = {"podA": base, "podB": base * 2.0, "podC": base * 4.0}

    mon = HeartbeatMonitor(["podA", "podB", "podC"], timeout_s=5.0)
    now = time.time()
    for grp, ms in (("podA", 10.0), ("podB", 20.0), ("podC", 40.0)):
        mon.report(Heartbeat(grp, step=1, step_time_ms=ms, t_wall=now))

    plan0 = replan(g, mon.step_ms, dead=[], edge_ms=model.transfer_ms)
    print("initial targets:", {k: round(v, 3) for k, v in plan0.targets.items()})
    print("initial loads_ms:", {k: round(v, 1)
                                for k, v in plan0.stats["loads_ms"].items()})

    # podB dies (no heartbeat for > timeout)
    for grp, ms in (("podA", 10.0), ("podC", 40.0)):
        mon.report(Heartbeat(grp, step=9, step_time_ms=ms, t_wall=now + 30))
    dead = mon.failed(now=now + 30)
    print("detected failures:", dead)

    plan1 = replan(g, mon.step_ms, dead=dead, edge_ms=model.transfer_ms)
    print("replanned targets:", {k: round(v, 3) for k, v in plan1.targets.items()})
    print("replanned loads_ms:", {k: round(v, 1)
                                  for k, v in plan1.stats["loads_ms"].items()})
    if "podB" in set(plan1.assignment.values()):
        raise AssertionError("the replanned assignment still uses the dead podB")
    print("podB excluded; cut_edges:", plan1.stats["cut_edges"])


if __name__ == "__main__":
    main()
